"""S_meter extension — streams calibrated level readings.

Reference: `extensions/S_meter/S_meter.cpp` — subscribes to the
S-meter tap and sends periodic dBm values to its client graph.
"""

from __future__ import annotations

import struct

import numpy as np

from . import Extension, ext_register


@ext_register
class SMeterExt(Extension):
    name = "S_meter"

    def start(self, **params):
        self.decimate = int(params.get("decimate", 1))
        self._n = 0

    def process_block(self, taps) -> list:
        self._n += 1
        if self._n % max(self.decimate, 1):
            return []
        dbm = float(np.asarray(taps.smeter_dbm[self.rx_chan]))
        return [("smeter", struct.pack("<f", dbm))]
