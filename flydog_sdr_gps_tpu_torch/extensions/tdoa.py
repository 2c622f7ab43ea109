"""TDoA extension — GPS-timestamped IQ streaming.

Reference: `extensions/TDoA/tdoa.cpp` (61 LoC server side): time
difference of arrival direction finding is client-driven; the server's
only job is delivering IQ with accurate GPS timestamps (the SND IQ
packet's gpssec/gpsnsec fields) so off-box solvers can correlate
captures from multiple receivers.

Here: the extension snapshots (48-bit tick, GPS-corrected seconds) per
block alongside decimated IQ; the KiwiServer IQ path already embeds
the same timestamps in SND IQ packets.
"""

from __future__ import annotations

import struct

import numpy as np

from . import Extension, ext_register
from .taps import host_iq


@ext_register
class TdoaExt(Extension):
    name = "TDoA"

    def start(self, **params):
        self.decim = int(params.get("decim", 4))

    def process_block(self, taps) -> list:
        ch = self.rx_chan
        eng = self.engine
        # the block's own stamp where the taps carry one (the server's,
        # whose fan-out may run beside the engine's next step)
        stamp = getattr(taps, "stamp", None)
        if stamp is None:
            stamp = (eng.gps_timestamp()
                     if hasattr(eng, "gps_timestamp") else (0, 0.0))
        ticks, secs = stamp
        re, im = (c[::self.decim] for c in host_iq(taps.iq_post_agc, ch))
        iq = np.empty(len(re) * 2, np.float32)
        iq[0::2] = re
        iq[1::2] = im
        hdr = struct.pack("<QdI", ticks & 0xFFFFFFFFFFFF, secs, len(re))
        return [("tdoa_iq", hdr + iq.astype("<f4").tobytes())]
