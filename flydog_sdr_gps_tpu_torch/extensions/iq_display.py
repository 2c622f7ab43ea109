"""IQ_display extension — post-AGC IQ constellation samples.

Reference: `extensions/IQ_display/IQ_display.cpp` — taps post-AGC IQ,
optionally phase-rotated, and streams decimated point pairs.
"""

from __future__ import annotations

import numpy as np

from . import Extension, ext_register
from .taps import host_iq


@ext_register
class IQDisplayExt(Extension):
    name = "IQ_display"

    def start(self, **params):
        self.points = int(params.get("points", 64))

    def process_block(self, taps) -> list:
        ch = self.rx_chan
        re, im = host_iq(taps.iq_post_agc, ch)
        step = max(1, len(re) // self.points)
        pts = np.stack([re[::step], im[::step]], axis=1).astype("<f4")
        return [("iq", pts.tobytes())]
