"""CW_decoder extension — Morse detection and text decode.

Reference: `extensions/CW_decoder/CW_decoder.cpp` (derived from WB7FHC
and GI3VAF code): tone energy detection around the CW pitch, adaptive
mark/space timing, dit/dah classification, Morse table lookup.

Split: the audio tap arrives as float blocks; tone energy at the
pitch frequency is a Goertzel-style quadrature product (vectorized,
negligible); the timing state machine runs host-side (it is pure
control flow at ~50 events/s).
"""

from __future__ import annotations

import numpy as np

from . import Extension, ext_register
from .taps import host_column

MORSE = {
    ".-": "A", "-...": "B", "-.-.": "C", "-..": "D", ".": "E",
    "..-.": "F", "--.": "G", "....": "H", "..": "I", ".---": "J",
    "-.-": "K", ".-..": "L", "--": "M", "-.": "N", "---": "O",
    ".--.": "P", "--.-": "Q", ".-.": "R", "...": "S", "-": "T",
    "..-": "U", "...-": "V", ".--": "W", "-..-": "X", "-.--": "Y",
    "--..": "Z",
    "-----": "0", ".----": "1", "..---": "2", "...--": "3",
    "....-": "4", ".....": "5", "-....": "6", "--...": "7",
    "---..": "8", "----.": "9",
    ".-.-.-": ".", "--..--": ",", "..--..": "?", "-..-.": "/",
    "-...-": "=", ".-.-.": "+", "-....-": "-",
}


@ext_register
class CwDecoderExt(Extension):
    name = "CW_decoder"

    def start(self, **params):
        self.fs = self.engine.params.fs_out
        self.pitch = float(params.get("pitch", 500.0))
        self.wpm = float(params.get("wpm", 20.0))
        self.env = 0.0
        self.thresh = 0.0
        self.key_down = False
        self.run_samples = 0
        self.symbol = ""
        self.text = ""
        # envelope detector block size: ~5 ms resolution
        self.seg = max(16, int(self.fs * 0.005))

    # dit duration in samples for current wpm estimate
    @property
    def dit(self) -> float:
        return self.fs * 1.2 / self.wpm

    def process_block(self, taps) -> list:
        audio = host_column(taps.audio, self.rx_chan, np.float64)
        out = []
        n = len(audio)
        t = np.arange(n) / self.fs
        # quadrature tone detector at the pitch (vectorized Goertzel)
        lo = np.exp(-2j * np.pi * self.pitch * t)
        prod = audio * lo
        nseg = n // self.seg
        seg_e = np.abs(prod[:nseg * self.seg]
                       .reshape(nseg, self.seg).sum(axis=1)) / self.seg
        for e in seg_e:
            # fast envelope (segment already integrates 5 ms); the peak
            # tracker decays slowly so spaces don't collapse the
            # threshold between words
            self.env = 0.5 * self.env + 0.5 * e
            self.thresh = max(0.999 * self.thresh, self.env)
            on = self.env > 0.4 * self.thresh and self.thresh > 1e-4
            self._clock(on, self.seg)
        if self.text:
            out.append(("chars", self.text.encode()))
            self.text = ""
        return out

    def _clock(self, key_down: bool, samples: int) -> None:
        if key_down == self.key_down:
            self.run_samples += samples
            if not key_down:
                # flush a pending character once the gap is clearly
                # inter-character (no need to wait for the next mark)
                if self.symbol and self.run_samples > 2.5 * self.dit:
                    self.text += MORSE.get(self.symbol, "?")
                    self.symbol = ""
                # long space = word gap
                if (self.symbol == "" and
                        self.run_samples > 7 * self.dit * 1.5):
                    if self.text[-1:] not in ("", " "):
                        self.text += " "
            return
        run = self.run_samples
        self.run_samples = samples
        prev_down = self.key_down
        self.key_down = key_down
        if prev_down:                       # mark ended: dit or dah?
            self.symbol += "-" if run > 2 * self.dit else "."
            # crude WPM tracking from dit-length marks
            if run < 2 * self.dit and run > 0.3 * self.dit:
                measured_wpm = self.fs * 1.2 / run
                self.wpm += 0.1 * (measured_wpm - self.wpm)
        else:                               # space ended
            if run > 2 * self.dit and self.symbol:
                self.text += MORSE.get(self.symbol, "?")
                self.symbol = ""
                if run > 5 * self.dit:
                    self.text += " "
