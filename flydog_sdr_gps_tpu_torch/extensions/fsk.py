"""FSK extension — RTTY-style demodulation and Baudot decode.

Reference: `extensions/FSK/` — configurable shift/baud FSK demod with
ITA2 (Baudot) framing for RTTY, plus raw-bit output for other FSK
users.  The demodulator here is a dual-tone quadrature discriminator
(mark/space energy comparison) with a software UART for the 1-start /
5-data / 1.5-stop ITA2 frame.
"""

from __future__ import annotations

import numpy as np

from . import Extension, ext_register
from .taps import host_column

# ITA2 / Baudot tables (letters, figures shift)
ITA2_LTRS = "\x00E\nA SIU\rDRJNFCKTZLWHYPQOBG\x0eMXV\x0f"
ITA2_FIGS = "\x003\n- \x0787\r\x054',!:(5\")2#6019?&\x0e./;\x0f"
LTRS, FIGS = 0x1F, 0x1B


@ext_register
class FskExt(Extension):
    name = "FSK"

    def start(self, **params):
        self.fs = float(getattr(self.engine.params, "fs_out", 12000.0))
        self.center = float(params.get("center", 1000.0))
        self.shift = float(params.get("shift", 170.0))
        self.baud = float(params.get("baud", 45.45))
        self.sps = self.fs / self.baud
        self._bitbuf: list[int] = []
        self._level = 0
        self._run = 0.0
        self._figs = False
        self._uart_state = "idle"
        self._uart_bits: list[int] = []
        self._uart_t = 0.0
        self._carry = np.zeros(0, np.float64)
        self.text = ""

    def _tone_energy(self, audio: np.ndarray, freq: float,
                     seg: int) -> np.ndarray:
        n = len(audio)
        t = np.arange(n) / self.fs
        lo = np.exp(-2j * np.pi * freq * t)
        prod = audio * lo
        nseg = n // seg
        return np.abs(prod[:nseg * seg].reshape(nseg, seg).sum(axis=1))

    def process_block(self, taps) -> list:
        audio = np.concatenate([
            self._carry,
            host_column(taps.audio, self.rx_chan, np.float64)])
        seg = max(4, int(self.sps / 8))          # 8 looks per bit
        used = (len(audio) // seg) * seg
        self._carry = audio[used:]
        audio = audio[:used]
        mark = self._tone_energy(audio, self.center + self.shift / 2,
                                 seg)
        space = self._tone_energy(audio, self.center - self.shift / 2,
                                  seg)
        out = []
        for m, s in zip(mark, space):
            bit = 1 if m > s else 0
            self._uart(bit, seg / self.fs)
        if self.text:
            out.append(("chars", self.text.encode()))
            self.text = ""
        return out

    def _uart(self, bit: int, dt: float) -> None:
        """Software UART: 1 start (0), 5 data LSB-first, stop (1)."""
        bit_t = 1.0 / self.baud
        if self._uart_state == "idle":
            if bit == 0:                       # start edge
                self._uart_state = "data"
                self._uart_bits = []
                self._uart_t = -0.5 * bit_t    # sample mid-bit
        else:
            self._uart_t += dt
            want = len(self._uart_bits) + 1
            if self._uart_t >= want * bit_t:
                if len(self._uart_bits) < 5:
                    self._uart_bits.append(bit)
                    return
                # stop bit position: frame done
                code = 0
                for i, b in enumerate(self._uart_bits):
                    code |= b << i
                self._emit(code)
                self._uart_state = "idle"

    def _emit(self, code: int) -> None:
        if code == LTRS:
            self._figs = False
        elif code == FIGS:
            self._figs = True
        else:
            ch = (ITA2_FIGS if self._figs else ITA2_LTRS)[code]
            if ch >= " " or ch in "\r\n":
                self.text += ch
