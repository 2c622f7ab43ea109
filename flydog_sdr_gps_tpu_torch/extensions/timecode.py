"""timecode extension — WWVB / DCF77 time-signal decode.

Reference: `extensions/timecode/` — decodes LF standard-time stations
(WWVB 60 kHz, DCF77 77.5 kHz, MSF, JJY): AM-envelope pulse-width
classification per second, then frame parsing to calendar time.

Implemented frames:
- DCF77: 0/1 by 100/200 ms carrier reduction; minute marker = missing
  59th pulse; BCD minute/hour/day/month/year with parity bits.
- WWVB: 0.2/0.5/0.8 s reductions for 0/1/marker; BCD-ish fields.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import Extension, ext_register
from .taps import host_column


@dataclasses.dataclass
class DecodedTime:
    minute: int
    hour: int
    day: int
    month: int
    year: int

    def __str__(self):
        return (f"20{self.year:02d}-{self.month:02d}-{self.day:02d} "
                f"{self.hour:02d}:{self.minute:02d}")


def _bcd(bits, weights):
    return sum(w for b, w in zip(bits, weights) if b)


def decode_dcf77_frame(bits: list[int]) -> DecodedTime | None:
    """59 bit values (bit i = second i) -> time; parity checked."""
    if len(bits) < 59 or bits[20] != 1:
        return None
    minute = _bcd(bits[21:28], (1, 2, 4, 8, 10, 20, 40))
    if sum(bits[21:29]) % 2:
        return None
    hour = _bcd(bits[29:35], (1, 2, 4, 8, 10, 20))
    if sum(bits[29:36]) % 2:
        return None
    day = _bcd(bits[36:42], (1, 2, 4, 8, 10, 20))
    month = _bcd(bits[45:50], (1, 2, 4, 8, 10))
    year = _bcd(bits[50:58], (1, 2, 4, 8, 10, 20, 40, 80))
    if sum(bits[36:59]) % 2:
        return None
    if not (1 <= month <= 12 and 1 <= day <= 31 and hour < 24
            and minute < 60):
        return None
    return DecodedTime(minute, hour, day, month, year)


def encode_dcf77_frame(t: DecodedTime) -> list[int]:
    """Inverse (test fixture).  Returns 59 bit values."""
    bits = [0] * 59
    bits[20] = 1

    def bcd_bits(val, weights):
        out = []
        tens, ones = divmod(val, 10)
        v = {1: ones & 1, 2: (ones >> 1) & 1, 4: (ones >> 2) & 1,
             8: (ones >> 3) & 1, 10: tens & 1, 20: (tens >> 1) & 1,
             40: (tens >> 2) & 1, 80: (tens >> 3) & 1}
        return [v[w] for w in weights]

    bits[21:28] = bcd_bits(t.minute, (1, 2, 4, 8, 10, 20, 40))
    bits[28] = sum(bits[21:28]) % 2
    bits[29:35] = bcd_bits(t.hour, (1, 2, 4, 8, 10, 20))
    bits[35] = sum(bits[29:35]) % 2
    bits[36:42] = bcd_bits(t.day, (1, 2, 4, 8, 10, 20))
    bits[42:45] = [0, 0, 1]    # day of week (unused here; nonzero)
    bits[45:50] = bcd_bits(t.month, (1, 2, 4, 8, 10))
    bits[50:58] = bcd_bits(t.year, (1, 2, 4, 8, 10, 20, 40, 80))
    bits[58] = sum(bits[36:58]) % 2
    return bits


_DAYS_IN = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def decode_wwvb_frame(syms: list[int]) -> DecodedTime | None:
    """60 WWVB symbols (0, 1, 2=marker; symbol i = second i) -> time.

    NIST 60 kHz amplitude time code: frame-reference markers at
    seconds 0, 9, 19, 29, 39, 49, 59; minutes in bits 1-8
    (weights 40 20 10 - 8 4 2 1), hours 12-18 (20 10 - 8 4 2 1),
    day-of-year 22-33 (200 100 - 80 40 20 10 - 8 4 2 1), year
    45-53 (80 40 20 10 [marker] 8 4 2 1), leap-year flag bit 55.
    """
    if len(syms) < 60:
        return None
    if any(syms[i] != 2 for i in (0, 9, 19, 29, 39, 49, 59)):
        return None

    def val(pairs):
        return sum(w for i, w in pairs if syms[i] == 1)
    minute = val(((1, 40), (2, 20), (3, 10), (5, 8), (6, 4), (7, 2),
                  (8, 1)))
    hour = val(((12, 20), (13, 10), (15, 8), (16, 4), (17, 2),
                (18, 1)))
    doy = val(((22, 200), (23, 100), (25, 80), (26, 40), (27, 20),
               (28, 10), (30, 8), (31, 4), (32, 2), (33, 1)))
    year = val(((45, 80), (46, 40), (47, 20), (48, 10), (50, 8),
                (51, 4), (52, 2), (53, 1)))
    leap = syms[55] == 1
    if not (1 <= doy <= 366 and hour < 24 and minute < 60):
        return None
    month, day = 1, doy
    for mi, nd in enumerate(_DAYS_IN):
        nd += 1 if (mi == 1 and leap) else 0
        if day <= nd:
            month = mi + 1
            break
        day -= nd
    else:
        return None
    return DecodedTime(minute, hour, day, month, year)


@ext_register
class TimecodeExt(Extension):
    name = "timecode"

    def start(self, **params):
        self.fs = float(getattr(self.engine.params, "fs_out", 12000.0))
        self.station = params.get("station", "DCF77")
        self._env: list[float] = []
        self._bits: list[int] = []
        self._carry = np.zeros(0, np.float64)
        self.decoded: DecodedTime | None = None

    def process_block(self, taps) -> list:
        audio = np.concatenate([
            self._carry,
            host_column(taps.audio, self.rx_chan, np.float64)])
        seg = int(self.fs / 100)            # 10 ms envelope resolution
        n = (len(audio) // seg) * seg
        self._carry = audio[n:]
        env = np.sqrt((audio[:n] ** 2).reshape(-1, seg).mean(axis=1))
        self._env.extend(env.tolist())
        out = []
        self._scan_seconds()
        if self.decoded is not None:
            out.append(("time", str(self.decoded).encode()))
            self.decoded = None
        return out

    def _scan_seconds(self) -> None:
        """Classify per-second carrier reductions into bits."""
        spb = 100                           # 10ms cells per second
        wwvb = self.station.upper() == "WWVB"
        while len(self._env) >= spb:
            sec = np.asarray(self._env[:spb])
            del self._env[:spb]
            hi = np.median(sec[85:])        # end of second: full power
            if hi <= 1e-9:
                continue
            low_cells = int(np.sum(sec < 0.5 * hi))
            if wwvb:
                # WWVB: power reduced at the START of each second for
                # 0.2 s (bit 0), 0.5 s (bit 1) or 0.8 s (marker)
                if low_cells >= 65:
                    sym = 2
                elif low_cells >= 35:
                    sym = 1
                elif low_cells >= 10:
                    sym = 0
                else:
                    continue
                self._bits.append(sym)
                # frame start: marker at second 59 followed by the
                # second-0 marker (two in a row)
                if (len(self._bits) >= 61 and sym == 2
                        and self._bits[-2] == 2):
                    t = decode_wwvb_frame(self._bits[-61:-1])
                    if t:
                        self.decoded = t
                    self._bits = self._bits[-1:]
                self._bits = self._bits[-130:]
                continue
            if low_cells < 5:
                # NO reduction: DCF77 marks the minute by OMITTING the
                # 59th second's pulse — flush and decode the frame
                if len(self._bits) >= 59:
                    t = decode_dcf77_frame(self._bits[-59:])
                    if t:
                        self.decoded = t
                self._bits = []
            elif low_cells >= 15:
                self._bits.append(1)        # ~200 ms reduction
            else:
                self._bits.append(0)        # ~100 ms reduction
