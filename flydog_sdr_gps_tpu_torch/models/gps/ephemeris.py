"""LNAV navigation message: parity, subframe decode, Kepler orbits.

Reference: `gps/ephemeris.cpp:1-370` — subframes 1-3 carry clock and
orbital parameters (IS-GPS-200 20.3.3); `GetXYZ` solves Kepler for ECEF
satellite position; `ParityCheck` implements the 32->30-bit Hamming
parity (`gps/channel.cpp:731`).

Host-side numpy: runs at 50 bps per satellite — control-plane work,
exactly as the reference runs it on the ARM.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# WGS-84 / IS-GPS-200 constants
MU = 3.986005e14            # earth GM, m^3/s^2
OMEGA_E = 7.2921151467e-5   # earth rotation, rad/s
F_REL = -4.442807633e-10    # relativistic clock constant
PI = 3.1415926535898        # GPS ICD pi

TLM_PREAMBLE = 0b10001011


def parity_check(word: int, d29: int, d30: int) -> tuple[bool, int]:
    """IS-GPS-200 20.3.5.2 parity: 24 data bits + 6 parity bits.

    ``word`` is the 30-bit word as transmitted; d29/d30 are the last
    two parity bits of the previous word.  Returns (ok, data24) with
    data bits complemented per D30 (`gps/channel.cpp:731` semantics).
    """
    d = [(word >> (29 - i)) & 1 for i in range(30)]  # d[0]=bit1(MSB)
    if d30:
        d[:24] = [b ^ 1 for b in d[:24]]
    # parity equations (bit index lists are 1-based data bit numbers)
    eqs = [
        (d29, [1, 2, 3, 5, 6, 10, 11, 12, 13, 14, 17, 18, 20, 23]),
        (d30, [2, 3, 4, 6, 7, 11, 12, 13, 14, 15, 18, 19, 21, 24]),
        (d29, [1, 3, 4, 5, 7, 8, 12, 13, 14, 15, 16, 19, 20, 22]),
        (d30, [2, 4, 5, 6, 8, 9, 13, 14, 15, 16, 17, 20, 21, 23]),
        (d30, [1, 3, 5, 6, 7, 9, 10, 14, 15, 16, 17, 18, 21, 22, 24]),
        (d29, [3, 5, 6, 8, 9, 10, 11, 13, 15, 19, 22, 23, 24]),
    ]
    ok = True
    for i, (dprev, bits) in enumerate(eqs):
        p = dprev
        for b in bits:
            p ^= d[b - 1]
        if p != d[24 + i]:
            ok = False
    data24 = 0
    for i in range(24):
        data24 = (data24 << 1) | d[i]
    return ok, data24


def parity_encode(data24: int, d29: int, d30: int) -> int:
    """Build the transmitted 30-bit word from 24 data bits + previous
    parity (the inverse of :func:`parity_check`)."""
    d = [(data24 >> (23 - i)) & 1 for i in range(24)]
    tx = [b ^ d30 for b in d]      # data bits complemented by prior D30
    eqs = [
        (d29, [1, 2, 3, 5, 6, 10, 11, 12, 13, 14, 17, 18, 20, 23]),
        (d30, [2, 3, 4, 6, 7, 11, 12, 13, 14, 15, 18, 19, 21, 24]),
        (d29, [1, 3, 4, 5, 7, 8, 12, 13, 14, 15, 16, 19, 20, 22]),
        (d30, [2, 4, 5, 6, 8, 9, 13, 14, 15, 16, 17, 20, 21, 23]),
        (d30, [1, 3, 5, 6, 7, 9, 10, 14, 15, 16, 17, 18, 21, 22, 24]),
        (d29, [3, 5, 6, 8, 9, 10, 11, 13, 15, 19, 22, 23, 24]),
    ]
    for dprev, bits in eqs:
        p = dprev
        for b in bits:
            p ^= d[b - 1]
        tx.append(p)
    word = 0
    for b in tx:
        word = (word << 1) | b
    return word


@dataclasses.dataclass
class Ephemeris:
    """Subframe 1-3 parameters (scaled, SI units)."""
    prn: int = 0
    # subframe 1
    week: int = 0
    toc: float = 0.0
    af0: float = 0.0
    af1: float = 0.0
    af2: float = 0.0
    # subframe 2
    iode: int = -1
    crs: float = 0.0
    delta_n: float = 0.0
    m0: float = 0.0
    cuc: float = 0.0
    e: float = 0.0
    cus: float = 0.0
    sqrt_a: float = 0.0
    toe: float = 0.0
    # subframe 3
    cic: float = 0.0
    omega0: float = 0.0
    cis: float = 0.0
    i0: float = 0.0
    crc: float = 0.0
    omega: float = 0.0
    omega_dot: float = 0.0
    idot: float = 0.0
    # HOW of the most recently decoded subframe: GPS time (s of week)
    # of the start of the NEXT subframe
    tow_next: float = -1.0
    have: set = dataclasses.field(default_factory=set)

    def complete(self) -> bool:
        return {1, 2, 3} <= self.have

    # -- satellite position (reference `GetXYZ`,
    #    gps/ephemeris.cpp:148-188) ------------------------------------
    def sat_pos(self, t: float) -> tuple[np.ndarray, float]:
        """ECEF position (m) and clock correction (s) at GPS time t."""
        a = self.sqrt_a ** 2
        n = math.sqrt(MU / a ** 3) + self.delta_n
        tk = _wrap_week(t - self.toe)
        mk = self.m0 + n * tk
        ek = mk
        for _ in range(12):
            ek = mk + self.e * math.sin(ek)
        vk = math.atan2(math.sqrt(1 - self.e ** 2) * math.sin(ek),
                        math.cos(ek) - self.e)
        phik = vk + self.omega
        duk = self.cus * math.sin(2 * phik) + self.cuc * math.cos(2 * phik)
        drk = self.crs * math.sin(2 * phik) + self.crc * math.cos(2 * phik)
        dik = self.cis * math.sin(2 * phik) + self.cic * math.cos(2 * phik)
        uk = phik + duk
        rk = a * (1 - self.e * math.cos(ek)) + drk
        ik = self.i0 + dik + self.idot * tk
        xk = rk * math.cos(uk)
        yk = rk * math.sin(uk)
        omk = (self.omega0 + (self.omega_dot - OMEGA_E) * tk
               - OMEGA_E * self.toe)
        x = xk * math.cos(omk) - yk * math.cos(ik) * math.sin(omk)
        y = xk * math.sin(omk) + yk * math.cos(ik) * math.cos(omk)
        z = yk * math.sin(ik)
        # SV clock correction incl. relativistic term
        dt = _wrap_week(t - self.toc)
        clk = (self.af0 + self.af1 * dt + self.af2 * dt * dt
               + F_REL * self.e * self.sqrt_a * math.sin(ek))
        return np.array([x, y, z]), clk


def _wrap_week(t: float) -> float:
    if t > 302400:
        return t - 604800
    if t < -302400:
        return t + 604800
    return t


def _sgn(v: int, bits: int) -> int:
    """Two's-complement sign extension."""
    if v >= 1 << (bits - 1):
        v -= 1 << bits
    return v


def decode_subframe(words: list[int], eph: Ephemeris) -> int | None:
    """Decode one subframe from ten 24-bit data words into ``eph``.

    Returns the subframe id, or None if the HOW is inconsistent.
    Field layout per IS-GPS-200 fig. 20-1 (`gps/ephemeris.cpp:228-330`
    implements the same extraction).
    """
    def bits(w, lo, n):
        """Extract n bits from word w (1-based word index), starting at
        1-based bit position lo within the 24 data bits."""
        return (words[w - 1] >> (24 - lo - n + 1)) & ((1 << n) - 1)

    sub = bits(2, 20, 3)
    if not 1 <= sub <= 5:
        return None
    # HOW TOW count: time of start of the NEXT subframe in 6 s units
    # (IS-GPS-200 20.3.3.2; `gps/ephemeris.cpp` Subframe uses it the
    # same way to timestamp transmissions)
    eph.tow_next = bits(2, 1, 17) * 6.0
    if sub == 1:
        eph.week = bits(3, 1, 10)
        eph.af2 = _sgn(bits(9, 1, 8), 8) * 2.0 ** -55
        eph.af1 = _sgn(bits(9, 9, 16), 16) * 2.0 ** -43
        eph.af0 = _sgn((bits(10, 1, 22)), 22) * 2.0 ** -31
        eph.toc = bits(8, 9, 16) * 16.0
        eph.have.add(1)
    elif sub == 2:
        eph.iode = bits(3, 1, 8)
        eph.crs = _sgn(bits(3, 9, 16), 16) * 2.0 ** -5
        eph.delta_n = _sgn(bits(4, 1, 16), 16) * 2.0 ** -43 * PI
        eph.m0 = _sgn((bits(4, 17, 8) << 24) | bits(5, 1, 24), 32) \
            * 2.0 ** -31 * PI
        eph.cuc = _sgn(bits(6, 1, 16), 16) * 2.0 ** -29
        eph.e = ((bits(6, 17, 8) << 24) | bits(7, 1, 24)) * 2.0 ** -33
        eph.cus = _sgn(bits(8, 1, 16), 16) * 2.0 ** -29
        eph.sqrt_a = ((bits(8, 17, 8) << 24) | bits(9, 1, 24)) \
            * 2.0 ** -19
        eph.toe = bits(10, 1, 16) * 16.0
        eph.have.add(2)
    elif sub == 3:
        eph.cic = _sgn(bits(3, 1, 16), 16) * 2.0 ** -29
        eph.omega0 = _sgn((bits(3, 17, 8) << 24) | bits(4, 1, 24), 32) \
            * 2.0 ** -31 * PI
        eph.cis = _sgn(bits(5, 1, 16), 16) * 2.0 ** -29
        eph.i0 = _sgn((bits(5, 17, 8) << 24) | bits(6, 1, 24), 32) \
            * 2.0 ** -31 * PI
        eph.crc = _sgn(bits(7, 1, 16), 16) * 2.0 ** -5
        eph.omega = _sgn((bits(7, 17, 8) << 24) | bits(8, 1, 24), 32) \
            * 2.0 ** -31 * PI
        eph.omega_dot = _sgn(bits(9, 1, 24), 24) * 2.0 ** -43 * PI
        eph.idot = _sgn(bits(10, 9, 14), 14) * 2.0 ** -43 * PI
        eph.have.add(3)
    return sub


class SubframeAssembler:
    """Live LNAV frame sync + decode from a tracked bit stream.

    Reference: `gps/channel.cpp:657-730` (`Subframe`/`ParityCheck`) —
    find the TLM preamble (0x8B) at 300-bit spacing, verify the
    Hamming parity of all ten words with D29*/D30* chaining, and hand
    the data words to the subframe decoder.  Handles the BPSK sign
    ambiguity by trying both polarities.
    """

    def __init__(self, prn: int = 0):
        self.eph = Ephemeris(prn=prn)
        self.bits: list[int] = []
        self.subframes = 0
        # global index (bits ever fed) of self.bits[0] — lets callers
        # map a decoded subframe back to its transmit-time anchor
        self.base = 0
        # (subframe_id, global_start_bit, tow_next) per decode; the
        # manager drains this to timestamp transmissions
        self.events: list[tuple[int, int, float]] = []

    def feed(self, bits) -> list[int]:
        """Feed hard bits (+-1 or 0/1); returns subframe ids decoded."""
        for b in bits:
            self.bits.append(1 if b > 0 else 0)
        decoded = []
        while len(self.bits) >= 302:
            hit = False
            # need the 2 parity bits D29*/D30* preceding the subframe;
            # scan for a preamble at offset >= 2
            limit = len(self.bits) - 300
            for off in range(2, min(limit + 1, 3000)):
                for inv in (0, 1):
                    words = self._try(off, inv)
                    if words is not None:
                        sub = decode_subframe(words, self.eph)
                        if sub is not None:
                            self.subframes += 1
                            decoded.append(sub)
                            self.events.append(
                                (sub, self.base + off, self.eph.tow_next))
                        # keep the final 2 bits: they are the D29*/D30*
                        # the NEXT subframe's parity chain needs
                        del self.bits[:off + 298]
                        self.base += off + 298
                        hit = True
                        break
                if hit:
                    break
            if not hit:
                # keep a window; drop old bits to bound memory
                if len(self.bits) > 6000:
                    del self.bits[:3000]
                    self.base += 3000
                break
        return decoded

    def _try(self, off: int, inv: int) -> list[int] | None:
        bits = [b ^ inv for b in self.bits[off - 2:off + 300]]
        # preamble check on the raw (possibly complemented-by-D30) bits
        d29, d30 = bits[0], bits[1]
        words = []
        pos = 2
        for w in range(10):
            word = 0
            for i in range(30):
                word = (word << 1) | bits[pos + i]
            ok, data24 = parity_check(word, d29, d30)
            if not ok:
                return None
            words.append(data24)
            d29, d30 = (word >> 1) & 1, word & 1
            pos += 30
        if (words[0] >> 16) != TLM_PREAMBLE:
            return None
        return words


def encode_subframe(sub: int, eph: Ephemeris,
                    tow_next: float | None = None) -> list[int]:
    """Inverse of :func:`decode_subframe` (test fixture generator).

    ``tow_next``: HOW time-of-week (s) of the start of the NEXT
    subframe; defaults to ``eph.tow_next`` when set."""
    words = [0] * 10

    def put(w, lo, n, val):
        val &= (1 << n) - 1
        words[w - 1] |= val << (24 - lo - n + 1)

    put(1, 1, 8, TLM_PREAMBLE)
    put(2, 20, 3, sub)
    if tow_next is None and eph.tow_next >= 0:
        tow_next = eph.tow_next
    if tow_next is not None:
        put(2, 1, 17, int(round(tow_next / 6.0)))
    if sub == 1:
        put(3, 1, 10, eph.week)
        put(9, 1, 8, int(round(eph.af2 / 2.0 ** -55)))
        put(9, 9, 16, int(round(eph.af1 / 2.0 ** -43)))
        put(10, 1, 22, int(round(eph.af0 / 2.0 ** -31)))
        put(8, 9, 16, int(round(eph.toc / 16.0)))
    elif sub == 2:
        put(3, 1, 8, eph.iode)
        put(3, 9, 16, int(round(eph.crs / 2.0 ** -5)))
        put(4, 1, 16, int(round(eph.delta_n / PI / 2.0 ** -43)))
        m0 = int(round(eph.m0 / PI / 2.0 ** -31))
        put(4, 17, 8, m0 >> 24)
        put(5, 1, 24, m0)
        put(6, 1, 16, int(round(eph.cuc / 2.0 ** -29)))
        e = int(round(eph.e / 2.0 ** -33))
        put(6, 17, 8, e >> 24)
        put(7, 1, 24, e)
        put(8, 1, 16, int(round(eph.cus / 2.0 ** -29)))
        sa = int(round(eph.sqrt_a / 2.0 ** -19))
        put(8, 17, 8, sa >> 24)
        put(9, 1, 24, sa)
        put(10, 1, 16, int(round(eph.toe / 16.0)))
    elif sub == 3:
        put(3, 1, 16, int(round(eph.cic / 2.0 ** -29)))
        om0 = int(round(eph.omega0 / PI / 2.0 ** -31))
        put(3, 17, 8, om0 >> 24)
        put(4, 1, 24, om0)
        put(5, 1, 16, int(round(eph.cis / 2.0 ** -29)))
        i0 = int(round(eph.i0 / PI / 2.0 ** -31))
        put(5, 17, 8, i0 >> 24)
        put(6, 1, 24, i0)
        put(7, 1, 16, int(round(eph.crc / 2.0 ** -5)))
        om = int(round(eph.omega / PI / 2.0 ** -31))
        put(7, 17, 8, om >> 24)
        put(8, 1, 24, om)
        put(9, 1, 24, int(round(eph.omega_dot / PI / 2.0 ** -43)))
        put(10, 9, 14, int(round(eph.idot / PI / 2.0 ** -43)))
    return words
