"""ALE_2G extension — MIL-STD-188-141 2G Automatic Link Establishment.

Reference: `extensions/ALE_2G/` (decode_ff_impl.cpp, 1430 LoC,
LinuxALE-derived).  The 2G ALE waveform is 8-FSK: eight tones
750..2500 Hz in 250 Hz steps, 125 baud (8 ms/symbol, 3 bits/symbol).
A 24-bit word = 3-bit preamble (word type) + three 7-bit characters
(ASCII-38 subset).  Channel coding: the word's two 12-bit halves are
each Golay(24,12)-encoded (the second half's parity inverted so no
legal frame is all zeros), a stuff bit appended (49 bits), and the
frame sent with triple redundancy — bit i repeating at i, i+49, i+98
of a 147-bit stream that is read out as 49 consecutive tribit
symbols.  The receiver majority-votes the three copies (2/3 vote) and
Golay-corrects up to 3 bit errors per half.

There is no sync word: word alignment is recovered by sliding a
49-symbol window and accepting positions where both Golay halves
decode cleanly — FEC-as-sync, as in the reference decoder.

Note: the demod front end is a tone filter bank — at scale this
rides the shared channelizer; the per-channel 8-tone Goertzel on
12 kHz audio is host-side numpy like the other narrowband decoders.
"""

from __future__ import annotations

import numpy as np

from . import Extension, ext_register
from .taps import host_column

TONES_HZ = np.arange(750.0, 2500.0 + 1, 250.0)       # ascending tones
BAUD = 125.0
PREAMBLES = ["DATA", "THRU", "TO", "TWAS", "FROM", "TIS", "CMD", "REP"]

# MIL-STD-188-141 A.5.1.2 tone->tribit GRAY mapping: ascending tones
# 750..2500 Hz carry values 0,1,3,2,6,7,5,4 ("1750 Hz = 3'b110 = 6";
# the reference decoder's `decode_ff.h:116` g_symbol_lookup rows).
# The repo's pre-oracle code mapped tone k -> k directly — one of the
# three mirror bugs the off-air captures exposed.
TONE_TRIBIT = np.array([0, 1, 3, 2, 6, 7, 5, 4])
_TONE_OF_TRIBIT = np.argsort(TONE_TRIBIT)            # value -> tone idx

# ---------------------------------------------------------------------------
# Golay (24,12) — the MIL-STD-188-141 arrangement: the (23,12) cyclic
# Golay with generator g(x) = x^11+x^9+x^7+x^6+x^5+x+1 (0xAE3), parity
# in bits 11..1, plus an overall even-parity bit in bit 0 (verified
# entry-for-entry against the reference decoder's 4096-word
# `decode_ff.h` encode_table by tests/test_ale_offair.py).  Decode =
# min-Hamming-distance against all 4096 codewords (corrects <=3
# errors).
# ---------------------------------------------------------------------------
_GOLAY_G = 0xAE3


def _cyc11(data: int) -> int:
    """(data(x) * x^11) mod g(x) — 11 parity bits."""
    r = data << 11
    for i in range(22, 10, -1):
        if r & (1 << i):
            r ^= _GOLAY_G << (i - 11)
    return r & 0x7FF


def _build_codebook() -> np.ndarray:
    out = np.zeros(4096, np.uint32)
    for data in range(4096):
        p11 = _cyc11(data)
        w = (data << 12) | (p11 << 1)
        w |= bin(w).count("1") & 1       # even overall parity
        out[data] = w
    return out


_CODEBOOK = _build_codebook()
_POPCNT = np.array([bin(i).count("1") for i in range(1 << 16)],
                   np.uint8)


def golay_encode(data12: int) -> int:
    """12-bit data -> 24-bit codeword (data in the 12 MSBs)."""
    return int(_CODEBOOK[data12 & 0xFFF])


def golay_decode(word24: int) -> tuple[int, int]:
    """24-bit received word -> (12-bit data, nerrors).  nerrors is the
    Hamming distance to the nearest codeword (<=3 is correctable)."""
    x = _CODEBOOK ^ np.uint32(word24)
    d = _POPCNT[x & 0xFFFF] + _POPCNT[x >> 16]
    best = int(np.argmin(d))
    return best, int(d[best])


# ---------------------------------------------------------------------------
# Word <-> frame <-> symbols
# ---------------------------------------------------------------------------

def word_pack(preamble: str, chars: str) -> int:
    """24-bit ALE word: 3-bit preamble + 3x 7-bit chars."""
    p = PREAMBLES.index(preamble)
    w = p
    for c in (chars + "@@@")[:3]:
        w = (w << 7) | (ord(c) & 0x7F)
    return w


def word_unpack(word24: int) -> tuple[str, str]:
    p = PREAMBLES[(word24 >> 21) & 7]
    chars = "".join(chr((word24 >> s) & 0x7F) for s in (14, 7, 0))
    return p, chars


def frame_bits(word24: int) -> np.ndarray:
    """24-bit word -> 49-bit FEC frame: the two Golay codewords are
    BIT-INTERLEAVED a0,b0,a1,b1,... (the reference de-interleaves
    even/odd voted bits, `decode_ff_impl.cpp:240-246`), second half's
    parity inverted, + stuff bit 0."""
    a = golay_encode((word24 >> 12) & 0xFFF)
    b = golay_encode(word24 & 0xFFF) ^ 0xFFF     # invert parity half
    bits = np.zeros(49, np.uint8)
    for i in range(24):
        bits[2 * i] = (a >> (23 - i)) & 1
        bits[2 * i + 1] = (b >> (23 - i)) & 1
    return bits


def frame_decode(bits49: np.ndarray) -> tuple[int, int] | None:
    """49 majority-voted bits -> (word24, max_half_errors) or None
    (the reference gates initial word sync on
    max(error_a, error_b) <= SYNC_ERROR_THRESHOLD)."""
    a = b = 0
    for i in range(24):
        a = (a << 1) | int(bits49[2 * i])
        b = (b << 1) | int(bits49[2 * i + 1])
    b ^= 0xFFF
    da, ea = golay_decode(a)
    db, eb = golay_decode(b)
    if ea > 3 or eb > 3:
        return None
    return (da << 12) | db, max(ea, eb)


def word_symbols(word24: int) -> np.ndarray:
    """49 TONE INDICES of the triple-redundant 147-bit stream (tribit
    values Gray-mapped to tones per A.5.1.2)."""
    f = frame_bits(word24)
    stream = np.concatenate([f, f, f])           # bit i at i, i+49, i+98
    tri = stream[:147].reshape(49, 3)
    vals = (tri[:, 0] * 4 + tri[:, 1] * 2 + tri[:, 2]).astype(np.int64)
    return _TONE_OF_TRIBIT[vals]


def modulate(words: list[tuple[str, str]], fs: float = 12000.0,
             amp: float = 0.5, lead: float = 0.05) -> np.ndarray:
    """ALE transmission: each word = 49 symbols @125 baud, 8-FSK,
    phase-continuous."""
    sps = fs / BAUD
    out = [np.zeros(int(lead * fs), np.float64)]
    phase = 0.0
    sent = 0.0      # fractional-sample bookkeeping keeps 125 baud exact
    nsamp = 0
    for pre, chars in words:
        for s in word_symbols(word_pack(pre, chars)):
            sent += sps
            n = int(round(sent)) - nsamp
            nsamp += n
            f = TONES_HZ[s]
            t = np.arange(n)
            out.append(amp * np.sin(phase + 2 * np.pi * f * t / fs))
            phase = (phase + 2 * np.pi * f * n / fs) % (2 * np.pi)
    out.append(np.zeros(int(lead * fs), np.float64))
    return np.concatenate(out).astype(np.float32)


# ---------------------------------------------------------------------------
# Streaming decoder
# ---------------------------------------------------------------------------

class AleDecoder:
    """8-FSK symbol demod + FEC-sync word decoder.

    Symbol timing: tone powers are measured every half symbol (4 ms
    window); a symbol decision takes the stronger of the two half
    windows, and word sync is attempted at every half-symbol phase —
    the Golay check rejects wrong alignments.
    """

    def __init__(self, fs: float = 12000.0):
        self.fs = fs
        self.half = int(round(fs / BAUD / 2))     # samples per half-sym
        n = self.half
        t = np.arange(n)
        # Goertzel-equivalent: complex exponential bank, (tones, n)
        self.bank_re = np.cos(2 * np.pi * TONES_HZ[:, None] * t / fs)
        self.bank_im = np.sin(2 * np.pi * TONES_HZ[:, None] * t / fs)
        self.win = np.hanning(n)
        self._carry = np.zeros(0, np.float32)
        # per half-symbol best tone + power, alternating phases
        self._pows: list[np.ndarray] = []
        self.words: list[tuple[str, str, int]] = []
        self._emitted: set[int] = set()
        self._nhalf = 0

    def feed(self, audio: np.ndarray) -> list[tuple[str, str, int]]:
        x = np.concatenate([self._carry, audio.astype(np.float32)])
        nh = len(x) // self.half
        self._carry = x[nh * self.half:]
        out = []
        for k in range(nh):
            seg = x[k * self.half:(k + 1) * self.half] * self.win
            p = ((self.bank_re @ seg) ** 2 + (self.bank_im @ seg) ** 2)
            self._pows.append(p)
            self._nhalf += 1
            out.extend(self._try_sync())
        if len(self._pows) > 4 * 49 * 2:
            drop = len(self._pows) - 4 * 49 * 2
            del self._pows[:drop]
        # prune dedupe keys older than the retained window
        horizon = self._nhalf - 8 * 49
        self._emitted = {e for e in self._emitted if e >= horizon}
        return out

    def _try_sync(self) -> list[tuple[str, str, int]]:
        """Attempt a word decode ending at the newest half-symbol, for
        both half-symbol phases."""
        need = 49 * 2                             # half-syms per word
        if len(self._pows) < need:
            return []
        found = []
        for phase in (0, 1):
            lo = len(self._pows) - need - phase
            if lo < 0:
                continue
            win = self._pows[lo:lo + need]
            # symbol power = sum of its two half windows
            ps = np.stack([a + b for a, b in zip(win[0::2], win[1::2])])
            tones = np.argmax(ps, axis=1)
            # SNR gate: best tone must dominate
            tot = ps.sum(axis=1)
            dom = ps[np.arange(49), tones] / np.maximum(tot, 1e-12)
            if dom.mean() < 0.30:
                continue
            syms = TONE_TRIBIT[tones]             # Gray de-map
            stream = np.zeros(147, np.uint8)
            stream[0::3] = (syms >> 2) & 1
            stream[1::3] = (syms >> 1) & 1
            stream[2::3] = syms & 1
            votes = (stream[:49].astype(int) + stream[49:98]
                     + stream[98:147])
            # 2/3 majority vote; gate on disagreeing triples like the
            # reference (BAD_VOTE_THRESHOLD 25 of 48,
            # `decode_ff_impl.h:62`)
            bad = int(np.sum((votes == 1) | (votes == 2)))
            if bad > 25:
                continue
            bits = (votes >= 2).astype(np.uint8)
            r = frame_decode(bits)
            if r is None:
                continue
            word24, nerr = r
            # initial-sync grade: SYNC_ERROR_THRESHOLD=1 per half
            if nerr > 1:
                continue
            pre, chars = word_unpack(word24)
            if any(not (c.isalnum() or c in "@?") for c in chars):
                continue
            key = self._nhalf - phase
            # dedupe: the same word region matches at adjacent offsets
            if any(abs(key - e) < 49 for e in self._emitted):
                continue
            self._emitted.add(key)
            found.append((pre, chars, nerr))
        return found


@ext_register
class Ale2gExt(Extension):
    name = "ALE_2G"

    def start(self, **params):
        fs = float(getattr(self.engine.params, "fs_out", 12000.0))
        self.dec = AleDecoder(fs)

    def process_block(self, taps) -> list:
        audio = host_column(taps.audio, self.rx_chan, np.float32)
        out = []
        for pre, chars, nerr in self.dec.feed(audio):
            out.append(("ale_word",
                        f"[{pre}] {chars} (err {nerr})".encode()))
        return out
