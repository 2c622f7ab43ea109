"""WSPR message decode: deinterleave, sequential decode, unpack.

Completes the WSPR chain (front end in `wspr.py`).  Reference:
`extensions/wspr/` — Fano (`fano.cpp`) / Jelinek stack (`jelinek.cpp`)
sequential decoders for the K=32 r=1/2 Layland-Lushbaugh code
(POLY1/2 = 0xf2d05351 / 0xe4613c47, `fano.cpp:52-53`, the `LL` pair
WSPR actually transmits — validated against the off-air capture in
`tests/data/wspr_offair_375.npz`), bit-reversal deinterleaver
(`wspr_util.cpp:208-223`), and the 50-bit type-1 message unpack
(`wspr_util.cpp:65-148`): 28-bit callsign, 15-bit Maidenhead grid,
7-bit power.

This implementation uses a stack (Jelinek-style) decoder — simpler
control flow than Fano with the same result on the host at these
rates.  All of it is public WSPR protocol structure.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

POLY1 = 0xF2D05351
POLY2 = 0xE4613C47
NBITS = 81            # 50 message bits + K-1 = 31 zero tail
NSYM = 162
CHARSET = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ "


def _parity32(v: int) -> int:
    v ^= v >> 16
    v ^= v >> 8
    v ^= v >> 4
    v ^= v >> 2
    v ^= v >> 1
    return v & 1


def _bitrev8(i: int) -> int:
    return int("{:08b}".format(i)[::-1], 2)


def interleave_map() -> np.ndarray:
    """sym[j] = coded[p]: position j for each sequential coded bit p."""
    out = np.zeros(NSYM, np.int64)
    p = 0
    i = 0
    while p < NSYM:
        j = _bitrev8(i)
        if j < NSYM:
            out[p] = j
            p += 1
        i += 1
    return out


_IMAP = interleave_map()


def deinterleave_soft(soft_syms: np.ndarray) -> np.ndarray:
    """Soft symbols (162,) in transmission order -> coded-bit order."""
    return np.asarray(soft_syms)[_IMAP]


def conv_encode(bits81: np.ndarray) -> np.ndarray:
    """81 source bits -> 162 coded bits (before interleaving)."""
    enc = 0
    out = np.zeros(NSYM, np.uint8)
    for i, b in enumerate(bits81):
        enc = ((enc << 1) | int(b)) & 0xFFFFFFFF
        out[2 * i] = _parity32(enc & POLY1)
        out[2 * i + 1] = _parity32(enc & POLY2)
    return out


# ---------------------------------------------------------------------------
# stack (Jelinek) sequential decoder
# ---------------------------------------------------------------------------

def stack_decode(soft_coded: np.ndarray, max_nodes: int = 200_000
                 ) -> np.ndarray | None:
    """Decode 162 soft coded-bit LLRs -> 50 message bits (or None).

    ``soft_coded``: positive = bit 1 likely (deinterleaved order).
    Metric per coded bit: log2(2*sigmoid(+-llr)) — ~+1 for a confident
    match, negative for mismatch, ~0 for erased; correct paths drift
    up, wrong paths drift down (the sequential-decoding invariant).
    """
    llr = np.asarray(soft_coded, np.float64)
    scale = 3.0 / (np.std(llr) + 1e-12)
    llr = np.clip(llr * scale, -8, 8)
    # branch metric lookup per (position, bit)
    m1 = np.log2(2.0 / (1.0 + np.exp(-llr)))      # metric if coded bit 1
    m0 = np.log2(2.0 / (1.0 + np.exp(+llr)))      # metric if coded bit 0

    # node: (-metric, depth, encstate, path_int)
    heap = [(-0.0, 0, 0, 0)]
    expanded = 0
    best_at_depth: dict[int, float] = {}
    while heap and expanded < max_nodes:
        nmetric, depth, enc, path = heapq.heappop(heap)
        metric = -nmetric
        if depth == NBITS:
            bits = [(path >> (NBITS - 1 - i)) & 1 for i in range(NBITS)]
            return np.asarray(bits[:50], np.uint8)
        # prune: if far below the best seen at this depth, drop
        b = best_at_depth.get(depth, -1e9)
        if metric < b - 40.0:
            continue
        if metric > b:
            best_at_depth[depth] = metric
        choices = (0, 1) if depth < 50 else (0,)   # zero tail
        for bit in choices:
            e = ((enc << 1) | bit) & 0xFFFFFFFF
            c0 = _parity32(e & POLY1)
            c1 = _parity32(e & POLY2)
            dm = (m1[2 * depth] if c0 else m0[2 * depth]) + \
                 (m1[2 * depth + 1] if c1 else m0[2 * depth + 1])
            heapq.heappush(
                heap, (-(metric + dm), depth + 1, e,
                       (path << 1) | bit))
        expanded += 1
    return None


# ---------------------------------------------------------------------------
# message pack / unpack (wspr_util.cpp:65-148 semantics)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WsprMessage:
    callsign: str
    grid: str
    dbm: int


def unpack_message(bits50: np.ndarray) -> WsprMessage | None:
    v = 0
    for b in bits50:
        v = (v << 1) | int(b)
    call_28b = v >> 22
    grid_pwr = v & 0x3FFFFF
    grid_15b = grid_pwr >> 7
    pwr_7b = grid_pwr & 0x7F
    call = _unpack_call(call_28b)
    grid = _unpack_grid(grid_15b)
    if call is None or grid is None:
        return None
    return WsprMessage(callsign=call, grid=grid, dbm=pwr_7b - 64)


def _unpack_call(n: int) -> str | None:
    if n >= 37 * 36 * 10 * 27 * 27 * 27:
        return None
    out = [""] * 6
    out[5] = CHARSET[n % 27 + 10]; n //= 27
    out[4] = CHARSET[n % 27 + 10]; n //= 27
    out[3] = CHARSET[n % 27 + 10]; n //= 27
    out[2] = CHARSET[n % 10]; n //= 10
    out[1] = CHARSET[n % 36]; n //= 36
    out[0] = CHARSET[n]
    return "".join(out).strip()


def _unpack_grid(g: int) -> str | None:
    if g >= 32400:
        return None
    dlat = (g % 180) - 90
    dlong = (g // 180) * 2 - 180 + 2
    nlong = int(60.0 * (180.0 - dlong) / 5.0)
    n1 = nlong // 240
    n2 = (nlong - 240 * n1) // 24
    g0, g2 = CHARSET[10 + n1], CHARSET[n2]
    nlat = int(60.0 * (dlat + 90) / 2.5)
    n1 = nlat // 240
    n2 = (nlat - 240 * n1) // 24
    g1, g3 = CHARSET[10 + n1], CHARSET[n2]
    return g0 + g1 + g2 + g3


def _pack_call(call: str) -> int:
    """Inverse of _unpack_call.  Normalizes so char 3 is the digit."""
    call = call.upper().strip()
    # right-shift so the last digit of the prefix lands at index 2
    digit_pos = max(i for i, ch in enumerate(call[:3]) if ch.isdigit())
    call = " " * (2 - digit_pos) + call
    call = (call + "      ")[:6]
    v = CHARSET.index(call[0])
    v = v * 36 + CHARSET.index(call[1])
    v = v * 10 + CHARSET.index(call[2])
    for i in (3, 4, 5):
        ch = call[i]
        v = v * 27 + (26 if ch == " " else ord(ch) - ord("A"))
    return v


def _pack_grid(grid: str) -> int:
    """Inverse of _unpack_grid (exhaustive inverse — 32400 entries)."""
    grid = grid.upper()
    for g in range(32400):
        if _unpack_grid(g) == grid:
            return g
    raise ValueError(f"bad grid {grid}")


def pack_message(msg: WsprMessage) -> np.ndarray:
    v = (_pack_call(msg.callsign) << 22) | \
        (_pack_grid(msg.grid) << 7) | ((msg.dbm + 64) & 0x7F)
    return np.asarray([(v >> (49 - i)) & 1 for i in range(50)], np.uint8)


# ---------------------------------------------------------------------------
# end-to-end helpers
# ---------------------------------------------------------------------------

def encode_to_tones(msg: WsprMessage) -> np.ndarray:
    """Message -> 162 channel tones 0..3 (for simulators/tests)."""
    from .wspr import SYNC
    bits = np.concatenate([pack_message(msg),
                           np.zeros(31, np.uint8)])
    coded = conv_encode(bits)
    sym = np.zeros(NSYM, np.uint8)
    sym[_IMAP] = coded              # interleave
    return (SYNC.astype(np.uint8) + 2 * sym).astype(np.uint8)


def plausible(msg: WsprMessage) -> bool:
    """wsprd's sanity screen: WSPR power is 0..60 dBm with a last
    digit of 0/3/7 (`extensions/wspr/wspr.cpp` ntype checks), the
    grid is [A-R][A-R][0-9][0-9], and the callsign has at least one
    letter and one digit.  Garbage that survives the sequential
    decoder at low sync fails these."""
    if not (0 <= msg.dbm <= 60 and msg.dbm % 10 in (0, 3, 7)):
        return False
    g = msg.grid
    if len(g) != 4 or not ("A" <= g[0] <= "R" and "A" <= g[1] <= "R"
                           and g[2].isdigit() and g[3].isdigit()):
        return False
    cs = msg.callsign.strip()
    if not (2 <= len(cs) <= 6 and any(c.isalpha() for c in cs)
            and any(c.isdigit() for c in cs)):
        return False
    return True


def decode_soft_symbols(soft_syms: np.ndarray) -> WsprMessage | None:
    """162 soft data metrics (transmission order) -> message."""
    soft = deinterleave_soft(soft_syms)
    bits = stack_decode(soft)
    if bits is None:
        return None
    msg = unpack_message(bits)
    if msg is not None and not plausible(msg):
        return None
    return msg
