"""DRM multilevel channel coding (ETSI ES 201 980 section 7) — the
REAL FEC chain: energy dispersal, punctured rate-1/4 mother code,
partitioning into levels, bit interleaving and QAM mapping.

Replaces the round-3 stand-in (shared K=7 r=1/2 code, ad-hoc
puncturing) that `extensions/drm.py:22-26` admitted to.  The chain
matches the reference's Dream implementation value-for-value:

- mother code: K=7, rate 1/4, generators 133/171/145/133 octal
  (`dream/MLC/ConvEncoder.cpp:173-211` — Dream stores them
  bit-reversed, 0155/0117/0123/0155, because it shifts the other way;
  same code).
- puncturing patterns ``PUNCT_PATTERNS`` and tailbit patterns
  ``TAIL_PATTERNS``: ETSI table 58/59 per
  `dream/tables/TableMLC.h:75-443`; the per-bit pattern table is
  generated exactly like `dream/MLC/ChannelCode.cpp:33-173`
  (GenPuncPatTable), including the FAC no-special-tailbits rule.
- block interleaver permutation per ETSI 7.3.3/7.6
  (`dream/interleaver/BlockInterleaver.cpp:35-68`), t_0 = 13 / 21,
  applied in two blocks of 2*N1 / 2*N2 (`dream/MLC/BitInterleaver.cpp`).
- energy dispersal PRBS x^9 + x^5 + 1, register init all-ones
  (`dream/MLC/EnergyDispersal.cpp:37-84`).
- QAM constellations: the ETSI normalized tables
  (`dream/tables/TableQAMMapping.h:40-84`), SM mapping
  {i_p q_p} = (y_p,0 y_p,1) (`dream/MLC/QAMMapping.cpp:47-115`).
- code-rate combinations per channel/protection level
  (`dream/tables/TableMLC.h:446-486`).

Decoding uses a soft-input Viterbi over the depunctured mother code
(64 states) per level, decoded in parallel (the standard's MLC
decoder may iterate between levels; Dream's default is one pass).

All tables here are recorded protocol constants of the DRM standard,
not creative expression; the code around them is original.
"""

from __future__ import annotations

import numpy as np

# -- mother code ------------------------------------------------------------

K = 7
# standard octal generators (MSB-first taps); Dream's 0155/0117/0123
# are these bit-reversed
GENERATORS = (0o133, 0o171, 0o145, 0o133)
# newest-input-at-bit-0 form used by the encoder/Viterbi below
# (identical to Dream's byGeneratorMatrix convention)
_REV = tuple(int(f"{g:07b}"[::-1], 2) for g in GENERATORS)

# pattern code -> which of the 4 generator outputs are transmitted
# (PP_TYPE_* encoding, TableMLC.h:67-72)
PP_1111, PP_0111, PP_0011, PP_0001, PP_0101 = 1, 2, 3, 4, 5
_EMIT = {0: (), PP_1111: (0, 1, 2, 3), PP_0111: (0, 1, 2),
         PP_0011: (0, 1), PP_0001: (0,), PP_0101: (0, 2)}

# {RX (groups), RY (ones), patterns...}: ETSI table 58
# (TableMLC.h iPuncturingPatterns) — row index is the code-rate id
PUNCT_PATTERNS = (
    (1, 4, PP_1111),                                         # R = 1/4
    (3, 10, PP_1111, PP_0111, PP_0111),                      # R = 3/10
    (1, 3, PP_0111),                                         # R = 1/3
    (4, 11, PP_0111, PP_0111, PP_0111, PP_0011),             # R = 4/11
    (1, 2, PP_0011),                                         # R = 1/2
    (4, 7, PP_0011, PP_0101, PP_0011, PP_0001),              # R = 4/7
    (3, 5, PP_0011, PP_0001, PP_0011),                       # R = 3/5
    (2, 3, PP_0011, PP_0001),                                # R = 2/3
    (8, 11, PP_0011, PP_0001, PP_0001, PP_0011,
     PP_0001, PP_0001, PP_0011, PP_0001),                    # R = 8/11
    (3, 4, PP_0011, PP_0001, PP_0001),                       # R = 3/4
    (4, 5, PP_0011, PP_0001, PP_0001, PP_0001),              # R = 4/5
    (7, 8, PP_0011, PP_0001, PP_0001, PP_0001,
     PP_0001, PP_0001, PP_0001),                             # R = 7/8
    (8, 9, PP_0011, PP_0001, PP_0001, PP_0001,
     PP_0001, PP_0001, PP_0001, PP_0001),                    # R = 8/9
)

# tailbit puncturing patterns, ETSI table 59 (TableMLC.h
# iPunctPatTailbits), 6 steps each; row = rp index
TAIL_PATTERNS = (
    (PP_0011,) * 6,
    (PP_0111,) + (PP_0011,) * 5,
    (PP_0111, PP_0011, PP_0011, PP_0111, PP_0011, PP_0011),
    (PP_0111, PP_0111, PP_0011, PP_0111, PP_0011, PP_0011),
    (PP_0111, PP_0111, PP_0011, PP_0111, PP_0111, PP_0011),
    (PP_0111, PP_0111, PP_0111, PP_0111, PP_0111, PP_0011),
    (PP_0111,) * 6,
    (PP_1111,) + (PP_0111,) * 5,
    (PP_1111, PP_0111, PP_0111, PP_1111, PP_0111, PP_0111),
    (PP_1111, PP_1111, PP_0111, PP_1111, PP_0111, PP_0111),
    (PP_1111, PP_1111, PP_0111, PP_1111, PP_0111, PP_1111),
    (PP_1111, PP_1111, PP_1111, PP_1111, PP_0111, PP_1111),
)

# code-rate combinations (TableMLC.h:446-486); row = protection level
RATE_MSC16 = ((2, 7, 3), (4, 9, 4))                  # R_0, R_1, RY_Icm
RATE_MSC64 = ((0, 4, 9, 4), (2, 7, 10, 15),
              (4, 9, 11, 8), (7, 10, 12, 45))        # R_0..R_2, RY_Icm
RATE_SDC16 = (2, 7)
RATE_SDC4 = 4
RATE_FAC = 6

# interleaver assignment per level: index into (t0=13, t0=21), -1=none
# (TableMLC.h iInterlSequ*)
INTERL_4SM = (1,)
INTERL_16SM = (0, 1)
INTERL_64SM = (-1, 0, 1)
_T0 = (13, 21)

# QAM constellations, normalized (TableQAMMapping.h); index =
# (y_0 << (m-1)) | ... | y_{m-1}
QAM4 = np.array([1.0, -1.0]) / np.sqrt(2.0)
QAM16 = np.array([3.0, -1.0, 1.0, -3.0]) / np.sqrt(10.0)
QAM64 = np.array([7.0, -1.0, 3.0, -5.0, 5.0, -3.0, 1.0, -7.0]) \
    / np.sqrt(42.0)
_QAM_OF_LEVELS = {1: QAM4, 2: QAM16, 3: QAM64}


# -- puncturing table (ChannelCode.cpp GenPuncPatTable) ---------------------

def gen_punct_table(chan_is_fac: bool, n2: int, num_a: int, num_b: int,
                    rate_a: int, rate_b: int, level: int,
                    n1: int = 0) -> list[int]:
    """Per-input-bit pattern codes for num_a+num_b data bits plus the
    6 tail bits (SM schemes; hierarchical paths not implemented)."""
    num = num_a + num_b
    tail_param = 2 * n2                     # SM: same for L0 and L1
    ry_b = PUNCT_PATTERNS[rate_b][1]
    tail_idx = (tail_param - 12) - ry_b * ((tail_param - 12) // ry_b)
    pat_a = PUNCT_PATTERNS[rate_a][2:2 + PUNCT_PATTERNS[rate_a][0]]
    pat_b = PUNCT_PATTERNS[rate_b][2:2 + PUNCT_PATTERNS[rate_b][0]]
    tail = TAIL_PATTERNS[tail_idx]
    out = []
    cnt = 0
    for i in range(num + K - 1):
        if i < num_a:
            out.append(pat_a[cnt])
            cnt = (cnt + 1) % len(pat_a)
        elif i < num or chan_is_fac:        # FAC: no special tailbits
            if i == num_a:
                cnt = 0
            out.append(pat_b[cnt])
            cnt = (cnt + 1) % len(pat_b)
        else:
            if i == num:
                cnt = 0
            out.append(tail[cnt])
            cnt += 1
    return out


# -- convolutional encoder / soft Viterbi -----------------------------------

# out_bits[w, j]: generator-j output for the 7-bit window w
# (bit 0 = newest input)
_OUT_BITS = np.zeros((128, 4), np.uint8)
for _w in range(128):
    for _j, _g in enumerate(_REV):
        _OUT_BITS[_w, _j] = bin(_w & _g).count("1") & 1
_OUT_PM = (2.0 * _OUT_BITS - 1.0)           # {0,1} -> {-1,+1}


def conv_encode(bits: np.ndarray, pp_table: list[int]) -> np.ndarray:
    """Punctured mother-code encode; returns the transmitted bits."""
    bits = np.asarray(bits, np.uint8)
    out = []
    reg = 0
    for i, pp in enumerate(pp_table):
        b = int(bits[i]) if i < len(bits) else 0    # zero tail
        reg = ((reg << 1) | b) & 127
        for j in _EMIT[pp]:
            out.append(_OUT_BITS[reg, j])
    return np.asarray(out, np.uint8)


def viterbi_decode(soft: np.ndarray, pp_table: list[int]) -> np.ndarray:
    """Soft-input Viterbi over the depunctured mother code.

    ``soft``: transmitted-bit soft values in pattern order, positive
    = bit 1.  Punctured positions are erasures (metric 0).  Returns
    the len(pp_table) - 6 decoded input bits.
    """
    n_steps = len(pp_table)
    # depuncture into (n_steps, 4)
    s4 = np.zeros((n_steps, 4), np.float64)
    pos = 0
    for i, pp in enumerate(pp_table):
        for j in _EMIT[pp]:
            s4[i, j] = soft[pos]
            pos += 1
    assert pos == len(soft), (pos, len(soft))

    NS = 64
    ns = np.arange(NS)
    p0 = ns >> 1                  # predecessor with dropped bit 0
    p1 = p0 | 32                  # predecessor with dropped bit 1
    metric = np.full(NS, -1e18)
    metric[0] = 0.0               # encoder starts from zero state
    bp = np.zeros((n_steps, NS), np.uint8)
    n_in = n_steps - (K - 1)
    for i in range(n_steps):
        bm = _OUT_PM @ s4[i]              # (128,) window metrics
        cand0 = metric[p0] + bm[ns]       # window w = ns
        cand1 = metric[p1] + bm[ns | 64]  # window w = ns | 64
        take1 = cand1 > cand0
        metric = np.where(take1, cand1, cand0)
        bp[i] = take1
        if i >= n_in:                     # tail: input bit forced 0
            metric[ns & 1 == 1] = -1e18
    # backtrace from the zero state (zero tail)
    state = 0
    bits = np.zeros(n_steps, np.uint8)
    for i in range(n_steps - 1, -1, -1):
        bits[i] = state & 1
        state = (state >> 1) | (32 if bp[i, state] else 0)
    return bits[:n_in]


# -- block interleaver ------------------------------------------------------

def interleaver_perm(n: int, t0: int) -> np.ndarray:
    """ETSI 7.3.3/7.6 permutation (BlockInterleaver.cpp MakeTable)."""
    highest = n
    s = 1 << 17
    while not (highest & (1 << 16)):
        highest <<= 1
        s >>= 1
    q = s // 4 - 1
    perm = np.zeros(n, np.int64)
    for i in range(1, n):
        v = (t0 * perm[i - 1] + q) % s
        while v >= n:
            v = (t0 * v + q) % s
        perm[i] = v
    return perm


class BitInterleaver:
    """Two-block interleaver (2*N1 then 2*N2, same t_0)."""

    def __init__(self, x1: int, x2: int, t0: int):
        self.x1, self.x2 = x1, x2
        self.p1 = interleaver_perm(x1, t0) if x1 > 0 else None
        self.p2 = interleaver_perm(x2, t0)

    def interleave(self, x: np.ndarray) -> np.ndarray:
        y = np.array(x)
        if self.p1 is not None:
            y[:self.x1] = y[:self.x1][self.p1]
        y[self.x1:self.x1 + self.x2] = \
            y[self.x1:self.x1 + self.x2][self.p2]
        return y

    def deinterleave(self, x: np.ndarray) -> np.ndarray:
        y = np.array(x)
        if self.p1 is not None:
            b = np.empty(self.x1, x.dtype)
            b[self.p1] = y[:self.x1]
            y[:self.x1] = b
        b = np.empty(self.x2, x.dtype)
        b[self.p2] = y[self.x1:self.x1 + self.x2]
        y[self.x1:self.x1 + self.x2] = b
        return y


# -- energy dispersal -------------------------------------------------------

def energy_dispersal(bits: np.ndarray) -> np.ndarray:
    """XOR with the PRBS x^9 + x^5 + 1, register init all ones
    (self-inverse).  VSPP split not implemented (no hierarchical)."""
    n = len(bits)
    prbs = np.zeros(n, np.uint8)
    reg = 0x1FF
    for i in range(n):
        b = ((reg >> 4) ^ (reg >> 8)) & 1
        reg = ((reg << 1) | b) & 0x1FF
        prbs[i] = b
    return np.bitwise_xor(np.asarray(bits, np.uint8), prbs)


# -- QAM soft demapping -----------------------------------------------------

def qam_soft(cells: np.ndarray, levels: int) -> np.ndarray:
    """Max-log per-bit soft values (positive = 1) for one axis-bit
    per level: returns (n_levels, 2*n_cells) — level p's stream is
    [re_0, im_0, re_1, im_1, ...] matching the SM mapping."""
    tab = _QAM_OF_LEVELS[levels]
    m = levels
    vals = np.stack([np.real(cells), np.imag(cells)],
                    axis=1).reshape(-1)          # re,im interleaved
    d2 = (vals[:, None] - tab[None, :]) ** 2     # (2n, 2^m)
    idx = np.arange(len(tab))
    out = np.zeros((m, len(vals)))
    for p in range(m):
        bit = (idx >> (m - 1 - p)) & 1
        m0 = d2[:, bit == 0].min(axis=1)
        m1 = d2[:, bit == 1].min(axis=1)
        out[p] = m0 - m1                         # >0 -> bit 1 closer
    return out


def qam_map(level_bits: list[np.ndarray]) -> np.ndarray:
    """SM QAM mapping: level p contributes bits (2i, 2i+1) of cell i
    to (real, imag); index = (y_0 << (m-1)) | ... | y_{m-1}."""
    m = len(level_bits)
    tab = _QAM_OF_LEVELS[m]
    n = len(level_bits[0]) // 2
    ire = np.zeros(n, np.int64)
    iim = np.zeros(n, np.int64)
    for p, bits in enumerate(level_bits):
        b = np.asarray(bits, np.int64)
        ire |= b[0::2] << (m - 1 - p)
        iim |= b[1::2] << (m - 1 - p)
    return tab[ire] + 1j * tab[iim]


# -- MLC codec (SM, EEP part-B only) ----------------------------------------

class MlcParams:
    """Per-level sizing for one channel (CalculateParam analogue,
    `dream/MLC/MLC.cpp:474-940`, SM schemes, N1=0 i.e. equal error
    protection — the repo's DRM scope)."""

    def __init__(self, chan: str, n_cells: int, levels: int = 1,
                 protection: int = 0):
        self.chan = chan
        self.n_cells = n_cells
        self.levels = levels
        n2 = n_cells
        if chan == "fac":
            assert levels == 1
            rates = (RATE_FAC,)
            interl = INTERL_4SM
            # FAC: M = NUM_FAC_BITS_PER_BLOCK, fixed
            ms = (72,)
        else:
            if levels == 1:
                rates, interl = (RATE_SDC4,), INTERL_4SM
            elif levels == 2:
                rates = (RATE_SDC16 if chan == "sdc"
                         else RATE_MSC16[protection][:2])
                interl = INTERL_16SM
            else:
                rates = RATE_MSC64[protection][:3]
                interl = INTERL_64SM
            # M_p,2 = RX_p * floor((2*N - 12) / RY_p)
            ms = tuple(
                PUNCT_PATTERNS[r][0] * ((2 * n2 - 12)
                                        // PUNCT_PATTERNS[r][1])
                for r in rates)
        self.rates = rates
        self.m_bits = ms
        self.total_bits = sum(ms)           # iL: payload bits/block
        self.pp_tables = [
            gen_punct_table(chan == "fac", n2, 0, ms[p], 0, rates[p],
                            p)
            for p in range(levels)]
        self.interleavers = [
            (BitInterleaver(0, 2 * n2, _T0[interl[p]])
             if interl[p] >= 0 else None)
            for p in range(levels)]
        # every level must fill exactly 2*N coded bits
        for p in range(levels):
            n_coded = sum(len(_EMIT[pp]) for pp in self.pp_tables[p])
            assert n_coded == 2 * n2, (chan, p, n_coded, 2 * n2)

    def encode(self, bits: np.ndarray) -> np.ndarray:
        """total_bits payload bits -> n_cells QAM cells."""
        assert len(bits) == self.total_bits
        bits = energy_dispersal(bits)
        level_bits = []
        pos = 0
        for p in range(self.levels):
            part = bits[pos:pos + self.m_bits[p]]
            pos += self.m_bits[p]
            coded = conv_encode(part, self.pp_tables[p])
            if self.interleavers[p] is not None:
                coded = self.interleavers[p].interleave(coded)
            level_bits.append(coded)
        return qam_map(level_bits)

    def decode(self, cells: np.ndarray) -> np.ndarray:
        """n_cells equalized cells -> total_bits hard bits."""
        soft = qam_soft(cells, self.levels)
        parts = []
        for p in range(self.levels):
            s = soft[p]
            if self.interleavers[p] is not None:
                s = self.interleavers[p].deinterleave(s)
            parts.append(viterbi_decode(s, self.pp_tables[p]))
        return energy_dispersal(np.concatenate(parts))
