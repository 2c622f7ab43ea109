"""GPS L1 C/A PRN code generation (and the E1B code-loading hook).

Reference: `gps/cacode.h` — G1/G2 LFSR pair, G2 output tapped at two
stages selected per PRN (IS-GPS-200 table 3-Ia).  Codes are generated
host-side once (numpy) and shipped to the device as +-1 float tables;
the FPGA's bit-serial generator (`verilog/gps/cacode.v`) has no TPU
counterpart — table lookup wins on a machine with HBM.

Galileo E1B 4092-chip memory codes (`gps/e1bcode.h`) are *data* from
the Galileo OS SIS ICD; they load at runtime via :func:`load_e1b_codes`
from a hex file if present (not bundled).
"""

from __future__ import annotations

import functools

import numpy as np

from ...numerology import L1_CODELEN

# IS-GPS-200 G2 phase-select taps per PRN (1-based stages)
_G2_TAPS = {
    1: (2, 6), 2: (3, 7), 3: (4, 8), 4: (5, 9), 5: (1, 9), 6: (2, 10),
    7: (1, 8), 8: (2, 9), 9: (3, 10), 10: (2, 3), 11: (3, 4), 12: (5, 6),
    13: (6, 7), 14: (7, 8), 15: (8, 9), 16: (9, 10), 17: (1, 4),
    18: (2, 5), 19: (3, 6), 20: (4, 7), 21: (5, 8), 22: (6, 9),
    23: (1, 3), 24: (4, 6), 25: (5, 7), 26: (6, 8), 27: (7, 9),
    28: (8, 10), 29: (1, 6), 30: (2, 7), 31: (3, 8), 32: (4, 9),
}


@functools.lru_cache(maxsize=None)
def ca_code(prn: int) -> np.ndarray:
    """1023-chip C/A code for PRN 1..32 as int8 in {+1, -1}.

    (+1 = logical 0, -1 = logical 1, i.e. BPSK mapping.)
    """
    if prn not in _G2_TAPS:
        raise ValueError(f"PRN {prn} not supported (1..32)")
    t1, t2 = _G2_TAPS[prn]
    g1 = np.ones(10, np.int8)
    g2 = np.ones(10, np.int8)
    out = np.empty(L1_CODELEN, np.int8)
    for i in range(L1_CODELEN):
        chip = g1[9] ^ (g2[t1 - 1] ^ g2[t2 - 1])
        out[i] = 1 - 2 * chip
        fb1 = g1[2] ^ g1[9]
        fb2 = g2[1] ^ g2[2] ^ g2[5] ^ g2[7] ^ g2[8] ^ g2[9]
        g1[1:] = g1[:-1]; g1[0] = fb1
        g2[1:] = g2[:-1]; g2[0] = fb2
    return out


@functools.lru_cache(maxsize=None)
def ca_code_sampled(prn: int, fs: float, n: int,
                    chip_rate: float = 1.023e6,
                    code_phase_chips: float = 0.0) -> np.ndarray:
    """C/A code resampled to ``n`` samples at rate ``fs`` (float32 +-1).

    Sample k holds code[floor(phase + k*chip_rate/fs) mod 1023] — the
    same zero-order hold the FPGA code NCO performs
    (`verilog/gps/demod.v:72-107`).
    """
    code = ca_code_any(prn).astype(np.float32)
    idx = (code_phase_chips
           + np.arange(n, dtype=np.float64) * chip_rate / fs)
    return code[np.floor(idx).astype(np.int64) % L1_CODELEN]


def load_e1b_codes(path: str) -> dict[int, np.ndarray]:
    """Load Galileo E1B memory codes from a hex dump file.

    Format: one line per PRN: ``<prn> <1023-hex-digit string>`` (4092
    bits).  Returns {prn: int8 array of +-1}.  The codes are ICD data;
    ship your own copy (e.g. extracted from the Galileo OS SIS ICD
    annex) — they are not bundled with the framework.
    """
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 2:
                continue
            prn = int(parts[0])
            bits = bin(int(parts[1], 16))[2:].zfill(4092)
            out[prn] = np.asarray(
                [1 - 2 * int(b) for b in bits], np.int8)
    return out


# G2-delay-specified PRNs (IS-GPS-200 table 3-I delays for 1..37;
# SBAS/QZSS entries as documented in the reference `gps/sats.cpp:63-98`
# — WAAS/EGNOS/GATBP/MSAS, and the commissioned QZSS L1 C/A birds).
G2_DELAYS = {
    # Navstar (cross-check against the tap table)
    1: 5, 2: 6, 3: 7, 4: 8, 5: 17, 6: 18, 7: 139, 8: 140, 9: 141,
    10: 251, 11: 252, 12: 254, 13: 255, 14: 256, 15: 257, 16: 258,
    17: 469, 18: 470, 19: 471, 20: 472, 21: 473, 22: 474, 23: 509,
    24: 512, 25: 513, 26: 514, 27: 515, 28: 516, 29: 859, 30: 860,
    31: 861, 32: 862,
    # SBAS (WAAS 131/133/135/138/140, EGNOS 120/123/136, GATBP 122,
    # MSAS 129/137)
    120: 145, 122: 52, 123: 21, 129: 762, 131: 1012, 133: 603,
    135: 359, 136: 595, 137: 68, 138: 386, 140: 456,
    # QZSS L1 C/A (sats.cpp: QZS-2/-4/-1R/-3)
    194: 208, 195: 711, 196: 189, 199: 663,
}

QZSS_PRNS = (194, 195, 196, 199)
SBAS_PRNS = (120, 122, 123, 129, 131, 133, 135, 136, 137, 138, 140)


@functools.lru_cache(maxsize=None)
def _g1_seq() -> np.ndarray:
    g1 = np.ones(10, np.int8)
    out = np.empty(L1_CODELEN, np.int8)
    for i in range(L1_CODELEN):
        out[i] = g1[9]
        fb = g1[2] ^ g1[9]
        g1[1:] = g1[:-1]
        g1[0] = fb
    return out


@functools.lru_cache(maxsize=None)
def _g2_seq() -> np.ndarray:
    g2 = np.ones(10, np.int8)
    out = np.empty(L1_CODELEN, np.int8)
    for i in range(L1_CODELEN):
        out[i] = g2[9]
        fb = g2[1] ^ g2[2] ^ g2[5] ^ g2[7] ^ g2[8] ^ g2[9]
        g2[1:] = g2[:-1]
        g2[0] = fb
    return out


@functools.lru_cache(maxsize=None)
def ca_code_any(prn: int) -> np.ndarray:
    """C/A code for any G2-delay-specified PRN (Navstar, SBAS, QZSS),
    int8 in {+1, -1}.  chip[i] = G1[i] xor G2[i - delay]."""
    if prn in _G2_TAPS:
        return ca_code(prn)
    if prn not in G2_DELAYS:
        raise ValueError(f"PRN {prn}: no G2 delay known")
    g1, g2 = _g1_seq(), _g2_seq()
    chips = g1 ^ np.roll(g2, G2_DELAYS[prn])
    return (1 - 2 * chips).astype(np.int8)
