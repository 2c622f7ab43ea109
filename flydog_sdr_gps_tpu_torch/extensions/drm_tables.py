"""DRM OFDM cell mapping — ETSI ES 201 980 section 8.4 tables and the
cell-map builder.

All tables here are constant protocol data from the DRM standard
(robustness modes A-D): FAC cell positions (table section 7.2.3 /
Annex), frequency-reference and time-reference pilot positions/phases
(8.4.2, 8.4.3), scattered-pilot position rule and phase tables W/Z/Q
(8.4.4), boosted-pilot edge carriers, and the carrier ranges per
spectrum occupancy.  They match the reference's Dream tables
value-for-value (`extensions/DRM/dream/tables/TableCarMap.cpp`,
consumed by `dream/OFDMcellmapping/CellMappingTable.cpp:MakeTable`);
`tests/test_drm_tables.py` holds an independent literal transcription
of the Dream MakeTable algorithm and compares whole maps.

The builder follows the standard's precedence (8.4.4.3: gain
references yield to frequency/time references), producing for every
(symbol-in-superframe, carrier) one of the cell kinds plus the complex
pilot value where applicable.

Phases are in units of 2*pi/1024 ("normalized to 1024").
"""

from __future__ import annotations

import dataclasses
import numpy as np

NUM_FAC_CELLS = 65
NUM_FRAMES_IN_SUPERFRAME = 3

# cell kind flags (bit flags; pilot kinds can stack)
CM_DC = 1
CM_MSC = 2
CM_SDC = 4
CM_FAC = 8
CM_TI_PI = 16
CM_FRE_PI = 32
CM_SCAT_PI = 64
CM_BOOSTED_PI = 128

# FAC cell positions {frame symbol, carrier} per robustness mode
FAC_CELLS = {
    "A": ((2, 26), (2, 46), (2, 66), (2, 86),
          (3, 10), (3, 30), (3, 50), (3, 70), (3, 90),
          (4, 14), (4, 22), (4, 34), (4, 62), (4, 74), (4, 94),
          (5, 26), (5, 38), (5, 58), (5, 66), (5, 78),
          (6, 22), (6, 30), (6, 42), (6, 62), (6, 70), (6, 82),
          (7, 26), (7, 34), (7, 46), (7, 66), (7, 74), (7, 86),
          (8, 10), (8, 30), (8, 38), (8, 50), (8, 58), (8, 70),
          (8, 78), (8, 90),
          (9, 14), (9, 22), (9, 34), (9, 42), (9, 62), (9, 74),
          (9, 82), (9, 94),
          (10, 26), (10, 38), (10, 46), (10, 66), (10, 86),
          (11, 10), (11, 30), (11, 50), (11, 70), (11, 90),
          (12, 14), (12, 34), (12, 74), (12, 94),
          (13, 38), (13, 58), (13, 78)),
    "B": ((2, 13), (2, 25), (2, 43), (2, 55), (2, 67),
          (3, 15), (3, 27), (3, 45), (3, 57), (3, 69),
          (4, 17), (4, 29), (4, 47), (4, 59), (4, 71),
          (5, 19), (5, 31), (5, 49), (5, 61), (5, 73),
          (6, 9), (6, 21), (6, 33), (6, 51), (6, 63), (6, 75),
          (7, 11), (7, 23), (7, 35), (7, 53), (7, 65), (7, 77),
          (8, 13), (8, 25), (8, 37), (8, 55), (8, 67), (8, 79),
          (9, 15), (9, 27), (9, 39), (9, 57), (9, 69), (9, 81),
          (10, 17), (10, 29), (10, 41), (10, 59), (10, 71), (10, 83),
          (11, 19), (11, 31), (11, 43), (11, 61), (11, 73),
          (12, 21), (12, 33), (12, 45), (12, 63), (12, 75),
          (13, 23), (13, 35), (13, 47), (13, 65), (13, 77)),
    "C": ((3, 9), (3, 21), (3, 45), (3, 57),
          (4, 23), (4, 35), (4, 47),
          (5, 13), (5, 25), (5, 37), (5, 49),
          (6, 15), (6, 27), (6, 39), (6, 51),
          (7, 5), (7, 17), (7, 29), (7, 41), (7, 53),
          (8, 7), (8, 19), (8, 31), (8, 43), (8, 55),
          (9, 9), (9, 21), (9, 45), (9, 57),
          (10, 23), (10, 35), (10, 47),
          (11, 13), (11, 25), (11, 37), (11, 49),
          (12, 15), (12, 27), (12, 39), (12, 51),
          (13, 5), (13, 17), (13, 29), (13, 41), (13, 53),
          (14, 7), (14, 19), (14, 31), (14, 43), (14, 55),
          (15, 9), (15, 21), (15, 45), (15, 57),
          (16, 23), (16, 35), (16, 47),
          (17, 13), (17, 25), (17, 37), (17, 49),
          (18, 15), (18, 27), (18, 39), (18, 51)),
    "D": ((3, 9), (3, 18), (3, 27),
          (4, 10), (4, 19),
          (5, 11), (5, 20), (5, 29),
          (6, 12), (6, 30),
          (7, 13), (7, 22), (7, 31),
          (8, 5), (8, 14), (8, 23), (8, 32),
          (9, 6), (9, 15), (9, 24), (9, 33),
          (10, 16), (10, 25), (10, 34),
          (11, 8), (11, 17), (11, 26), (11, 35),
          (12, 9), (12, 18), (12, 27), (12, 36),
          (13, 10), (13, 19), (13, 37),
          (14, 11), (14, 20), (14, 29),
          (15, 12), (15, 30),
          (16, 13), (16, 22), (16, 31),
          (17, 5), (17, 14), (17, 23), (17, 32),
          (18, 6), (18, 15), (18, 24), (18, 33),
          (19, 16), (19, 25), (19, 34),
          (20, 8), (20, 17), (20, 26), (20, 35),
          (21, 9), (21, 18), (21, 27), (21, 36),
          (22, 10), (22, 19), (22, 37)),
}

# frequency-reference pilots {carrier, phase/1024} (8.4.2.2), present
# in every symbol
FREQ_PILOTS = {
    "A": ((18, 205), (54, 836), (72, 215)),
    "B": ((16, 331), (48, 651), (64, 555)),
    "C": ((11, 214), (33, 392), (44, 242)),
    "D": ((7, 788), (21, 1014), (28, 332)),
}

# time-reference pilots {carrier, phase/1024} (8.4.3.2), first symbol
# of each frame
TIME_PILOTS = {
    "A": ((17, 973), (18, 205), (19, 717), (21, 264), (28, 357),
          (29, 357), (32, 952), (33, 440), (39, 856), (40, 88),
          (41, 88), (53, 68), (54, 836), (55, 836), (56, 836),
          (60, 1008), (61, 1008), (63, 752), (71, 215), (72, 215),
          (73, 727)),
    "B": ((14, 304), (16, 331), (18, 108), (20, 620), (24, 192),
          (26, 704), (32, 44), (36, 432), (42, 588), (44, 844),
          (48, 651), (49, 651), (50, 651), (54, 460), (56, 460),
          (62, 944), (64, 555), (66, 940), (68, 428)),
    "C": ((8, 722), (10, 466), (11, 214), (12, 214), (14, 479),
          (16, 516), (18, 260), (22, 577), (24, 662), (28, 3),
          (30, 771), (32, 392), (33, 392), (36, 37), (38, 37),
          (42, 474), (44, 242), (45, 242), (46, 754)),
    "D": ((5, 636), (6, 124), (7, 788), (8, 788), (9, 200),
          (11, 688), (12, 152), (14, 920), (15, 920), (17, 644),
          (18, 388), (20, 652), (21, 1014), (23, 176), (24, 176),
          (26, 752), (27, 496), (28, 332), (29, 432), (30, 964),
          (32, 452)),
}

# scattered pilots (8.4.4): position rule constants (x=freq interval,
# y=time interval, k0) and the phase tables W_1024, Z_256, Q_1024
SCAT_CONST = {  # (x, y, k0)
    "A": (4, 5, 2), "B": (2, 3, 1), "C": (2, 2, 1), "D": (1, 3, 1),
}
SCAT_W = {
    "A": ((228, 341, 455), (455, 569, 683), (683, 796, 910),
          (910, 0, 114), (114, 228, 341)),
    "B": ((512, 0, 512, 0, 512), (0, 512, 0, 512, 0),
          (512, 0, 512, 0, 512)),
    "C": ((465, 372, 279, 186, 93, 0, 931, 838, 745, 652),
          (931, 838, 745, 652, 559, 465, 372, 279, 186, 93)),
    "D": ((366, 439, 512, 585, 658, 731, 805, 878),
          (731, 805, 878, 951, 0, 73, 146, 219),
          (73, 146, 219, 293, 366, 439, 512, 585)),
}
SCAT_Z = {
    "A": ((0, 81, 248), (18, 106, 106), (122, 116, 31),
          (129, 129, 39), (33, 32, 111)),
    "B": ((0, 57, 164, 64, 12), (168, 255, 161, 106, 118),
          (25, 232, 132, 233, 38)),
    "C": ((0, 76, 29, 76, 9, 190, 161, 248, 33, 108),
          (179, 178, 83, 253, 127, 105, 101, 198, 250, 145)),
    "D": ((0, 240, 17, 60, 220, 38, 151, 101),
          (110, 7, 78, 82, 175, 150, 106, 25),
          (165, 7, 252, 124, 253, 177, 197, 142)),
}
SCAT_Q = {"A": 36, "B": 12, "C": 12, "D": 14}

# boosted scattered pilots per (spectrum occupancy, mode) (8.4.4.2)
SCAT_GAIN = {
    "A": ((2, 6, 98, 102), (2, 6, 110, 114), (-102, -98, 98, 102),
          (-114, -110, 110, 114), (-98, -94, 310, 314),
          (-110, -106, 346, 350)),
    "B": ((1, 3, 89, 91), (1, 3, 101, 103), (-91, -89, 89, 91),
          (-103, -101, 101, 103), (-87, -85, 277, 279),
          (-99, -97, 309, 311)),
    "C": ((0, 0, 0, 0), (0, 0, 0, 0), (0, 0, 0, 0),
          (-69, -67, 67, 69), (0, 0, 0, 0), (-67, -65, 211, 213)),
    "D": ((0, 0, 0, 0), (0, 0, 0, 0), (0, 0, 0, 0),
          (-44, -43, 43, 44), (0, 0, 0, 0), (-43, -42, 134, 135)),
}

# carrier range per spectrum occupancy (rows SO_0..SO_5) and mode
# (cols A..D) — ETSI table 84/85
CARRIER_KMIN = ((2, 1, 0, 0), (2, 1, 0, 0), (-102, -91, 0, 0),
                (-114, -103, -69, -44), (-98, -87, 0, 0),
                (-110, -99, -67, -43))
CARRIER_KMAX = ((102, 91, 0, 0), (114, 103, 0, 0), (102, 91, 0, 0),
                (114, 103, 69, 44), (314, 279, 0, 0),
                (350, 311, 213, 135))

# OFDM numerology per mode at the 48 kHz reference rate (ETSI table
# 82): (Tu in samples @48k, guard numerator, guard denominator,
# symbols per frame)
MODE_NUMEROLOGY = {
    "A": (1152, 1, 9, 15),
    "B": (1024, 1, 4, 15),
    "C": (704, 4, 11, 20),
    "D": (448, 11, 14, 24),
}
_MODE_COL = {"A": 0, "B": 1, "C": 2, "D": 3}

# SDC occupies the first 2 (modes A/B) or 3 (C/D) symbols of the
# superframe (6.3.3 / MakeTable)
SDC_SYMBOLS = {"A": 2, "B": 2, "C": 3, "D": 3}


@dataclasses.dataclass(frozen=True)
class CellMap:
    """One superframe's cell layout for (mode, spectrum occupancy).

    ``kinds``: (n_sym_super, n_carrier) int flags (CM_*);
    ``pilots``: same shape complex pilot values (0 where not a pilot).
    Carrier axis index = k - kmin.
    """
    mode: str
    spec_occ: int
    kmin: int
    kmax: int
    tu: int                 # useful symbol length at fs
    guard: int
    syms_per_frame: int
    kinds: np.ndarray
    pilots: np.ndarray

    @property
    def ts(self) -> int:
        return self.tu + self.guard

    @property
    def n_carrier(self) -> int:
        return self.kmax - self.kmin + 1

    @property
    def syms_per_super(self) -> int:
        return self.syms_per_frame * NUM_FRAMES_IN_SUPERFRAME

    def cells_of(self, kind_flag: int, sym: int) -> np.ndarray:
        """Carrier indices k (signed) of cells with ``kind_flag`` in
        superframe symbol ``sym``, in increasing k."""
        idx = np.where(self.kinds[sym] & kind_flag)[0]
        return idx + self.kmin

    def count(self, kind_flag: int) -> int:
        return int(np.count_nonzero(self.kinds & kind_flag))


def _polar(amp: float, phase1024: int) -> complex:
    return amp * np.exp(2j * np.pi * (phase1024 % 1024) / 1024.0)


def make_cell_map(mode: str = "B", spec_occ: int = 3,
                  fs: float = 12000.0) -> CellMap:
    """Build the superframe cell map (the MakeTable analogue,
    `CellMappingTable.cpp:41-496`, ETSI 8.4).

    ``fs``: sample rate the OFDM runs at; Tu scales from the 48 kHz
    reference numerology (e.g. mode B: 1024 @48k -> 256 @12k).
    """
    tu48, g_num, g_den, nsym_frame = MODE_NUMEROLOGY[mode]
    col = _MODE_COL[mode]
    kmin = CARRIER_KMIN[spec_occ][col]
    kmax = CARRIER_KMAX[spec_occ][col]
    if kmin == 0 and kmax == 0:
        raise ValueError(f"mode {mode} not defined for SO_{spec_occ}")
    tu = int(tu48 * fs / 48000)
    guard = tu * g_num // g_den
    nsym_super = nsym_frame * NUM_FRAMES_IN_SUPERFRAME
    ncar = kmax - kmin + 1

    kinds = np.zeros((nsym_super, ncar), np.int32)
    pilots = np.zeros((nsym_super, ncar), np.complex128)

    x, y, k0 = SCAT_CONST[mode]
    w_tab = np.asarray(SCAT_W[mode])
    z_tab = np.asarray(SCAT_Z[mode])
    q = SCAT_Q[mode]
    boosted = set(SCAT_GAIN[mode][spec_occ])
    fac_tab = FAC_CELLS[mode]
    freq_tab = FREQ_PILOTS[mode]
    time_tab = TIME_PILOTS[mode]
    n_sdc_sym = SDC_SYMBOLS[mode]

    for sym in range(nsym_super):
        fsym = sym % nsym_frame
        row = kinds[sym]
        # all cells start as MSC; first symbols of the superframe are
        # SDC
        row[:] = CM_SDC if sym < n_sdc_sym else CM_MSC
        # FAC (per frame, from the table)
        for (s, k) in fac_tab:
            if s == fsym:
                row[k - kmin] = CM_FAC
        # scattered pilots (8.4.4.1): k = k_off + x*y*p for integer p,
        # where k_off = ceil(x/2) + x*(s mod y)
        k_off = (x + 1) // 2 + x * (fsym % y)
        p_min = -(-(kmin - k_off) // (x * y))     # ceil division
        n_idx = fsym % y
        m_idx = fsym // y
        for p in range(p_min, (kmax - k_off) // (x * y) + 1):
            k = k_off + x * y * p
            i = k - kmin
            row[i] = CM_SCAT_PI
            # phase (8.4.4.3.1): v = (4*Z[n,m] + p*W[n,m]
            #                         + p^2*(1+s)*Q) mod 1024
            ph = (4 * int(z_tab[n_idx, m_idx])
                  + p * int(w_tab[n_idx, m_idx])
                  + p * p * (1 + fsym) * q) % 1024
            amp = 2.0 if k in boosted else np.sqrt(2.0)
            if k in boosted:
                row[i] |= CM_BOOSTED_PI
            pilots[sym, i] = _polar(amp, ph)
        # time pilots (first symbol of each frame); phases take
        # precedence over scattered pilots (8.4.4.3)
        if fsym == 0:
            for (k, ph) in time_tab:
                if not kmin <= k <= kmax:
                    continue
                i = k - kmin
                if row[i] & CM_SCAT_PI:
                    row[i] |= CM_TI_PI
                else:
                    row[i] = CM_TI_PI
                pilots[sym, i] = _polar(np.sqrt(2.0), ph)
        # frequency pilots (all symbols); mode D special case: the
        # first two pilots flip phase on odd symbols
        for j, (k, ph) in enumerate(freq_tab):
            if not kmin <= k <= kmax:
                continue
            i = k - kmin
            if row[i] & (CM_TI_PI | CM_SCAT_PI):
                row[i] |= CM_FRE_PI
            else:
                row[i] = CM_FRE_PI
            if mode == "D" and j < 2 and fsym % 2 == 1:
                ph = (ph + 512) % 1024
            pilots[sym, i] = _polar(np.sqrt(2.0), ph)
        # DC carrier unused (mode A also skips k = +-1)
        if kmin <= 0 <= kmax:
            row[0 - kmin] = CM_DC
            pilots[sym, 0 - kmin] = 0.0
        if mode == "A":
            for k in (-1, 1):
                if kmin <= k <= kmax:
                    row[k - kmin] = CM_DC
                    pilots[sym, k - kmin] = 0.0
    return CellMap(mode=mode, spec_occ=spec_occ, kmin=kmin, kmax=kmax,
                   tu=tu, guard=guard, syms_per_frame=nsym_frame,
                   kinds=kinds, pilots=pilots)
