"""FT8 message codec: LDPC(174,91) + CRC-14 + type-1 messages.

Completes the FT8 chain (Costas sync + tone log-likelihoods in
`ft8.py`).  Reference: `extensions/FT8/ft8_lib/` — belief-propagation
LDPC decode (`ldpc.c`), CRC-14 poly 0x2757 over 82 bits
(`crc_ft8.c`, `constants.h:49`), payload type 1 packing
(`message.c:153-220,760-1090`): two 28+1-bit callsigns, R flag,
15-bit grid/report, 3-bit type.

Implementation notes:
- The parity structure lives in `ft8_ldpc_tables.py` (protocol data);
  the ENCODER is derived from it at import by GF(2)-inverting the
  83x83 parity-column block of H — no generator table needed.
- Decoding is normalized min-sum belief propagation (numpy, host) —
  candidates arrive at ~10/15 s, far below any compute threshold.
- Callsign support: DE/QRZ/CQ tokens + standard basecalls (the same
  "A1AAA"-aligned 37/36/10/27/27/27 packing WSPR uses); hashed
  nonstandard calls are recognized but render as "<...>".
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .ft8_ldpc_tables import LDPC_M, LDPC_MN, LDPC_N, LDPC_K

CRC_POLY = 0x2757
CRC_WIDTH = 14
GRAY_MAP = (0, 1, 3, 2, 5, 6, 4, 7)

NTOKENS = 2063592
MAX22 = 4194304
MAXGRID4 = 32400
CHARSET = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ "

# ---------------------------------------------------------------------------
# parity matrix + derived encoder
# ---------------------------------------------------------------------------

_H = np.zeros((LDPC_M, LDPC_N), np.uint8)
for _i, _checks in enumerate(LDPC_MN):
    for _c in _checks:
        _H[_c - 1, _i] = 1

_CHECK_BITS = [np.nonzero(_H[m])[0] for m in range(LDPC_M)]


def _gf2_inv(a: np.ndarray) -> np.ndarray:
    n = a.shape[0]
    aug = np.concatenate([a.copy() % 2, np.eye(n, dtype=np.uint8)], 1)
    for col in range(n):
        piv = next(r for r in range(col, n) if aug[r, col])
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        for r in range(n):
            if r != col and aug[r, col]:
                aug[r] ^= aug[col]
    return aug[:, n:]


_A = _H[:, :LDPC_K]              # (83, 91) message columns
_B = _H[:, LDPC_K:]              # (83, 83) parity columns
_BINV = _gf2_inv(_B)


def ldpc_encode(msg91: np.ndarray) -> np.ndarray:
    """91 bits (77 payload + 14 CRC) -> 174-bit codeword."""
    parity = (_BINV @ (_A @ (np.asarray(msg91) % 2) % 2)) % 2
    return np.concatenate([np.asarray(msg91, np.uint8),
                           parity.astype(np.uint8)])


def ldpc_check(codeword: np.ndarray) -> int:
    """Number of failed parity checks (0 = valid)."""
    return int(np.sum((_H @ (np.asarray(codeword) % 2)) % 2))


def bp_decode(llr: np.ndarray, iters: int = 30, beta: float = 0.8
              ) -> np.ndarray | None:
    """Normalized min-sum BP.  llr[i] > 0 means bit i likely 1.

    Note sign convention: internally we use the standard LDPC LLR
    L = log(P0/P1), so we negate on entry.
    """
    l0 = -np.asarray(llr, np.float64)
    msg_cv = np.zeros((LDPC_M, LDPC_N))     # check -> var messages
    for _ in range(iters):
        # variable -> check: total minus incoming
        total = l0 + msg_cv.sum(axis=0)
        for m in range(LDPC_M):
            bits = _CHECK_BITS[m]
            vc = total[bits] - msg_cv[m, bits]
            sgn = np.prod(np.sign(vc + 1e-300))
            mags = np.abs(vc)
            # min excluding self
            order = np.argsort(mags)
            m1, m2 = mags[order[0]], mags[order[1]]
            out = np.where(np.arange(len(bits)) == order[0], m2, m1)
            s = sgn * np.sign(vc + 1e-300)
            msg_cv[m, bits] = beta * s * out
        total = l0 + msg_cv.sum(axis=0)
        hard = (total < 0).astype(np.uint8)
        if ldpc_check(hard) == 0:
            return hard
    return None


# ---------------------------------------------------------------------------
# CRC-14 (crc_ft8.c semantics)
# ---------------------------------------------------------------------------

def crc14(bits: np.ndarray) -> int:
    """CRC over a bit sequence (MSB-first bytes, crc_ft8.c:10-37)."""
    bits = np.asarray(bits, np.uint8)
    nbytes = (len(bits) + 7) // 8
    msg = np.zeros(nbytes, np.uint8)
    for i, b in enumerate(bits):
        msg[i // 8] |= b << (7 - (i % 8))
    rem = 0
    top = 1 << (CRC_WIDTH - 1)
    for idx_bit in range(len(bits)):
        if idx_bit % 8 == 0:
            rem ^= int(msg[idx_bit // 8]) << (CRC_WIDTH - 8)
        if rem & top:
            rem = ((rem << 1) ^ CRC_POLY)
        else:
            rem <<= 1
        rem &= (1 << CRC_WIDTH) - 1
    return rem


def add_crc(payload77: np.ndarray) -> np.ndarray:
    """77 payload bits -> 91 bits with CRC (computed over 77+5 zeros)."""
    padded = np.concatenate([np.asarray(payload77, np.uint8),
                             np.zeros(5, np.uint8)])
    c = crc14(padded)
    crc_bits = [(c >> (13 - i)) & 1 for i in range(14)]
    return np.concatenate([np.asarray(payload77, np.uint8),
                           np.asarray(crc_bits, np.uint8)])


def check_crc(msg91: np.ndarray) -> bool:
    payload = np.asarray(msg91[:77], np.uint8)
    got = 0
    for b in msg91[77:91]:
        got = (got << 1) | int(b)
    padded = np.concatenate([payload, np.zeros(5, np.uint8)])
    return crc14(padded) == got


# ---------------------------------------------------------------------------
# type-1 message pack / unpack
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Ft8Message:
    call_to: str          # "CQ" or a callsign
    call_de: str
    extra: str = ""       # grid4 / report / RRR / RR73 / 73 / ""


# standard-call character sets (`message.c` pack28/unpack28 and the
# FT8 protocol description): position 1 allows a leading space,
# positions 4-6 use space-FIRST alphabets — verified symbol-exact
# against the compiled ft8_lib oracle (tests/test_ft8_oracle.py,
# which caught the previous space-last ordering here)
_A1 = " 0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
_A2 = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
_A4 = " ABCDEFGHIJKLMNOPQRSTUVWXYZ"


def _pack_basecall(call: str) -> int | None:
    call = call.upper().strip()
    if not (2 <= len(call) <= 6):
        return None
    digit_positions = [i for i, ch in enumerate(call[:3])
                       if ch.isdigit()]
    if not digit_positions:
        return None
    call = " " * (2 - digit_positions[-1]) + call
    call = (call + "      ")[:6]
    try:
        v = _A1.index(call[0])
        v = v * 36 + _A2.index(call[1])
        v = v * 10 + int(call[2])
        for i in (3, 4, 5):
            v = v * 27 + _A4.index(call[i])
    except ValueError:
        return None
    return v


def pack28(call: str) -> int | None:
    call = call.upper().strip()
    if call == "DE":
        return 0
    if call == "QRZ":
        return 1
    if call == "CQ":
        return 2
    base = _pack_basecall(call)
    if base is None:
        return None
    return NTOKENS + MAX22 + base


def unpack28(n28: int) -> str:
    if n28 == 0:
        return "DE"
    if n28 == 1:
        return "QRZ"
    if n28 == 2:
        return "CQ"
    if n28 < NTOKENS:
        return "CQ?"                  # CQ_nnn / CQ_abcd variants
    n28 -= NTOKENS
    if n28 < MAX22:
        return f"<{n28}>"             # hashed nonstandard call
    n = n28 - MAX22
    out = [""] * 6
    out[5] = _A4[n % 27]
    n //= 27
    out[4] = _A4[n % 27]
    n //= 27
    out[3] = _A4[n % 27]
    n //= 27
    out[2] = str(n % 10)
    n //= 10
    out[1] = _A2[n % 36]
    n //= 36
    out[0] = _A1[n] if n < 37 else "?"
    return "".join(out).strip()


def pack_grid(extra: str) -> tuple[int, int]:
    """Return (g15, ir) per `packgrid` (message.c:1041-1086)."""
    extra = extra.upper().strip()
    if extra == "":
        return MAXGRID4 + 1, 0
    if extra == "RRR":
        return MAXGRID4 + 2, 0
    if extra == "RR73":
        return MAXGRID4 + 3, 0
    if extra == "73":
        return MAXGRID4 + 4, 0
    if (len(extra) == 4 and "A" <= extra[0] <= "R"
            and "A" <= extra[1] <= "R" and extra[2].isdigit()
            and extra[3].isdigit()):
        g = (ord(extra[0]) - ord("A"))
        g = g * 18 + (ord(extra[1]) - ord("A"))
        g = g * 10 + int(extra[2])
        g = g * 10 + int(extra[3])
        return g, 0
    if extra.startswith("R"):
        return MAXGRID4 + 35 + int(extra[1:]), 1
    return MAXGRID4 + 35 + int(extra), 0


def unpack_grid(g15: int, ir: int) -> str:
    if g15 <= MAXGRID4:
        g = g15
        d4 = g % 10; g //= 10
        d3 = g % 10; g //= 10
        c2 = chr(ord("A") + g % 18); g //= 18
        c1 = chr(ord("A") + g)
        return f"{c1}{c2}{d3}{d4}"
    n = g15 - MAXGRID4
    if n == 1:
        return ""
    if n == 2:
        return "RRR"
    if n == 3:
        return "RR73"
    if n == 4:
        return "73"
    rpt = n - 35
    return ("R" if ir else "") + f"{rpt:+03d}"


def pack_payload(msg: Ft8Message) -> np.ndarray | None:
    """Type-1 message -> 77 payload bits."""
    n28a = pack28(msg.call_to)
    n28b = pack28(msg.call_de)
    if n28a is None or n28b is None:
        return None
    g15, ir = pack_grid(msg.extra)
    v = 0
    v = (v << 28) | n28a
    v = (v << 1) | 0                 # ipa (/R or /P suffix flag)
    v = (v << 28) | n28b
    v = (v << 1) | 0                 # ipb
    v = (v << 1) | ir
    v = (v << 15) | (g15 & 0x7FFF)
    v = (v << 3) | 1                 # i3 = 1
    return np.asarray([(v >> (76 - i)) & 1 for i in range(77)],
                      np.uint8)


def unpack_payload(bits77: np.ndarray) -> Ft8Message | None:
    v = 0
    for b in bits77:
        v = (v << 1) | int(b)
    i3 = v & 7
    if i3 not in (1, 2):
        return None
    g15 = (v >> 3) & 0x7FFF
    ir = (v >> 18) & 1
    n28b = (v >> 20) & 0xFFFFFFF
    n28a = (v >> 49) & 0xFFFFFFF
    return Ft8Message(call_to=unpack28(n28a), call_de=unpack28(n28b),
                      extra=unpack_grid(g15, ir))


# ---------------------------------------------------------------------------
# tones <-> codeword (Gray mapping, Costas insertion)
# ---------------------------------------------------------------------------

def codeword_to_tones(codeword174: np.ndarray) -> np.ndarray:
    """174 bits -> 79 tones (58 data symbols + 3x7 Costas)."""
    from .ft8 import COSTAS, COSTAS_POS, NSYM
    tones = np.zeros(NSYM, np.uint8)
    for pos in COSTAS_POS:
        tones[pos:pos + 7] = COSTAS
    data_positions = [i for i in range(NSYM)
                      if not any(p <= i < p + 7 for p in COSTAS_POS)]
    for k, i in enumerate(data_positions):
        bits3 = (int(codeword174[3 * k]) << 2) | \
            (int(codeword174[3 * k + 1]) << 1) | int(codeword174[3 * k + 2])
        tones[i] = GRAY_MAP[bits3]
    return tones


def tone_powers_to_llrs(logp: np.ndarray) -> np.ndarray:
    """(58, 8) tone powers -> (174,) bit LLRs (positive = bit 1).

    Max-log approximation over the Gray-mapped tone set.
    """
    p = np.log(np.maximum(np.asarray(logp, np.float64), 1e-12))
    llrs = np.zeros(174)
    for k in range(58):
        for b in range(3):
            ones = [GRAY_MAP[t] for t in range(8)
                    if (t >> (2 - b)) & 1]
            zeros = [GRAY_MAP[t] for t in range(8)
                     if not (t >> (2 - b)) & 1]
            llrs[3 * k + b] = (np.max(p[k, ones])
                               - np.max(p[k, zeros]))
    return llrs


def decode_llrs(llrs174: np.ndarray) -> Ft8Message | None:
    cw = bp_decode(llrs174)
    if cw is None:
        return None
    msg91 = cw[:91]
    if not check_crc(msg91):
        return None
    return unpack_payload(msg91[:77])
