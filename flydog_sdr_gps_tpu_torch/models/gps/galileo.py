"""Galileo E1B support: acquisition hooks, I/NAV FEC, page framing.

The port's copy of :mod:`flydog_sdr_gps_tpu.models.gps.galileo`: the
host code (Viterbi, interleaver, CRC-24Q, the I/NAV word codec,
``InavAssembler``) is the reference's, line for line, but for the
Viterbi decoder's inner loop, which steps every state at once with the
reference's result (the loop over states, a page part at a time, held
the interpreter long enough with several Galileo satellites tracked to
stall a server's block loop); the E1B cold search
(:func:`acquire_all_e1b`) runs on the port's acquisition.

Reference: E1B memory codes downloaded to the FPGA (`CmdSetE1Bcode`,
`gps/e1bcode.h` data), acquisition shares the C/A search with a
4092-chip/4 ms code period, and I/NAV decoding goes through
GNSS-SDRLIB (`gps/GNSS-SDRLIB/sdrnav_gal.cpp`) with the ka9q K=7
r=1/2 Viterbi decoder (`gps/ka9q-fec/viterbi27_port.cpp`).

This module provides:
- the E1B code registry: ICD memory codes loaded at runtime
  (`cacode.load_e1b_codes` — ICD data, not bundled) or deterministic
  synthetic stand-ins for closed-loop testing;
- code-FFT construction (BOC(1,1)) for acquisition;
- a full K=7 r=1/2 Viterbi decoder (standard CCSDS polynomials
  171/133 octal, as used by Galileo I/NAV);
- I/NAV page framing: CRC-24Q, word types 0-5 encode/decode
  (OS SIS ICD 4.3.5 field layouts), 8x30 interleaver, page-part
  FEC, and a live symbol-stream assembler (`InavAssembler`) with the
  same interface as the LNAV `SubframeAssembler`.
"""

from __future__ import annotations

import numpy as np
import torch

from ...numerology import E1B_CODELEN
from . import acquisition, ephemeris

# CCSDS / Galileo I/NAV convolutional code (K=7, r=1/2).  Note: the
# Galileo SIS transmits the G2 branch inverted; receivers handling
# real signals negate the second soft value per pair before decode.
G1_OCT = 0o171
G2_OCT = 0o133
K = 7
INAV_SYNC = np.array([0, 1, 0, 1, 1, 0, 0, 0, 0, 0], np.uint8)


def e1b_code_fft(params: acquisition.AcqParams, code: np.ndarray
                 ) -> np.ndarray:
    """Conjugated spectrum of a 4092-chip E1B code sampled at fs.

    E1B's 4 ms primary code period matches the 4 ms acquisition window
    (16384 samples at 4.092 Msps = 1 sample/chip x 4), so the same
    conj-multiply search machinery applies; the BOC(1,1) subcarrier is
    approximated by its dominant correlation peak, as the reference's
    search does before handing to tracking.
    """
    # 4.092 Msps over 4 ms -> 16368 samples for 4092 chips (4/chip)
    chips = np.floor(np.arange(params.fft_len)
                     * (E1B_CODELEN / 16368.0)).astype(np.int64)
    sampled = np.asarray(code, np.float32)[
        np.clip(chips, 0, E1B_CODELEN - 1)]
    # BOC(1,1): one subcarrier half-cycle per half chip
    boc = np.where((np.arange(params.fft_len) * 2
                    * E1B_CODELEN // 16368) % 2 == 0, 1.0, -1.0)
    return np.conj(np.fft.fft(sampled * boc)).astype(np.complex64)


# ---------------------------------------------------------------------------
# Viterbi K=7 r=1/2
# ---------------------------------------------------------------------------

def conv_encode_k7(bits: np.ndarray) -> np.ndarray:
    """Encode with G1/G2 (MSB-first shift register), 2 bits/input."""
    g1 = int(G1_OCT)
    g2 = int(G2_OCT)
    state = 0
    out = np.zeros(2 * len(bits), np.uint8)
    for i, b in enumerate(bits):
        state = ((state << 1) | int(b)) & 0x7F
        out[2 * i] = bin(state & g1).count("1") & 1
        out[2 * i + 1] = bin(state & g2).count("1") & 1
    return out


def viterbi_decode_k7(soft: np.ndarray, tail: bool = True) -> np.ndarray:
    """Soft-decision Viterbi for the K=7 code.

    soft: (2n,) values, positive = coded bit 1.  Returns n decoded
    bits (including the K-1 tail if ``tail``).

    The reference's decoder, one step of every state at a time: next
    state ``ns`` has the two predecessors ``ns >> 1`` and ``(ns >> 1) |
    32``, both on input ``ns & 1``; the reference visits them in that
    order and keeps the first of two equal metrics, and leaves a state
    that no reachable state enters at its initial values, as here.  The
    branch metrics are the same sums in the same order, so the bits are
    the reference's, ties included.
    """
    soft = np.asarray(soft, np.float64)
    n = len(soft) // 2
    nstates = 64
    ns = np.arange(nstates)
    b = ns & 1
    preds = np.stack([ns >> 1, (ns >> 1) | 32])           # (2, 64)
    reg = (preds << 1) | b                                 # 7-bit register
    sign0 = np.where(_parity(reg & int(G1_OCT)), 1.0, -1.0)
    sign1 = np.where(_parity(reg & int(G2_OCT)), 1.0, -1.0)
    metric = np.full(nstates, -1e18)
    metric[0] = 0.0
    back = np.zeros((n, nstates), np.int8)
    prev_state = np.zeros((n, nstates), np.int64)
    for t in range(n):
        m_in = metric[preds]                               # (2, 64)
        live = m_in > -1e17
        m = m_in + (sign0 * soft[2 * t] + sign1 * soft[2 * t + 1])
        second = live[1] & (~live[0] | (m[1] > m[0]))
        any_live = live[0] | live[1]
        metric = np.where(second, m[1], np.where(live[0], m[0], -1e18))
        back[t] = np.where(any_live, b, 0)
        prev_state[t] = np.where(second, preds[1],
                                 np.where(live[0], preds[0], 0))
    # traceback from state 0 when tail-terminated, else best state
    s = 0 if tail else int(np.argmax(metric))
    bits = np.zeros(n, np.uint8)
    for t in range(n - 1, -1, -1):
        bits[t] = back[t, s]
        s = int(prev_state[t, s])
    return bits


def _parity(x: np.ndarray) -> np.ndarray:
    """Each element's bit parity (x < 2**8)."""
    x = x ^ (x >> 4)
    x = x ^ (x >> 2)
    return (x ^ (x >> 1)) & 1


# ---------------------------------------------------------------------------
# I/NAV page structure
# ---------------------------------------------------------------------------

def inav_deinterleave(symbols240: np.ndarray) -> np.ndarray:
    """8x30 block deinterleaver (written by columns, read by rows)."""
    return np.asarray(symbols240).reshape(30, 8).T.reshape(-1)


def inav_interleave(symbols240: np.ndarray) -> np.ndarray:
    return np.asarray(symbols240).reshape(8, 30).T.reshape(-1)


# ---------------------------------------------------------------------------
# E1B memory code registry
# ---------------------------------------------------------------------------
# The real ICD memory codes ship with the package (`e1b_codes.py`, the
# same 50-PRN hex tables the reference downloads to its FPGA from
# `gps/e1bcode.h` via `CmdSetE1Bcode`).  ``set_e1b_codes`` can still
# override individual PRNs (the analogue of downloading a different
# code table to the correlators).

_E1B_CODES: dict[int, np.ndarray] = {}


def set_e1b_codes(codes: dict[int, np.ndarray]) -> None:
    """Override E1B memory codes ({prn: (4092,) +-1 int8})."""
    for prn, c in codes.items():
        c = np.asarray(c, np.int8)
        if c.shape != (E1B_CODELEN,):
            raise ValueError(f"E1B PRN {prn}: need {E1B_CODELEN} chips")
        _E1B_CODES[prn] = c
    _CODE_FFT_CACHE.clear()


def e1b_code(prn: int) -> np.ndarray:
    """The E1B primary code for Galileo SV id ``prn`` (1..50):
    an installed override if present, else the bundled ICD code."""
    c = _E1B_CODES.get(prn)
    if c is None:
        from . import e1b_codes
        c = _E1B_CODES[prn] = e1b_codes.e1b_chips(prn)
    return c


# ---------------------------------------------------------------------------
# CRC-24Q (same polynomial as the RTCM/SBAS CRC; Galileo ICD 4.3.2.3)
# ---------------------------------------------------------------------------

_CRC24Q_POLY = 0x1864CFB


def crc24q(bits: np.ndarray) -> int:
    """CRC-24Q over a bit array (MSB-first), init 0."""
    reg = 0
    for b in np.asarray(bits, np.uint8):
        reg = ((reg << 1) | int(b)) & 0xFFFFFF if not (reg & 0x800000) \
            else ((((reg << 1) | int(b)) ^ _CRC24Q_POLY) & 0xFFFFFF)
    for _ in range(24):
        reg = ((reg << 1) & 0xFFFFFF) if not (reg & 0x800000) \
            else (((reg << 1) ^ _CRC24Q_POLY) & 0xFFFFFF)
    return reg


# ---------------------------------------------------------------------------
# I/NAV word codec (OS SIS ICD 4.3.5 field layouts, words 0-5)
# ---------------------------------------------------------------------------

PI_ICD = ephemeris.PI
PAGE_SYMS = 500                 # one nominal page: even + odd part
PART_SYMS = 250                 # 10 sync + 240 coded symbols
SYM_RATE = 250.0                # I/NAV symbols per second


def _bits_of(val: int, n: int) -> np.ndarray:
    val &= (1 << n) - 1
    return np.array([(val >> (n - 1 - i)) & 1 for i in range(n)],
                    np.uint8)


def _int_of(bits: np.ndarray, signed: bool = False) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    if signed and v >= 1 << (len(bits) - 1):
        v -= 1 << len(bits)
    return v


def _q(val: float, lsb: float, n: int) -> int:
    """Quantize to an n-bit two's-complement field."""
    v = int(round(val / lsb))
    lim = 1 << (n - 1)
    return max(-lim, min(lim - 1, v)) & ((1 << n) - 1)


def _qu(val: float, lsb: float, n: int) -> int:
    v = int(round(val / lsb))
    return max(0, min((1 << n) - 1, v))


def encode_word(wt: int, eph: ephemeris.Ephemeris, wn: int = 0,
                tow: float = 0.0) -> np.ndarray:
    """Encode I/NAV word type ``wt`` (0-5) to 128 bits.

    Angles in ``eph`` are radians; fields are scaled per the Galileo
    OS SIS ICD 4.3.5 (semicircles with the ICD's pi).  Word types 1-4
    carry the Keplerian set + clock; 5 carries WN/TOW (+iono, zeroed
    here); 0 is the time/spare word.
    """
    iod = (eph.iode if eph.iode >= 0 else 0) & 0x3FF
    sc = PI_ICD                  # radians per semicircle
    if wt == 1:
        f = [( wt, 6), (iod, 10), (_qu(eph.toe, 60.0, 14), 14),
             (_q(eph.m0 / sc, 2.0 ** -31, 32), 32),
             (_qu(eph.e, 2.0 ** -33, 32), 32),
             (_qu(eph.sqrt_a, 2.0 ** -19, 32), 32), (0, 2)]
    elif wt == 2:
        f = [(wt, 6), (iod, 10),
             (_q(eph.omega0 / sc, 2.0 ** -31, 32), 32),
             (_q(eph.i0 / sc, 2.0 ** -31, 32), 32),
             (_q(eph.omega / sc, 2.0 ** -31, 32), 32),
             (_q(eph.idot / sc, 2.0 ** -43, 14), 14), (0, 2)]
    elif wt == 3:
        f = [(wt, 6), (iod, 10),
             (_q(eph.omega_dot / sc, 2.0 ** -43, 24), 24),
             (_q(eph.delta_n / sc, 2.0 ** -43, 16), 16),
             (_q(eph.cuc, 2.0 ** -29, 16), 16),
             (_q(eph.cus, 2.0 ** -29, 16), 16),
             (_q(eph.crc, 2.0 ** -5, 16), 16),
             (_q(eph.crs, 2.0 ** -5, 16), 16), (107, 8)]
    elif wt == 4:
        f = [(wt, 6), (iod, 10), (eph.prn & 0x3F, 6),
             (_q(eph.cic, 2.0 ** -29, 16), 16),
             (_q(eph.cis, 2.0 ** -29, 16), 16),
             (_qu(eph.toc, 60.0, 14), 14),
             (_q(eph.af0, 2.0 ** -34, 31), 31),
             (_q(eph.af1, 2.0 ** -46, 21), 21),
             (_q(eph.af2, 2.0 ** -59, 6), 6), (0, 2)]
    elif wt == 5:
        f = [(wt, 6), (0, 11), (0, 11), (0, 14), (0, 5),  # iono zeroed
             (0, 10), (0, 10),          # BGD E1/E5a, E1/E5b
             (0, 2), (0, 2), (0, 1), (0, 1),  # HS/DVS flags: healthy
             (wn & 0xFFF, 12), (_qu(tow, 1.0, 20), 20), (0, 23)]
    elif wt == 0:
        f = [(wt, 6), (2, 2), (0, 88),
             (wn & 0xFFF, 12), (_qu(tow, 1.0, 20), 20)]
    else:
        raise ValueError(f"word type {wt} not supported")
    out = np.concatenate([_bits_of(v, n) for v, n in f])
    assert out.shape == (128,), (wt, out.shape)
    return out


def decode_word(w: np.ndarray, eph: ephemeris.Ephemeris
                ) -> tuple[int, float | None, int | None]:
    """Decode a 128-bit I/NAV word into ``eph``.

    Returns (word_type, tow or None, iod_nav or None).
    """
    wt = _int_of(w[:6])
    sc = PI_ICD
    tow = iod = None
    if wt == 1:
        iod = _int_of(w[6:16])
        eph.toe = _int_of(w[16:30]) * 60.0
        eph.m0 = _int_of(w[30:62], signed=True) * 2.0 ** -31 * sc
        eph.e = _int_of(w[62:94]) * 2.0 ** -33
        eph.sqrt_a = _int_of(w[94:126]) * 2.0 ** -19
    elif wt == 2:
        iod = _int_of(w[6:16])
        eph.omega0 = _int_of(w[16:48], signed=True) * 2.0 ** -31 * sc
        eph.i0 = _int_of(w[48:80], signed=True) * 2.0 ** -31 * sc
        eph.omega = _int_of(w[80:112], signed=True) * 2.0 ** -31 * sc
        eph.idot = _int_of(w[112:126], signed=True) * 2.0 ** -43 * sc
    elif wt == 3:
        iod = _int_of(w[6:16])
        eph.omega_dot = _int_of(w[16:40], signed=True) * 2.0 ** -43 * sc
        eph.delta_n = _int_of(w[40:56], signed=True) * 2.0 ** -43 * sc
        eph.cuc = _int_of(w[56:72], signed=True) * 2.0 ** -29
        eph.cus = _int_of(w[72:88], signed=True) * 2.0 ** -29
        eph.crc = _int_of(w[88:104], signed=True) * 2.0 ** -5
        eph.crs = _int_of(w[104:120], signed=True) * 2.0 ** -5
    elif wt == 4:
        iod = _int_of(w[6:16])
        eph.cic = _int_of(w[22:38], signed=True) * 2.0 ** -29
        eph.cis = _int_of(w[38:54], signed=True) * 2.0 ** -29
        eph.toc = _int_of(w[54:68]) * 60.0
        eph.af0 = _int_of(w[68:99], signed=True) * 2.0 ** -34
        eph.af1 = _int_of(w[99:120], signed=True) * 2.0 ** -46
        eph.af2 = _int_of(w[120:126], signed=True) * 2.0 ** -59
    elif wt == 5:
        eph.week = _int_of(w[73:85])
        tow = float(_int_of(w[85:105]))
    elif wt == 0:
        if _int_of(w[6:8]) == 2:
            eph.week = _int_of(w[96:108])
            tow = float(_int_of(w[108:128]))
    if iod is not None:
        # IOD-nav keys word-set consistency (OS SIS ICD 5.1.9.2);
        # keep the latest so encode_word round-trips it.
        eph.iode = iod
    return wt, tow, iod


# ---------------------------------------------------------------------------
# page framing (ICD 4.3.2: sync + FEC + interleave; CRC over 196 bits)
# ---------------------------------------------------------------------------

def _fec_part(bits120: np.ndarray) -> np.ndarray:
    """120 bits -> 240 transmitted coded bits (G2 inverted, interleaved)."""
    sym = conv_encode_k7(np.asarray(bits120, np.uint8))
    sym[1::2] ^= 1                          # G2 branch sent inverted
    return inav_interleave(sym)


def encode_nominal_page(word128: np.ndarray) -> np.ndarray:
    """One 2 s nominal page (even + odd part) as 500 coded bits
    (sync included).  Transmit symbols are (1 - 2*bit)."""
    w = np.asarray(word128, np.uint8)
    even = np.concatenate([[0, 0], w[:112], np.zeros(6, np.uint8)]
                          ).astype(np.uint8)
    odd_head = np.concatenate([[1, 0], w[112:128],
                               np.zeros(64, np.uint8)]).astype(np.uint8)
    crc = crc24q(np.concatenate([even[:114], odd_head]))
    odd = np.concatenate([odd_head, _bits_of(crc, 24),
                          np.zeros(14, np.uint8)]).astype(np.uint8)
    return np.concatenate([INAV_SYNC, _fec_part(even),
                           INAV_SYNC, _fec_part(odd)])


def _decode_part(soft250: np.ndarray) -> np.ndarray:
    """250 polarity-corrected soft symbols -> 120 decoded bits.

    Input convention: positive symbol == coded bit 0 (BPSK 1-2b)."""
    de = inav_deinterleave(np.asarray(soft250, np.float64)[10:])
    soft = -de                              # positive == bit 1
    soft[1::2] *= -1.0                      # undo the G2 inversion
    return viterbi_decode_k7(soft)


class InavAssembler:
    """Live I/NAV page sync + decode from a tracked symbol stream.

    Same interface as :class:`ephemeris.SubframeAssembler`: feed soft
    symbols (one per 4 ms code period), drain ``events`` of
    (word_type, global_page_start_symbol, tow).  TOW convention: the
    word-5/0 TOW field is the GST second-of-week at the start of the
    nominal page carrying it (first sync symbol of the even part) —
    the same convention :func:`inav symbol stream generators
    <flydog_sdr_gps_tpu.models.gps.scene>` encode.
    """

    def __init__(self, prn: int = 0):
        self.eph = ephemeris.Ephemeris(prn=prn)
        self.syms: list[float] = []
        self.base = 0                   # global index of syms[0]
        self.subframes = 0              # pages decoded (naming parity)
        self.events: list[tuple[int, int, float]] = []
        self._iods: dict[int, int] = {}
        self._sync = (1.0 - 2.0 * INAV_SYNC.astype(np.float64))

    def _sync_at(self, arr: np.ndarray, off: int) -> int:
        """+1/-1 polarity if a clean sync sits at ``off``, else 0."""
        c = float(np.sign(arr[off:off + 10]) @ self._sync)
        return int(np.sign(c)) if abs(c) >= 10.0 else 0

    def feed(self, syms) -> list[int]:
        self.syms.extend(float(s) for s in np.atleast_1d(syms))
        decoded = []
        while len(self.syms) >= PAGE_SYMS:
            arr = np.asarray(self.syms)
            hit = False
            for off in range(len(arr) - PAGE_SYMS + 1):
                pol = self._sync_at(arr, off)
                if pol == 0 or self._sync_at(arr, off + PART_SYMS) != pol:
                    continue
                p1 = _decode_part(pol * arr[off:off + PART_SYMS])
                p2 = _decode_part(
                    pol * arr[off + PART_SYMS:off + PAGE_SYMS])
                if p1[0] == 0 and p2[0] == 1 and p1[1] == 0 and p2[1] == 0:
                    crc = crc24q(np.concatenate([p1[:114], p2[:82]]))
                    if crc == _int_of(p2[82:106]):
                        word = np.concatenate([p1[2:114], p2[2:18]])
                        wt, tow, iod = decode_word(word, self.eph)
                        if iod is not None:
                            self._iods[wt] = iod
                        if {1, 2, 3, 4} <= set(self._iods) and \
                                len(set(self._iods.values())) == 1:
                            self.eph.have |= {1, 2, 3}
                        self.subframes += 1
                        decoded.append(wt)
                        if tow is not None:
                            self.events.append((wt, self.base + off, tow))
                        del self.syms[:off + PAGE_SYMS]
                        self.base += off + PAGE_SYMS
                        hit = True
                        break
                # a sync pair that fails decode: skip just this sync
            if not hit:
                # no decodable page in the window; keep the tail
                keep = PAGE_SYMS + 20
                if len(self.syms) > 3 * keep:
                    drop = len(self.syms) - keep
                    del self.syms[:drop]
                    self.base += drop
                break
        return decoded


# ---------------------------------------------------------------------------
# E1B cold search (reference: E1B shares the C/A search engine with a
# 4 ms window, `gps/search.cpp` + `CmdSetE1Bcode`)
# ---------------------------------------------------------------------------

_CODE_FFT_CACHE: dict[int, np.ndarray] = {}


def _replica(code: torch.Tensor, chips: torch.Tensor) -> torch.Tensor:
    """The BOC(1,1) E1B replica (float64) at the given code chips."""
    ci = torch.floor(chips)
    sign = torch.where(chips - ci < 0.5, 1.0, -1.0).to(torch.float64)
    return code[torch.remainder(ci.to(torch.int64), code.shape[0])] * sign


def _refine_doppler(params: acquisition.AcqParams, raw: torch.Tensor,
                    code: torch.Tensor, cp: float, dop: float) -> float:
    """Fine Doppler by dense power scan around the acquired bin.

    The FFT search bins are fs/fft_len ~ 250 Hz; a worst-case 125 Hz
    handoff error costs the E1B tracking loops their pull-in margin
    (the 4 ms symbol period leaves less averaging than C/A's 20 ms
    bits).  A direct correlation power scan at 25 Hz steps over
    +-137 Hz, combined per-1 ms NON-coherently (so a symbol edge
    inside the window cannot null any candidate), is unambiguous —
    unlike phase-slope estimators, which wrap at the bin edge — and a
    parabolic fit on the winning neighborhood lands within a few Hz.
    ``raw`` and ``code`` are float64 tensors; the 12 candidates are
    one batch on their device.
    """
    sub_n = params.n_raw // 4                       # ~1 ms at fs_if
    n = min(raw.shape[0], 2 * params.n_raw) // sub_n * sub_n
    k = torch.arange(n, dtype=torch.float64, device=raw.device)
    t = k / params.fs_if
    x = raw[:n] * _replica(code, cp + k * 1.023e6 / params.fs_if)
    offs = np.arange(-137.5, 138.0, 25.0)
    f = torch.as_tensor(params.fc + dop + offs, device=raw.device)
    bb = x * torch.exp((-2j * np.pi * f)[:, None] * t)
    sub = bb.reshape(len(offs), -1, sub_n).sum(dim=2)
    pw = (sub.abs() ** 2).sum(dim=1).cpu().numpy()
    j = int(np.argmax(pw))
    if 0 < j < len(offs) - 1:
        denom = pw[j - 1] - 2 * pw[j] + pw[j + 1]
        if abs(denom) > 1e-12:
            j_frac = 0.5 * (pw[j - 1] - pw[j + 1]) / denom
            return dop + float(offs[j] + np.clip(j_frac, -1, 1) * 25.0)
    return dop + float(offs[j])


def _refine_code_phase(params: acquisition.AcqParams, raw: torch.Tensor,
                       code: torch.Tensor, cp: float, dop: float
                       ) -> float:
    """Exact full-rate code-phase scan around the FFT-search estimate.

    The FFT search correlates circularly over fft_len = 16384 samples
    while the E1B period is 16368 — the wrapped partial period can
    displace the apparent peak by the 16-sample difference (~4 chips),
    window-dependently.  A direct scan over +-6 chips in 1/4-chip
    steps (non-coherent over 1 ms sub-blocks, so symbol flips cannot
    null it) is unambiguous.  ``raw`` and ``code`` are float64
    tensors; the 49 candidates are one batch on their device, and the
    first of equal powers wins, as in the reference's scan.
    """
    sub_n = params.n_raw // 4
    n = min(raw.shape[0], 2 * params.n_raw) // sub_n * sub_n
    k = torch.arange(n, dtype=torch.float64, device=raw.device)
    t = k / params.fs_if
    bb = raw[:n] * torch.exp((-2j * np.pi * (params.fc + dop)) * t)
    base = k * 1.023e6 / params.fs_if
    ds = np.arange(-6.0, 6.01, 0.25)
    chips = torch.as_tensor(cp + ds, device=raw.device)[:, None] + base
    sub = (bb * _replica(code, chips)).reshape(len(ds), -1,
                                               sub_n).sum(dim=2)
    pw = (sub.abs() ** 2).sum(dim=1).cpu().numpy()
    return float((cp + ds[int(np.argmax(pw))]) % code.shape[0])


def acquire_all_e1b(params: acquisition.AcqParams, raw: np.ndarray,
                    prns: tuple[int, ...], batch: int = 4,
                    device: torch.device | str = "cuda") -> list[dict]:
    """Full E1B cold search over ``prns`` (Galileo SV ids).

    4 ms coherent window = exactly one E1B code period (and one I/NAV
    symbol).  Symbols are code-period aligned, so every window holds
    one potential data edge at a fixed offset; when ``raw`` spans
    >= 2 windows the correlation powers are combined NON-coherently
    across windows so a flipped symbol cannot null the peak (worst
    case for a single window is total cancellation at a mid-window
    edge).  Returns dicts like the C/A search, with code_phase in E1B
    chips (0..4092) and sub-bin-refined Doppler.

    The power planes are computed on ``device`` (the card unless the
    caller asks for the CPU), and so are the refinements, in float64 as
    in the reference (which runs them on the host: about a second of
    one core a cold search there).
    """
    raw_np = np.asarray(raw, np.float32)
    raw64 = torch.as_tensor(raw_np[:2 * params.n_raw].astype(np.float64),
                            device=device)
    n_win = max(1, min(2, len(raw_np) // params.n_raw))
    bbs = [acquisition.downsample_if(
        params, torch.as_tensor(raw_np[w * params.n_raw:
                                       (w + 1) * params.n_raw],
                                device=device))
        for w in range(n_win)]
    period = int(round(params.fs / 1.023e6 * E1B_CODELEN))  # 16368
    results = []
    for i in range(0, len(prns), batch):
        grp = tuple(prns[i:i + batch])
        cfs = []
        for p in grp:
            if p not in _CODE_FFT_CACHE:
                _CODE_FFT_CACHE[p] = e1b_code_fft(params, e1b_code(p))
            cfs.append(_CODE_FFT_CACHE[p])
        cf = torch.as_tensor(np.stack(cfs), device=device)
        power = acquisition.acquire_power(params, bbs[0], cf)
        for w, b in enumerate(bbs[1:], start=1):
            pw = acquisition.acquire_power(params, b, cf)
            # window w starts w*fft_len samples later; the code slips
            # (fft_len mod period) samples per window (16384 vs 16368
            # at 4.092 Msps), shifting its correlation peak — roll to
            # realign before non-coherent combining (without this the
            # combined argmax can land ~4 chips off on the weaker
            # window's peak: a false handoff that never locks)
            shift = (w * params.fft_len) % period
            power = power + torch.roll(pw, shift, dims=-1)
        snr, cp, dop = (v.cpu().numpy() for v in acquisition.peak_from_power(
            params, power,
            code_period_samples=period, chips_per_period=E1B_CODELEN))
        for j, p in enumerate(grp):
            d = float(dop[j])
            c = float(cp[j])
            if float(snr[j]) > 25.0:
                code = torch.as_tensor(e1b_code(p).astype(np.float64),
                                       device=device)
                c = _refine_code_phase(params, raw64, code, c, d)
                d = _refine_doppler(params, raw64, code, c, d)
            results.append(dict(prn=p, snr=float(snr[j]),
                                code_phase=c, doppler=d))
    results.sort(key=lambda r: -r["snr"])
    return results
