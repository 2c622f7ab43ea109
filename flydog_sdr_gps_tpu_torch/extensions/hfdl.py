"""HFDL extension — HF Data Link (ARINC 635) demodulator/decoder.

Reference: `extensions/HFDL/` (dumphfdl-style decoder fed by the
channel's IQ stream).  The HFDL waveform: single 1800 Hz carrier,
1800 symbols/s M-PSK.  A transmission = prekey tone + known sync
sequences (which also convey the data rate) + data in 45-symbol
blocks of 30 data + 15 known probe symbols.  User rates:

  1800 bps  8PSK   rate-1/2 K=7      (3 bit/sym * 2/3 duty / 2)
  1200 bps  QPSK   rate-1/2
   600 bps  BPSK   rate-1/2
   300 bps  BPSK   rate-1/2 + x2 repetition

FEC is the shared K=7 (171,133) code; coded bits are block-interleaved
per frame.  Above the modem, MPDUs carry a 16-bit length, payload and
CRC-16-CCITT (`make_mpdu`/`parse_mpdu`).

Implementation notes: 12 kHz audio / 1800 baud is a
non-integer 20/3 samples/symbol, so the modem runs at 10.8 kHz
(exactly 6 samples/symbol) behind a 9/10 polyphase resampler.  The
narrowband DSP is host-side numpy on the channel taps, like the other
decoder extensions; the wideband front end is the shared channelizer.
"""

from __future__ import annotations

import numpy as np

from . import Extension, ext_register
from .taps import host_column
from ..models.gps.galileo import conv_encode_k7, viterbi_decode_k7
from .s4285 import rrc_taps

FS_AUDIO = 12000.0
FS = 10800.0
BAUD = 1800.0
SPS = 6
FC = 1800.0

PREKEY = 48                  # constant-phase symbols (carrier detect)
SYNC_REPS = 2                # A-sequence repetitions
RATE_REPS = 5                # rate tribit repetitions
DATA_SYMS = 30
PROBE_SYMS = 15
BLOCK = DATA_SYMS + PROBE_SYMS
BLOCKS_PER_FRAME = 4         # 120 data symbols per frame

# 15-symbol sync "A" sequence (tribits) — chosen for a flat spectrum
# and sharp autocorrelation, role of the ARINC 635 preamble sequences.
A_SEQ = np.array([0, 4, 2, 6, 1, 5, 3, 7, 0, 2, 4, 6, 5, 1, 3],
                 np.int64)

RATES = {1800: ("8psk", 3, 1), 1200: ("qpsk", 2, 1),
         600: ("bpsk", 1, 1), 300: ("bpsk", 1, 2)}
RATE_IDS = {1800: 0, 1200: 1, 600: 2, 300: 3}
IDS_RATE = {v: k for k, v in RATE_IDS.items()}


def _lfsr_tribits(n: int, seed: int = 0x5A) -> np.ndarray:
    """Probe/data scrambler PN (x^7 + x^3 + 1)."""
    reg = seed & 0x7F
    out = np.zeros(n, np.int64)
    for i in range(n):
        v = 0
        for _ in range(3):
            bit = ((reg >> 6) ^ (reg >> 2)) & 1
            reg = ((reg << 1) | bit) & 0x7F
            v = (v << 1) | bit
        out[i] = v
    return out


SCRAMBLE = _lfsr_tribits(BLOCKS_PER_FRAME * BLOCK)
_RRC = rrc_taps(alpha=0.3, span=8, sps=SPS)


def _psk8(tribits: np.ndarray) -> np.ndarray:
    return np.exp(1j * (np.pi / 4) * tribits)


# ---------------------------------------------------------------------------
# 9/10 resampler (12 kHz <-> 10.8 kHz), windowed-sinc polyphase
# ---------------------------------------------------------------------------

def _resample(x: np.ndarray, up: int, down: int) -> np.ndarray:
    ntaps = 16 * max(up, down) + 1
    cutoff = 0.5 / max(up, down)
    n = np.arange(ntaps) - ntaps // 2
    h = 2 * cutoff * np.sinc(2 * cutoff * n) * np.hanning(ntaps) * up
    stuffed = np.zeros(len(x) * up, x.dtype)
    stuffed[::up] = x
    y = np.convolve(stuffed, h)[ntaps // 2:ntaps // 2 + len(stuffed)]
    return y[::down]


def resample_12k_to_modem(x: np.ndarray) -> np.ndarray:
    return _resample(x, 9, 10)


def resample_modem_to_12k(x: np.ndarray) -> np.ndarray:
    return _resample(x, 10, 9)


# ---------------------------------------------------------------------------
# MPDU framing: len16 | payload | crc16-ccitt
# ---------------------------------------------------------------------------

def crc16_ccitt(data: bytes, crc: int = 0xFFFF) -> int:
    for byte in data:
        crc ^= byte << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021 if crc & 0x8000 else crc << 1) \
                & 0xFFFF
    return crc


def make_mpdu(payload: bytes) -> np.ndarray:
    hdr = len(payload).to_bytes(2, "big")
    crc = crc16_ccitt(hdr + payload).to_bytes(2, "big")
    return np.unpackbits(np.frombuffer(hdr + payload + crc, np.uint8))


def parse_mpdu(bits: np.ndarray) -> bytes | None:
    if len(bits) < 32:
        return None
    data = np.packbits(bits[:len(bits) - len(bits) % 8]).tobytes()
    n = int.from_bytes(data[:2], "big")
    if len(data) < n + 4:
        return None
    if crc16_ccitt(data[:n + 2]) != int.from_bytes(
            data[n + 2:n + 4], "big"):
        return None
    return data[2:n + 2]


# ---------------------------------------------------------------------------
# Modulator
# ---------------------------------------------------------------------------

def interleave(bits: np.ndarray, rows: int = 6) -> np.ndarray:
    return bits.reshape(rows, -1).T.reshape(-1)


def deinterleave(bits: np.ndarray, rows: int = 6) -> np.ndarray:
    return bits.reshape(-1, rows).T.reshape(-1)


def modulate(bits: np.ndarray, rate: int = 1800,
             amp: float = 0.5) -> np.ndarray:
    """User bits -> HFDL passband audio at 12 kHz."""
    mod, bps, rep = RATES[rate]
    coded = conv_encode_k7(np.concatenate(
        [np.asarray(bits, np.uint8), np.zeros(6, np.uint8)]))
    coded = np.repeat(coded, rep)
    cbits_frame = BLOCKS_PER_FRAME * DATA_SYMS * bps
    pad = (-len(coded)) % cbits_frame
    coded = np.concatenate([coded, np.zeros(pad, np.uint8)])

    syms = [np.zeros(PREKEY, np.int64),
            np.tile(A_SEQ, SYNC_REPS),
            np.full(RATE_REPS, RATE_IDS[rate], np.int64)]
    for f in range(len(coded) // cbits_frame):
        fb = interleave(coded[f * cbits_frame:(f + 1) * cbits_frame])
        if mod == "8psk":
            tri = fb.reshape(-1, 3)
            d = tri[:, 0] * 4 + tri[:, 1] * 2 + tri[:, 2]
        elif mod == "qpsk":
            di = fb.reshape(-1, 2)
            d = (di[:, 0] * 2 + di[:, 1]) * 2
        else:
            d = fb * 4
        frame = np.zeros(BLOCKS_PER_FRAME * BLOCK, np.int64)
        for b in range(BLOCKS_PER_FRAME):
            frame[b * BLOCK:b * BLOCK + DATA_SYMS] = \
                d[b * DATA_SYMS:(b + 1) * DATA_SYMS]
        frame = (frame + SCRAMBLE) % 8          # probes = scramble PN
        syms.append(frame)
    symbols = np.concatenate(syms)

    iq = _psk8(symbols)
    up = np.zeros(len(iq) * SPS, np.complex128)
    up[::SPS] = iq
    bb = np.convolve(up, _RRC)
    t = np.arange(len(bb))
    pb = np.real(bb * np.exp(2j * np.pi * FC * t / FS))
    pb = np.concatenate([np.zeros(240), pb, np.zeros(240)])
    return (amp * resample_modem_to_12k(pb)).astype(np.float32)


# ---------------------------------------------------------------------------
# Receiver
# ---------------------------------------------------------------------------

def _sync_wave() -> np.ndarray:
    iq = _psk8(np.tile(A_SEQ, SYNC_REPS))
    up = np.zeros(len(iq) * SPS, np.complex128)
    up[::SPS] = iq
    return np.convolve(up, _RRC)[:SYNC_REPS * len(A_SEQ) * SPS]


class HfdlRx:
    """Streaming receiver: 12 kHz audio in, MPDU payloads out."""

    def __init__(self, mu: float = 0.08, eq_taps: int = 7):
        self.mu = mu
        self.eq_taps = eq_taps
        self._audio = np.zeros(0, np.float32)
        self._bb = np.zeros(0, np.complex128)
        self._n0 = 0
        self._pre = np.conj(_sync_wave()[::-1])
        self.payloads: list[bytes] = []

    _K = 160        # resampler overlap (covers the 161-tap edges)
    _CHUNK = 4800   # audio samples converted per step (0.4 s)

    def feed(self, audio12k: np.ndarray) -> list[tuple[int, bytes]]:
        """Returns [(rate_bps, payload), ...] for completed MPDUs."""
        self._audio = np.concatenate(
            [self._audio, np.asarray(audio12k, np.float32)])
        # overlap-save streaming resample: emit only the interior
        # region of each chunk so block edges never glitch
        K, CH = self._K, self._CHUNK
        while len(self._audio) >= CH + 2 * K:
            seg = _resample(self._audio[:CH + 2 * K].astype(np.float64),
                            9, 10)
            good = seg[K * 9 // 10:(K + CH) * 9 // 10]
            t = np.arange(self._n0, self._n0 + len(good))
            self._bb = np.concatenate(
                [self._bb, good * np.exp(-2j * np.pi * FC * t / FS)])
            self._n0 += len(good)
            self._audio = self._audio[CH:]
        return self._scan()

    def _scan(self) -> list[tuple[int, bytes]]:
        out = []
        head = (PREKEY + SYNC_REPS * len(A_SEQ) + RATE_REPS) * SPS
        frame_samps = BLOCKS_PER_FRAME * BLOCK * SPS
        min_need = head + 2 * frame_samps
        while len(self._bb) >= min_need:
            bb = np.convolve(self._bb[:min_need], _RRC)[
                len(_RRC) // 2:len(_RRC) // 2 + min_need]
            corr = np.abs(np.convolve(bb[:head + frame_samps],
                                      self._pre, mode="valid"))
            thresh = 5.0 * np.median(corr) + 1e-12
            above = np.nonzero(corr > thresh)[0]
            if len(above) == 0:
                self._drop(min_need - len(self._pre))
                continue
            i0 = int(above[0])
            w = corr[i0:i0 + 2 * SPS + 1]
            pk = i0 + int(np.argmax(w))
            status, rate, payload, consumed = self._demod_from(pk)
            if status == "fail":
                self._drop(pk + len(self._pre))
            elif status == "more":
                # transmission longer than the buffered capture: wait
                # for more samples (bounded by a 40-frame cap)
                if len(self._bb) > pk + head + 40 * frame_samps:
                    self._drop(pk + len(self._pre))
                else:
                    break
            else:
                if payload is not None:
                    out.append((rate, payload))
                self._drop(consumed)
        return out

    def _drop(self, n: int) -> None:
        n = max(int(n), 1)
        self._bb = self._bb[n:]

    def _demod_from(self, sync_at: int):
        """sync_at: index (in _bb, unfiltered) of the A-sequence start.
        Returns (status, rate, payload|None, consumed_samples) with
        status in {"fail", "more", "done"}."""
        FAIL = ("fail", 0, None, 0)
        delay = len(_RRC) // 2
        sync_syms = SYNC_REPS * len(A_SEQ)
        # matched filter the whole remaining capture once
        x = np.convolve(self._bb, _RRC)[delay:delay + len(self._bb)]
        sym0 = sync_at + delay              # first sync symbol center
        navail = max((len(x) - sym0 - delay) // SPS, 0)
        sym = x[sym0 + SPS * np.arange(navail)]
        if len(sym) < sync_syms + RATE_REPS + BLOCK:
            return ("more", 0, None, 0)
        ref_sync = _psk8(np.tile(A_SEQ, SYNC_REPS))
        # carrier: phase slope across the two A-sequence copies
        wiped = sym[:sync_syms] * np.conj(ref_sync)
        h = sync_syms // 2
        r0, r1 = wiped[:h].sum(), wiped[h:].sum()
        if abs(r0) < 1e-9 or abs(r1) < 1e-9:
            return FAIL
        dphi = np.angle(r1 * np.conj(r0)) / h
        sym = sym * np.exp(-1j * (dphi * np.arange(len(sym))
                                  + np.angle(r0)))
        # sync quality gate
        q = np.abs(np.mean(sym[:sync_syms] * np.conj(ref_sync)))
        q /= np.sqrt(np.mean(np.abs(sym[:sync_syms]) ** 2)) + 1e-12
        if q < 0.5:
            return FAIL
        # rate tribits (majority over repetitions)
        rsyms = sym[sync_syms:sync_syms + RATE_REPS]
        tri = np.round(np.angle(rsyms) / (np.pi / 4)).astype(
            np.int64) % 8
        vals, counts = np.unique(tri, return_counts=True)
        rid = int(vals[np.argmax(counts)])
        if rid not in IDS_RATE:
            return FAIL
        rate = IDS_RATE[rid]
        mod, bps, rep = RATES[rate]
        # demod frames until the MPDU closes or probes die
        soft_all = []
        p = sync_syms + RATE_REPS
        nframe = BLOCKS_PER_FRAME * BLOCK
        ended = False
        while True:
            if p + nframe > len(sym):
                if not ended and len(soft_all) < 64:
                    return ("more", 0, None, 0)
                break
            fr, ok = self._eq_frame(sym[p:p + nframe])
            if not ok:
                ended = True
                break
            soft_all.append(self._demap(fr, mod))
            p += nframe
            bits = self._decode(np.concatenate(soft_all), rate)
            payload = parse_mpdu(bits)
            if payload is not None:
                return "done", rate, payload, sync_at + p * SPS
        if not soft_all:
            return FAIL
        bits = self._decode(np.concatenate(soft_all), rate)
        return "done", rate, parse_mpdu(bits), sync_at + p * SPS

    def _eq_frame(self, sym: np.ndarray):
        """LMS equalizer over one frame, adapting on probe symbols."""
        known = np.full(len(sym), -1, np.int64)
        for b in range(BLOCKS_PER_FRAME):
            lo = b * BLOCK + DATA_SYMS
            known[lo:lo + PROBE_SYMS] = SCRAMBLE[lo:lo + PROBE_SYMS]
        ref = _psk8(known)
        nt = self.eq_taps
        w = np.zeros(nt, np.complex128)
        w[nt // 2] = 1.0
        sym = sym / (np.sqrt(np.mean(np.abs(sym) ** 2)) + 1e-12)
        padded = np.concatenate([np.zeros(nt // 2, np.complex128), sym,
                                 np.zeros(nt // 2, np.complex128)])
        eq = np.zeros(len(sym), np.complex128)
        perr = []
        for _pass in range(2):
            errs = []
            for i in range(len(sym)):
                xv = padded[i:i + nt][::-1]
                y = w @ xv
                if _pass:
                    eq[i] = y
                if known[i] >= 0:
                    e = ref[i] - y
                    w += self.mu * e * np.conj(xv)
                    errs.append(abs(e) ** 2)
            perr = errs
        # anchor-interpolated residual phase (probe blocks)
        ai, ap = [], []
        for b in range(BLOCKS_PER_FRAME):
            lo = b * BLOCK + DATA_SYMS
            r = np.mean(ref[lo:lo + PROBE_SYMS]
                        * np.conj(eq[lo:lo + PROBE_SYMS]))
            if abs(r) > 1e-6:
                ai.append(lo + PROBE_SYMS / 2)
                ap.append(np.angle(r))
        if len(ap) >= 2:
            ph = np.interp(np.arange(len(sym)), ai, np.unwrap(ap))
            eq = eq * np.exp(1j * ph)
        return eq, (np.mean(perr) < 0.7 if perr else False)

    @staticmethod
    def _demap(eq: np.ndarray, mod: str) -> np.ndarray:
        d = []
        for b in range(BLOCKS_PER_FRAME):
            lo = b * BLOCK
            seg = eq[lo:lo + DATA_SYMS] * np.conj(
                _psk8(SCRAMBLE[lo:lo + DATA_SYMS]))
            d.append(seg)
        d = np.concatenate(d)
        conf = np.abs(d)
        if mod == "8psk":
            tri = np.round(np.angle(d) / (np.pi / 4)).astype(
                np.int64) % 8
            soft = np.zeros(len(d) * 3)
            soft[0::3] = np.where((tri >> 2) & 1, 1., -1.) * conf
            soft[1::3] = np.where((tri >> 1) & 1, 1., -1.) * conf
            soft[2::3] = np.where(tri & 1, 1., -1.) * conf
        elif mod == "qpsk":
            q = np.round((np.angle(d) % (2 * np.pi))
                         / (np.pi / 2)).astype(np.int64) % 4
            soft = np.zeros(len(d) * 2)
            soft[0::2] = np.where((q >> 1) & 1, 1., -1.) * conf
            soft[1::2] = np.where(q & 1, 1., -1.) * conf
        else:
            soft = -np.real(d)
        return deinterleave(soft)

    @staticmethod
    def _decode(soft: np.ndarray, rate: int) -> np.ndarray:
        mod, bps, rep = RATES[rate]
        if rep > 1:
            n = (len(soft) // rep) * rep
            soft = soft[:n].reshape(-1, rep).mean(axis=1)
        n = len(soft) - (len(soft) % 2)
        bits = viterbi_decode_k7(soft[:n], tail=False)
        return bits[:max(len(bits) - 6, 0)]


@ext_register
class HfdlExt(Extension):
    name = "HFDL"

    def start(self, **params):
        self.rx = HfdlRx()

    def process_block(self, taps) -> list:
        audio = host_column(taps.audio, self.rx_chan, np.float32)
        out = []
        for rate, payload in self.rx.feed(audio):
            out.append(("hfdl_mpdu",
                        f"{rate}|".encode() + payload.hex().encode()))
        return out
