"""FT4 extension — 4-GFSK digital mode sharing FT8's LDPC/CRC stack.

Reference: `extensions/FT8/ft8_lib` decodes both FT8 and FT4
(`ft8/constants.c`, `ft8/encode.c:127-194`): FT4 is 105 symbols in a
7.5 s slot at 1/0.048 s = 20.83 baud, 4-GFSK with Gray map
{0,1,3,2}, four 4-symbol Costas groups at symbol positions 1/34/67/100
plus ramp symbols at 0/104, and the same LDPC(174,91)+CRC14 coding as
FT8 — with the 77-bit payload whitened by a fixed XOR sequence before
the CRC (to avoid long zero runs on CQ messages).

Port of :mod:`flydog_sdr_gps_tpu.extensions.ft4`: the spectrogram is
FT8's :func:`ft8.spectrogram` at SPS=576, NFFT=1024 on the engine's
device; the Costas search, the exact 4-tone matched-filter demod and
the LDPC decode are the reference's host code, copied line for line.
"""

from __future__ import annotations

import numpy as np
import torch

from . import Extension, ext_register
from .capture import Capture, SideStream, engine_device, on_device
from .ft8 import spectrogram as _ft8_spectrogram

FS_AUDIO = 12000.0
BAUD = 1.0 / 0.048              # 20.833 baud; tone spacing = baud
SPS = int(FS_AUDIO * 0.048)     # 576 samples per symbol
NSYM = 105
SYNC_POS = (1, 34, 67, 100)
COSTAS4 = np.array([[0, 1, 3, 2],
                    [1, 0, 2, 3],
                    [2, 3, 1, 0],
                    [3, 2, 0, 1]], np.int64)
GRAY4 = np.array([0, 1, 3, 2], np.int64)      # bits2 -> tone
# whitening: the 77 payload bits XOR this sequence (ft8_lib
# kFT4_XOR_sequence, 10 bytes MSB-first, top 77 bits)
_XOR_BYTES = bytes((0x4A, 0x5E, 0x89, 0xB4, 0xB0,
                    0x8A, 0x79, 0x55, 0xBE, 0x28))
XOR77 = np.unpackbits(np.frombuffer(_XOR_BYTES, np.uint8))[:77]

DATA_POS = tuple(i for i in range(NSYM)
                 if i not in (0, NSYM - 1)
                 and not any(p <= i < p + 4 for p in SYNC_POS))
assert len(DATA_POS) == 87

NFFT = 1024                     # 11.72 Hz bins for the sync search


def encode_tones(payload77: np.ndarray) -> np.ndarray:
    """77 payload bits -> 105 FT4 channel tones (0..3)."""
    from . import ft8_decode
    white = np.asarray(payload77, np.uint8) ^ XOR77
    msg91 = ft8_decode.add_crc(white)
    cw = ft8_decode.ldpc_encode(msg91)
    tones = np.zeros(NSYM, np.uint8)
    for g, p in enumerate(SYNC_POS):
        tones[p:p + 4] = COSTAS4[g]
    for k, i in enumerate(DATA_POS):
        bits2 = (int(cw[2 * k]) << 1) | int(cw[2 * k + 1])
        tones[i] = GRAY4[bits2]
    return tones


def spectrogram(audio: torch.Tensor) -> torch.Tensor:
    """audio (n,) float32 -> (n // 576, 512) float32 symbol powers."""
    return _ft8_spectrogram(audio, SPS, NFFT)


def costas_sync(power: np.ndarray, fmin_hz: float = 200.0,
                fmax_hz: float = 3000.0) -> list[dict]:
    """Search (time, base freq) for the four Costas-4 groups."""
    nsym_have, _ = power.shape
    if nsym_have < NSYM:
        return []
    bin_hz = FS_AUDIO / NFFT
    b0, b1 = int(fmin_hz / bin_hz), int(fmax_hz / bin_hz)
    tone_bin = np.round(np.arange(4) * BAUD / bin_hz).astype(np.int64)
    cands = []
    for dt in range(0, nsym_have - NSYM + 1):
        for f in range(b0, b1):
            score = total = 0.0
            for g, pos in enumerate(SYNC_POS):
                rows = power[dt + pos:dt + pos + 4]
                hit = rows[np.arange(4), f + tone_bin[COSTAS4[g]]]
                score += float(hit.sum())
                total += float(rows[:, f:f + tone_bin[-1] + 2].sum())
            if total > 0:
                cands.append(dict(dt=dt, bin=f, freq=f * bin_hz,
                                  sync=score / total * 4.0))
    cands.sort(key=lambda c: -c["sync"])
    out, seen = [], set()
    for c in cands:
        key = (c["dt"], c["bin"] // 2)
        if key not in seen:
            seen.add(key)
            out.append(c)
        if len(out) >= 10:
            break
    return out


def matched_tone_powers(audio: np.ndarray, cand: dict,
                        df_hz: float = 0.0) -> np.ndarray:
    """(87, 4) exact matched-filter tone powers for one candidate."""
    f0 = cand["freq"] + df_hz
    n0 = cand["dt"] * SPS
    t = np.arange(SPS) / FS_AUDIO
    mf = np.exp(-2j * np.pi * np.outer(
        f0 + np.arange(4) * BAUD, t))             # (4, SPS)
    out = np.zeros((len(DATA_POS), 4))
    for k, i in enumerate(DATA_POS):
        seg = audio[n0 + i * SPS:n0 + (i + 1) * SPS]
        if len(seg) < SPS:
            break
        out[k] = np.abs(mf @ seg) ** 2
    return out


def tone_powers_to_llrs(p: np.ndarray) -> np.ndarray:
    """(87, 4) tone powers -> (174,) bit LLRs (positive = bit 1)."""
    lp = np.log(np.maximum(np.asarray(p, np.float64), 1e-12))
    llrs = np.zeros(174)
    for b in range(2):
        ones = [GRAY4[t] for t in range(4) if (t >> (1 - b)) & 1]
        zeros = [GRAY4[t] for t in range(4) if not (t >> (1 - b)) & 1]
        llrs[b::2] = (np.max(lp[:, ones], axis=1)
                      - np.max(lp[:, zeros], axis=1))
    return llrs


def decode_llrs(llrs174: np.ndarray):
    """LLRs -> Ft8Message (after CRC + de-whitening) or None."""
    from . import ft8_decode
    cw = ft8_decode.bp_decode(np.asarray(llrs174))
    if cw is None:
        return None
    msg91 = cw[:91]
    if not ft8_decode.check_crc(msg91):
        return None
    return ft8_decode.unpack_payload(msg91[:77] ^ XOR77)


@ext_register
class Ft4Ext(Extension):
    name = "FT4"

    CAPTURE_S = 6.5       # signal portion of the 7.5 s cycle

    def start(self, **params):
        self._capture = Capture()
        self._side = SideStream()
        self.capture_samples = int(self.CAPTURE_S * FS_AUDIO)
        self.results = []

    @property
    def _samples(self) -> int:
        return self._capture.samples

    def process_block(self, taps) -> list:
        a = taps.audio[:, self.rx_chan]
        audio = self._capture.add(a, self.capture_samples)
        if audio is None:
            return []
        dev = engine_device(self.engine, a)
        with self._side.on(dev, after_current=isinstance(audio, torch.Tensor)):
            x = on_device(audio, dev)
            power = spectrogram(x).cpu().numpy()
            host_audio = np.asarray(x.cpu().numpy(), np.float64)
        cands = costas_sync(power)
        self.results = [(c, host_audio) for c in cands[:5]]
        out = []
        best = cands[0] if cands else {}
        out.append(("ft4_status",
                    (f"cands={len(cands)} "
                     f"best_freq={best.get('freq', 0):.1f} "
                     f"best_sync={best.get('sync', 0):.2f}").encode()))
        for spot in self.decode_candidates():
            out.append(("ft4_decode",
                        (f"{spot['text']} {spot['freq']:.1f}").encode()))
        return out

    def decode_candidates(self, min_sync: float = 1.2) -> list[dict]:
        """Matched-filter demod + LDPC decode of synced candidates."""
        spots, seen = [], set()
        for cand, audio in self.results:
            if cand["sync"] < min_sync:
                continue
            msg = None
            for df in (0.0, -5.86, 5.86):     # half-bin freq refine
                p = matched_tone_powers(audio, cand, df)
                msg = decode_llrs(tone_powers_to_llrs(p))
                if msg is not None:
                    break
            if msg is None:
                continue
            text = " ".join(x for x in (msg.call_to, msg.call_de,
                                        msg.extra) if x)
            if text in seen:
                continue
            seen.add(text)
            spots.append(dict(text=text, freq=cand["freq"],
                              sync=cand["sync"]))
        return spots
