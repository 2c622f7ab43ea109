"""FT8 extension — capture + device spectrogram + Costas sync.

Reference: `extensions/FT8/` (vendored ft8_lib + PSKReporter upload):
15-second cycles, 8-FSK at 6.25 baud, 7x7x7 Costas arrays at symbol
positions 0-6 / 36-42 / 72-78, LDPC(174,91) + CRC14 decode.

Port of :mod:`flydog_sdr_gps_tpu.extensions.ft8`: the symbol-rate
spectrogram (:func:`spectrogram`) is torch on the engine's device; the
Costas search, the tone log-likelihoods and the LDPC decode
(``ft8_decode``) are the reference's host code, copied line for line.
The capture is copied block by block into one buffer
(:class:`capture.Capture`) and goes to the device once a capture.
"""

from __future__ import annotations

import numpy as np
import torch

from . import Extension, ext_register
from .capture import Capture, SideStream, engine_device, on_device

FS_AUDIO = 12000.0
BAUD = 6.25
SPS = int(FS_AUDIO / BAUD)      # 1920 samples per symbol
NSYM = 79
COSTAS = np.array([3, 1, 4, 0, 6, 5, 2], np.int64)
COSTAS_POS = (0, 36, 72)
NFFT = 2048                     # 5.86 Hz bins ~ tone spacing 6.25 Hz


def spectrogram(audio: torch.Tensor, sps: int = SPS,
                nfft: int = NFFT) -> torch.Tensor:
    """audio (n,) float32 -> (n // sps, nfft // 2) float32 power: each
    symbol of ``sps`` samples zero-padded to ``nfft``, its DFT's first
    half, re^2 + im^2; on the audio's device."""
    nsym = audio.shape[0] // sps
    segs = audio[:nsym * sps].reshape(nsym, sps)
    if nsym == 0:                       # too short: no symbol, no row
        return torch.zeros((0, nfft // 2), device=audio.device)
    spec = torch.fft.rfft(segs, n=nfft, dim=1)[:, :nfft // 2]
    return torch.view_as_real(spec).square().sum(-1)


def costas_sync(power: np.ndarray, fmin_hz: float = 200.0,
                fmax_hz: float = 3000.0) -> list[dict]:
    """Search (time, base-freq) for the three Costas arrays.

    Tones are 6.25 Hz apart; at 5.86 Hz bins we map tone k of base bin
    f to bin round((f*5.86 + k*6.25)/5.86) — close enough at this
    resolution for sync detection (the reference's fine sync refines
    later).
    """
    nsym_have, nbins = power.shape
    if nsym_have < NSYM:
        return []
    bin_hz = FS_AUDIO / NFFT
    tone_bins = np.round(COSTAS * BAUD / bin_hz).astype(np.int64)
    b0, b1 = int(fmin_hz / bin_hz), int(fmax_hz / bin_hz)
    cands = []
    for dt in range(0, nsym_have - NSYM + 1):
        for f in range(b0, b1):
            score = 0.0
            total = 0.0
            for pos in COSTAS_POS:
                rows = power[dt + pos:dt + pos + 7]
                hit = rows[np.arange(7), f + tone_bins]
                score += float(hit.sum())
                total += float(rows[:, f:f + 8].sum())
            if total > 0:
                cands.append(dict(dt=dt, bin=f,
                                  freq=f * bin_hz,
                                  sync=score / total * 8.0 / 1.0))
    cands.sort(key=lambda c: -c["sync"])
    # de-duplicate nearby bins
    out, seen = [], set()
    for c in cands:
        key = (c["dt"], c["bin"] // 2)
        if key not in seen:
            seen.add(key)
            out.append(c)
        if len(out) >= 10:
            break
    return out


def tone_logls(power: np.ndarray, cand: dict) -> np.ndarray:
    """(58, 8) data-symbol tone powers for one synced candidate."""
    bin_hz = FS_AUDIO / NFFT
    tone_bins = np.round(np.arange(8) * BAUD / bin_hz).astype(np.int64)
    rows = []
    for i in range(NSYM):
        if i in range(7) or i in range(36, 43) or i in range(72, 79):
            continue
        p = power[cand["dt"] + i]
        rows.append(p[cand["bin"] + tone_bins])
    return np.asarray(rows, np.float32)


@ext_register
class Ft8Ext(Extension):
    name = "FT8"

    CAPTURE_S = 13.5      # signal portion of the 15 s cycle

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
            power = spectrogram(on_device(audio, dev)).cpu().numpy()
        cands = costas_sync(power)
        self.results = [(c, tone_logls(power, c)) for c in cands[:5]]
        out = []
        best = cands[0] if cands else {}
        out.append(("ft8_status",
                    (f"cands={len(cands)} "
                     f"best_freq={best.get('freq', 0):.1f} "
                     f"best_sync={best.get('sync', 0):.2f}").encode()))
        for spot in self.decode_candidates():
            out.append(("ft8_decode",
                        (f"{spot['text']} {spot['freq']:.1f}").encode()))
        return out

    def decode_candidates(self, min_sync: float = 1.5) -> list[dict]:
        """LDPC+CRC decode of synced candidates -> message spots."""
        from . import ft8_decode
        spots, seen = [], set()
        for cand, powers in self.results:
            if cand["sync"] < min_sync:
                continue
            llrs = ft8_decode.tone_powers_to_llrs(powers)
            msg = ft8_decode.decode_llrs(llrs)
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
