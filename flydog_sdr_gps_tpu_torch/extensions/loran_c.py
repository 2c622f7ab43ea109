"""Loran_C extension — GRI-folded pulse-group scope.

Reference: `extensions/Loran_C/loran_c.cpp` (321 LoC).  Loran-C
chains transmit 100 kHz pulse groups repeating every GRI (group
repetition interval, expressed in units of 10 us, 4000..9999).  The
reference folds the demodulated envelope into one bucket per audio
sample of a GRI period (`samp_per_GRI = srate * GRI/1e5`,
`loran_c.cpp:31,85`), averages buckets with a selectable algorithm
(IIR / MMA / CMA, `loran_c.cpp:108-160`), and streams a 0..255-scaled
scope row to the client.  Two independent chains can be displayed.

Design: folding is a histogram over a per-sample bucket index —
done here with `np.add.at` on the (tiny) audio-rate block after the
device pipeline has produced the envelope; the expensive part (DDC to
the 100 kHz passband) is the shared channelizer.  A GRI *search*
utility folds the same capture at every candidate GRI in one
vectorized pass (reference has no search — operators type the GRI in).
"""

from __future__ import annotations

import numpy as np

from . import Extension, ext_register
from .taps import host_column

# Published GRIs of (historic + active) chains, for search().
KNOWN_GRIS = (4990, 5030, 5543, 5980, 5990, 6000, 6042, 6731, 6780,
              6931, 7001, 7430, 7499, 7950, 7960, 8000, 8290, 8390,
              8830, 8970, 9007, 9610, 9930, 9960)

AVG_IIR, AVG_MMA, AVG_CMA = 0, 1, 2
_AVG_NAMES = {"iir": AVG_IIR, "mma": AVG_MMA, "cma": AVG_CMA}


class _Chain:
    """One folded-average scope (the reference's per-'channel' state,
    `loran_c.cpp:29-41`)."""

    def __init__(self, fs: float, gri: int, avg_algo: int = AVG_IIR,
                 avg_param: float = 0.02, offset: int = 0):
        self.fs = fs
        self.avg_algo = avg_algo
        self.avg_param = avg_param
        self.offset = offset
        self.set_gri(gri)

    def set_gri(self, gri: int) -> None:
        self.gri = int(gri)
        self.samp_per_gri = self.fs * self.gri / 1e5
        self.nbucket = int(np.ceil(self.samp_per_gri))
        self.avg = np.zeros(self.nbucket, np.float64)
        self.navgs = 0

    def fold(self, env: np.ndarray, samp0: int) -> None:
        """Accumulate an envelope block starting at absolute sample
        index ``samp0`` into the GRI buckets."""
        idx = np.floor(np.fmod(
            np.arange(samp0, samp0 + len(env), dtype=np.float64)
            - self.offset, self.samp_per_gri)).astype(np.int64)
        idx[idx < 0] += self.nbucket
        if self.avg_algo == AVG_IIR:
            # per-bucket one-pole; applied blockwise: avg += a*(x-avg)
            upd = np.zeros(self.nbucket)
            cnt = np.zeros(self.nbucket)
            np.add.at(upd, idx, env)
            np.add.at(cnt, idx, 1.0)
            hit = cnt > 0
            mean = np.where(hit, upd / np.maximum(cnt, 1), 0.0)
            a = self.avg_param
            self.avg[hit] += a * (mean[hit] - self.avg[hit])
        else:
            upd = np.zeros(self.nbucket)
            cnt = np.zeros(self.nbucket)
            np.add.at(upd, idx, env)
            np.add.at(cnt, idx, 1.0)
            hit = cnt > 0
            mean = np.where(hit, upd / np.maximum(cnt, 1), 0.0)
            if self.avg_algo == AVG_MMA:
                n = min(self.navgs + 1, max(int(self.avg_param), 2))
                self.avg[hit] += (mean[hit] - self.avg[hit]) / n
            else:                       # CMA: true cumulative mean
                n = self.navgs + 1
                if n > max(int(self.avg_param), 1):
                    self.avg[:] = 0.0
                    self.navgs = n = 1
                self.avg[hit] += (mean[hit] - self.avg[hit]) / n
        self.navgs += 1

    def scope(self, width: int = 1024) -> np.ndarray:
        """0..255 scope row, resampled to ``width`` px
        (`loran_c.cpp:103-118`)."""
        mx = float(self.avg.max()) if self.nbucket else 0.0
        row = np.clip(self.avg, 0.0, mx)
        row = (255.0 * row / mx if mx > 0 else row)
        # drop-sample resize to the display width
        src = np.linspace(0, self.nbucket - 1, width).astype(np.int64)
        return row[src].astype(np.uint8)


def search_gri(env: np.ndarray, fs: float,
               candidates=KNOWN_GRIS) -> tuple[int, float]:
    """Fold a capture at every candidate GRI; return (best_gri, score).

    Score = peak/mean of the folded profile — a repeating pulse group
    only stacks coherently at its own GRI.
    """
    best, best_score = 0, 0.0
    for gri in candidates:
        ch = _Chain(fs, gri, AVG_CMA, avg_param=1e9)
        ch.fold(env, 0)
        prof = ch.avg
        m = prof.mean()
        score = float(prof.max() / m) if m > 0 else 0.0
        if score > best_score:
            best, best_score = gri, score
    return best, best_score


@ext_register
class LoranCExt(Extension):
    name = "Loran_C"

    def start(self, **params):
        self.fs = float(getattr(self.engine.params, "fs_out", 12000.0))
        self.samp = 0
        self.chains = [
            _Chain(self.fs, int(params.get("gri0", 6731))),
            _Chain(self.fs, int(params.get("gri1", 8000))),
        ]
        self._since_push = 0
        self._search_pending = False
        self._env_hist = np.zeros(0, np.float64)

    def command(self, cmd: dict) -> list:
        for k, v in cmd.items():
            if k.startswith("gri"):
                self.chains[int(k[3:])].set_gri(int(v))
            elif k.startswith("offset"):
                self.chains[int(k[6:])].offset = int(v)
            elif k.startswith("avg_algo"):
                ch = self.chains[int(k[8:])]
                ch.avg_algo = _AVG_NAMES.get(str(v), AVG_IIR)
                ch.navgs = 0
                ch.avg[:] = 0
            elif k == "search":
                self._search_pending = True
        return []

    def process_block(self, taps) -> list:
        audio = host_column(taps.audio, self.rx_chan, np.float64)
        env = np.abs(audio)
        for ch in self.chains:
            ch.fold(env, self.samp)
        self.samp += len(env)
        self._since_push += len(env)
        out = []
        if self._search_pending:
            # accumulate ~4 s of envelope, then fold at every known GRI
            self._env_hist = np.concatenate([self._env_hist, env])
            if len(self._env_hist) >= 4 * self.fs:
                gri, score = search_gri(self._env_hist, self.fs)
                out.append(("gri_found",
                            f"{gri} {score:.2f}".encode()))
                self._search_pending = False
                self._env_hist = np.zeros(0, np.float64)
        if self._since_push >= self.fs * 0.25:      # ~4 scope rows/s
            self._since_push = 0
            for i, ch in enumerate(self.chains):
                out.append((f"scope{i}", ch.scope().tobytes()))
        return out
