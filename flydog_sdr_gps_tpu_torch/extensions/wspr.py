"""WSPR extension — capture + device front end + candidates.

Reference: `extensions/wspr/` (K9AN/WSJT wsprd port): per channel, a
2-minute 12 kHz capture is decimated to 375 Hz, searched for 4-FSK
candidates by sync-vector correlation over a (frequency x time-offset)
plane, then Fano/Jelinek sequential decoding of the K=32 r=1/2
convolutional code in a forked process (`wspr_main.cpp:473-480`).

Port of :mod:`flydog_sdr_gps_tpu.extensions.wspr`.  The front end
(:func:`frontend`: mix, decimate by 32, symbol spectra) is torch on the
engine's device; the candidate search, the fine refinement and the
decode are the reference's host code, copied line for line.  The
capture is copied block by block into one buffer
(:class:`capture.Capture`), never kept as views of the taps, and goes
to the device once a capture.

The 162-chip sync vector is the public WSPR protocol constant
(pr3, `extensions/wspr/wspr.cpp:31-40`, identical in every WSPR
implementation).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import filters
from ..ops.channelizer import frame
from . import Extension, ext_register
from .capture import Capture, SideStream, engine_device, on_device

# WSPR protocol constants
FS_AUDIO = 12000.0
FS_WSPR = 375.0           # = 12000 / 32
DECIM = 32
NSYM = 162
SPS = 256                 # samples per symbol at 375 Hz
TONE_SPACING = FS_WSPR / SPS            # 1.4648 Hz
DIAL_OFFSET = 1500.0      # audio center of the 200 Hz WSPR band
CAPTURE_S = 114.0         # reference captures ~114 s of signal

SYNC = np.array([
    1,1,0,0,0,0,0,0,1,0,0,0,1,1,1,0,0,0,1,0,
    0,1,0,1,1,1,1,0,0,0,0,0,0,0,1,0,0,1,0,1,
    0,0,0,0,0,0,1,0,1,1,0,0,1,1,0,1,0,0,0,1,
    1,0,1,0,0,0,0,1,1,0,1,0,1,0,1,0,1,0,0,1,
    0,0,1,0,1,1,0,0,0,1,1,0,1,0,1,0,0,0,1,0,
    0,0,0,0,1,0,0,1,0,0,1,1,1,0,1,1,0,0,1,1,
    0,1,0,0,0,1,1,1,0,0,0,0,0,1,0,1,0,0,1,1,
    0,0,0,0,0,0,0,1,1,0,1,0,1,1,0,0,0,1,1,0,
    0,0], np.float32)


# the mixer's phase step in float32: the reference writes
# (i / float32(12000)) * float32(2*pi*1500) and its compiler folds the
# two constants into one product, float32(2*pi*1500/12000) = pi/4, so
# the phase is float32(i) * float32(pi/4) rounded once.  Late in a 114 s
# capture the phase is ~1.07e6 rad, where a float32 ulp is 0.0625 rad:
# the baseband carries that quantisation, and the port makes the same
# float32 phases (tests/test_torch_extensions.py).
MIX_STEP = np.float32(np.float32(2 * np.pi * DIAL_OFFSET)
                      / np.float32(FS_AUDIO))
FRONTEND_TAPS = filters.kaiser_lowpass(FS_AUDIO, 150.0, 210.0, 60.0,
                                       numtaps=DECIM * 8)


def frontend(audio: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """audio (n,) float32 -> (power (n // 32 // 256, 256) float32 tone
    powers, fftshifted; the 375 Hz baseband (n // 32,) complex64), on
    the audio's device.  After the shift bin i is the audio frequency
    DIAL_OFFSET + (i - SPS/2) * TONE_SPACING; the baseband is for the
    host's fine (freq, time, drift) refinement."""
    dev = audio.device
    n = audio.shape[0]
    ang = torch.arange(n, dtype=torch.float32, device=dev) \
        * torch.tensor(MIX_STEP, device=dev)
    zr = audio * torch.cos(ang)
    zi = -audio * torch.sin(ang)
    # polyphase decimate by 32 via framing matmul
    hh = torch.as_tensor(FRONTEND_TAPS, dtype=torch.float32, device=dev)
    m = len(FRONTEND_TAPS) // DECIM
    pad = torch.zeros((m - 1) * DECIM, dtype=torch.float32, device=dev)
    k = n // DECIM
    fr = frame(torch.cat([pad, zr])[:(k + m - 1) * DECIM], DECIM, m)
    fi = frame(torch.cat([pad, zi])[:(k + m - 1) * DECIM], DECIM, m)
    b = torch.complex(fr @ hh, fi @ hh)         # (k,) at 375 Hz
    # symbol-rate spectrogram: 162 symbols x 256-sample DFT
    nsym_have = k // SPS
    segs = b[:nsym_have * SPS].reshape(nsym_have, SPS)
    spec = torch.fft.fft(segs, dim=1) if nsym_have else segs   # (0, 256)
    spec = torch.fft.fftshift(spec, dim=1)
    power = torch.view_as_real(spec).square().sum(-1)   # re^2 + im^2
    return power, b


def sync_correlate(power: np.ndarray, max_dt_sym: int = 4
                   ) -> list[dict]:
    """Host: correlate the spectrogram against the sync vector.

    power: (nsym_have, 256) tone powers.  WSPR tone k of a candidate
    at base bin f is bin (f + 2*sync + 2*data? no: tones are
    f + {0..3} * 1 bin at this resolution); sync bit = tone LSB.
    Correlation metric per (f, dt): sum over symbols of
    +-(p(f+1bin...)-...) per the reference's `ss` metric
    (`wspr.cpp:160-174`).
    """
    nsym_have, nbins = power.shape
    if nsym_have < NSYM:
        return []
    cands = []
    sync_pm = 2 * SYNC - 1
    half = SPS // 2
    # WSPR band: +-100 Hz around the dial offset -> bins half-68..half+68
    for dt in range(0, min(max_dt_sym, nsym_have - NSYM) + 1):
        p = power[dt:dt + NSYM]                # (162, 256)
        # tones occupy 4 adjacent bins starting at f
        for f in range(half - 75, half + 72):
            p0, p1 = p[:, f], p[:, f + 1]
            p2, p3 = p[:, f + 2], p[:, f + 3]
            ss = float(np.sum(sync_pm * ((p1 + p3) - (p0 + p2))))
            pow_tot = float(np.sum(p0 + p1 + p2 + p3))
            if pow_tot > 0:
                cands.append(dict(
                    bin=f, dt=dt, sync=ss / pow_tot,
                    freq=DIAL_OFFSET + (f - half) * TONE_SPACING))
    cands.sort(key=lambda c: -c["sync"])
    return cands[:20]


def soft_symbols(power: np.ndarray, cand: dict) -> np.ndarray:
    """Soft data symbols for one candidate (`wspr.cpp:168-173`):
    data bit metric = p3-p1 when sync=1 else p2-p0."""
    p = power[cand["dt"]:cand["dt"] + NSYM]
    f = cand["bin"]
    p0, p1 = p[:, f], p[:, f + 1]
    p2, p3 = p[:, f + 2], p[:, f + 3]
    return np.where(SYNC == 1, p3 - p1, p2 - p0).astype(np.float32)


# ---------------------------------------------------------------------------
# fine candidate refinement (the wsprd `sync_and_demodulate` analogue,
# `extensions/wspr/wspr.cpp` mode 0/1/2 passes): the coarse spectrogram
# grid is 1 tone bin x 1 symbol; a real signal sits between grid points
# and drifts, so each candidate is refined by maximizing the sync
# metric over (freq offset, symbol timing, linear drift) with 4-tone
# matched filters on the 375 Hz baseband.
# ---------------------------------------------------------------------------

def tone_powers(z375: np.ndarray, f0_hz: float, start_samp: int,
                drift_hz: float = 0.0) -> np.ndarray | None:
    """(NSYM, 4) matched-filter tone powers from the 375 Hz baseband.

    ``f0_hz``: tone-0 frequency relative to the baseband center (the
    spectrogram's DIAL_OFFSET); ``drift_hz``: total linear frequency
    change over the 162-symbol transmission.
    """
    n = NSYM * SPS
    if start_samp < 0 or start_samp + n > len(z375):
        return None
    seg = z375[start_samp:start_samp + n]
    t = np.arange(n) / FS_WSPR
    inst = f0_hz + drift_hz * (t / t[-1] - 0.5)
    ph = 2 * np.pi * np.cumsum(inst) / FS_WSPR
    base = seg * np.exp(-1j * ph)
    out = np.empty((NSYM, 4))
    for m in range(4):
        mixed = (base * np.exp(-2j * np.pi * (m * TONE_SPACING) * t)
                 ).reshape(NSYM, SPS)
        out[:, m] = np.abs(mixed.sum(axis=1)) ** 2
    return out


def _sync_metric(p: np.ndarray) -> float:
    s = 2.0 * SYNC - 1.0
    return float(np.sum(s * ((p[:, 1] + p[:, 3]) - (p[:, 0] + p[:, 2])))
                 / max(np.sum(p), 1e-12))


def refine_candidate(z375: np.ndarray, cand: dict,
                     search_drift: bool = True) -> dict | None:
    """Fine (freq, time, drift) search around a coarse candidate.

    Returns the refined candidate with normalized soft data symbols
    under ``soft`` (per-symbol power normalization caps the influence
    of symbols hit by overlapping transmissions), or None if the
    transmission window does not fit in the capture.
    """
    half = SPS // 2
    f_base = (cand["bin"] - half) * TONE_SPACING
    s_base = cand["dt"] * SPS
    best = None
    for df in np.arange(-0.75, 0.76, TONE_SPACING / 8.0):
        for ds in range(-SPS, SPS + 1, SPS // 8):
            p = tone_powers(z375, f_base + df, s_base + ds)
            if p is None:
                continue
            m = _sync_metric(p)
            if best is None or m > best[0]:
                best = (m, df, ds, 0.0, p)
    if best is None:
        return None
    if search_drift:
        m0, df0, ds0 = best[0], best[1], best[2]
        for drift in np.arange(-4.0, 4.01, 0.5):
            if drift == 0.0:
                continue
            p = tone_powers(z375, f_base + df0, s_base + ds0, drift)
            if p is None:
                continue
            m = _sync_metric(p)
            if m > best[0]:
                best = (m, df0, ds0, float(drift), p)
    m, df, ds, drift, p = best
    soft = np.where(SYNC == 1, p[:, 3] - p[:, 1], p[:, 2] - p[:, 0])
    soft = (soft / (p.sum(axis=1) + 1e-12)).astype(np.float32)
    out = dict(cand)
    out.update(sync=m, drift=drift,
               freq=DIAL_OFFSET + f_base + df,
               dt_s=(s_base + ds) / FS_WSPR, soft=soft)
    return out


@ext_register
class WsprExt(Extension):
    name = "wspr"

    def start(self, **params):
        self._capture = Capture()
        self._side = SideStream()
        self.capture_samples = int(CAPTURE_S * FS_AUDIO)
        self.results = []
        # capture-cycle alignment (the reference starts WSPR captures
        # at even UTC minutes, `extensions/wspr/wspr_main.cpp`; the
        # framework's timebase is stream time): wait for the start of
        # a 120 s cycle before capturing, so a transmission that
        # begins on-cycle lands whole inside the 114 s window.  A
        # scene source exposes its true cycle via fsk_cycle_pos_s.
        self.align = bool(params.get("align", True))
        self._waiting = self.align

    @property
    def _samples(self) -> int:
        return self._capture.samples

    def _cycle_pos(self, taps) -> tuple[float, float]:
        # at the block's own stamp where the taps carry one (the
        # server's, whose fan-out may run beside the engine's next
        # step), else at the engine's and the source's clocks now
        stamp = getattr(taps, "stamp", None)
        src = getattr(self.engine, "source", None)
        fn = getattr(src, "fsk_cycle_pos_s", None)
        if fn is not None and getattr(src, "_fsk", None):
            return fn() if stamp is None else fn(ticks=stamp[0])
        ticks = (getattr(self.engine, "block_ticks", 0) if stamp is None
                 else stamp[0])
        clk = getattr(getattr(self.engine, "params", None),
                      "adc_clock", None)
        if clk is None:
            return 0.0, 120.0           # fake engine: capture now
        return (ticks / clk) % 120.0, 120.0

    def process_block(self, taps) -> list:
        if self._waiting:
            pos, _cyc = self._cycle_pos(taps)
            p = self.engine.params
            block_s = (getattr(p, "audio_block", 128)
                       / getattr(p, "fs_out", FS_AUDIO))
            if pos > 2.0 * block_s:
                return []               # mid-cycle: keep waiting
            self._waiting = False
        a = taps.audio[:, self.rx_chan]
        audio = self._capture.add(a, self.capture_samples)
        if audio is None:
            return []
        self._waiting = self.align      # re-align for the next cycle
        dev = engine_device(self.engine, a)
        with self._side.on(dev, after_current=isinstance(audio, torch.Tensor)):
            power, z = frontend(on_device(audio, dev))
            power, z = power.cpu().numpy(), z.cpu()
        z375 = z.real.numpy() + 1j * z.imag.numpy()
        cands = sync_correlate(
            power, max_dt_sym=max(power.shape[0] - NSYM, 0))
        self.results = []
        for c in cands[:5]:
            r = refine_candidate(z375, c)
            if r is not None:
                self.results.append((r, r["soft"]))
            else:
                self.results.append((c, soft_symbols(power, c)))
        out = []
        best = cands[0] if cands else {}
        out.append(("wspr_status",
                    (f"cands={len(cands)} "
                     f"best_freq={best.get('freq', 0):.2f} "
                     f"best_sync={best.get('sync', 0):.3f}").encode()))
        for spot in self.decode_candidates():
            out.append(("wspr_decode",
                        (f"{spot['callsign']} {spot['grid']} "
                         f"{spot['dbm']} {spot['freq']:.2f}").encode()))
        return out

    def decode_candidates(self, min_sync: float = 0.15) -> list[dict]:
        """Run the sequential decoder on the synced candidates; returns
        spots [{'callsign','grid','dbm','freq','sync'}, ...]."""
        from . import wspr_decode
        spots = []
        seen = set()
        for cand, soft in self.results:
            if cand["sync"] < min_sync:
                continue
            msg = wspr_decode.decode_soft_symbols(soft)
            if msg is None:
                continue
            key = (msg.callsign, msg.grid)
            if key in seen:
                continue
            seen.add(key)
            spots.append(dict(callsign=msg.callsign, grid=msg.grid,
                              dbm=msg.dbm, freq=cand["freq"],
                              sync=cand["sync"]))
        return spots
