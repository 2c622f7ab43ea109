"""Noise blanking and noise reduction, channel-vectorized.

Port of :mod:`flydog_sdr_gps_tpu.ops.noise` (`rx/rx_sound.cpp:910-948`
dispatch): NB_STD and NB_WILD impulse blankers, spectral-subtraction NR
(subtraction or MMSE-LSA gain rule) and the LMS autonotch -> denoiser
chain.  The spectral-NR frame recurrences and the LMS chain are plain
PyTorch loops (frames, resp. samples): the receiver gates them off
unless a channel enables them, and their time-loop kernels are later
work.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .smeter import abs2


# ---------------------------------------------------------------------------
# impulse noise blankers (NB_STD, NB_WILD)
# ---------------------------------------------------------------------------

def _blank_mask(x: torch.Tensor, mavg: torch.Tensor, gate_mult: float,
                width: int, alpha: float):
    """Impulse mask dilated +-width samples, and the new magnitude mean."""
    mag = torch.sqrt(abs2(x))
    new_mavg = (1.0 - alpha) * mavg + alpha * torch.mean(mag, dim=0)
    thresh = torch.clamp(new_mavg, min=1e-9) * gate_mult
    hit = mag > thresh[None, :]
    n = hit.shape[0]
    pad = torch.zeros((width, hit.shape[1]), dtype=torch.bool,
                      device=x.device)
    h = torch.cat([pad, hit, pad])
    dil = hit
    for k in range(1, width + 1):
        dil = dil | h[width - k:width - k + n] | h[width + k:width + k + n]
    return dil, new_mavg


def noise_blanker(x: torch.Tensor, mavg: torch.Tensor,
                  gate_mult: float = 4.0, width: int = 7,
                  alpha: float = 0.02) -> tuple[torch.Tensor, torch.Tensor]:
    """NB_STD: zero a widened window around samples exceeding
    ``gate_mult`` x the running mean magnitude (CuteSDR ``CNoiseProc``).

    x: (N, C) complex64 pre-FIR IQ; mavg: (C,) float32.
    Returns (y, new_mavg).
    """
    dil, new_mavg = _blank_mask(x, mavg, gate_mult, width, alpha)
    return torch.where(dil, torch.zeros_like(x), x), new_mavg


def noise_blanker_wild(x: torch.Tensor, mavg: torch.Tensor,
                       gate_mult: float = 4.0, width: int = 7,
                       alpha: float = 0.02
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """NB_WILD: like :func:`noise_blanker` but bridges the blanked span
    by linear interpolation between the neighbouring good samples
    (`rx/Teensy/NB_Wild.cpp`).  Previous/next good indices come from a
    running max and a reversed running max (``torch.cummax``)."""
    dil, new_mavg = _blank_mask(x, mavg, gate_mult, width, alpha)
    n = x.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=x.device)[:, None]
    good = ~dil
    prev_i = torch.cummax(torch.where(good, idx, -1), dim=0).values
    next_i = -torch.cummax(
        torch.where(good, -idx, -(n + 1)).flip(0), dim=0).values.flip(0)
    prev_i = torch.clamp(prev_i, 0, n - 1)
    next_i = torch.clamp(next_i, 0, n - 1)
    span = torch.clamp(next_i - prev_i, min=1).to(torch.float32)
    frac = (idx - prev_i).to(torch.float32) / span

    def bridge(v):
        vp = torch.take_along_dim(v, prev_i, dim=0)
        vn = torch.take_along_dim(v, next_i, dim=0)
        return torch.where(dil, vp + (vn - vp) * frac, v)

    return torch.complex(bridge(x.real), bridge(x.imag)), new_mavg


# ---------------------------------------------------------------------------
# spectral-subtraction noise reduction (NR_SPECTRAL)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class SpectralNRParams:
    fft_size: int = 256
    hop: int = 128                 # 50% overlap, Hann analysis window
    smooth_alpha: float = 0.3      # psd pre-smoothing (frames)
    min_window: int = 8            # blocks of windowed-minimum tracking
    floor_bias: float = 2.2        # min-of-smoothed-psd -> mean bias
    over_subtract: float = 1.4
    gain_floor: float = 0.1
    gain_rule: str = "subtract"    # "subtract" | "mmse" (wdsp EMNR's
    dd_alpha: float = 0.96         #  MMSE-LSA w/ decision-directed SNR)


@dataclasses.dataclass
class SpectralNRState:
    in_tail: torch.Tensor         # (hop, C) input overlap
    out_tail: torch.Tensor        # (hop, C) overlap-add carry
    psd_smooth: torch.Tensor      # (fft/2+1, C) EMA-smoothed psd
    min_ring: torch.Tensor        # (min_window, fft/2+1, C) block minima
    xhat2: torch.Tensor           # (fft/2+1, C) prev clean-psd (MMSE)


def init_spectral_nr(params: SpectralNRParams, num_channels: int,
                     device: torch.device | str) -> SpectralNRState:
    hb = params.fft_size // 2 + 1
    f32 = dict(dtype=torch.float32, device=device)
    return SpectralNRState(
        in_tail=torch.zeros((params.hop, num_channels), **f32),
        out_tail=torch.zeros((params.hop, num_channels), **f32),
        psd_smooth=torch.full((hb, num_channels), 1e3, **f32),
        min_ring=torch.full((params.min_window, hb, num_channels), 1e3,
                            **f32),
        xhat2=torch.zeros((hb, num_channels), **f32),
    )


def _expint_e1(v: torch.Tensor) -> torch.Tensor:
    """Exponential integral E1(v), Abramowitz-Stegun 5.1.53/5.1.56."""
    small = (-torch.log(torch.clamp(v, min=1e-12)) - 0.57721566
             + v * (0.99999193
                    + v * (-0.24991055
                           + v * (0.05519968
                                  + v * (-0.00976004
                                         + v * 0.00107857)))))
    num = v * (v + 2.334733) + 0.250621
    den = v * (v + 3.330657) + 1.681534
    big = torch.exp(-v) / torch.clamp(v, min=1e-12) * num / den
    return torch.where(v <= 1.0, small, big)


def spectral_nr_block(params: SpectralNRParams, x: torch.Tensor,
                      state: SpectralNRState
                      ) -> tuple[torch.Tensor, SpectralNRState]:
    """Spectral subtraction over one block of real audio (N, C).

    N must be a multiple of ``hop``.  Output is delayed by one hop
    (overlap-add latency).
    """
    n, c = x.shape
    hop, fft = params.hop, params.fft_size
    if n % hop or fft != 2 * hop:
        raise ValueError(f"spectral NR needs N % {hop} == 0 and fft = 2*hop")
    xin = torch.cat([state.in_tail, x])
    nfr = n // hop
    frames = xin.unfold(0, fft, hop).transpose(1, 2)       # (nfr, fft, C)
    win = torch.as_tensor(np.hanning(fft + 1)[:fft].astype(np.float32),
                          device=x.device)
    spec = torch.fft.fft(frames * win[None, :, None], dim=1)
    spec = spec[:, :fft // 2 + 1]                           # one-sided
    psd = abs2(spec)
    # minimum statistics: EMA over frames, windowed minimum of block minima
    sm = state.psd_smooth
    sm_seq = []
    for i in range(nfr):
        sm = sm + params.smooth_alpha * (psd[i] - sm)
        sm_seq.append(sm)
    psd_smooth, sm_seq = sm, torch.stack(sm_seq)
    min_ring = torch.cat([state.min_ring[1:],
                          sm_seq.amin(dim=0)[None]])
    est_noise = params.floor_bias * min_ring.amin(dim=0)
    if params.gain_rule == "mmse":
        # Ephraim-Malah MMSE-LSA with decision-directed a-priori SNR
        lam = torch.clamp(est_noise, min=1e-12)
        gamma = torch.clamp(psd / lam[None], min=1e-6)
        a = float(np.float32(params.dd_alpha))
        xhat2 = state.xhat2
        gains = []
        for i in range(nfr):
            gam = gamma[i]
            xi = a * xhat2 / lam + (1 - a) * torch.clamp(gam - 1.0, min=0.0)
            xi = torch.clamp(xi, min=1e-6)
            v = torch.clamp(gam * xi / (1.0 + xi), 1e-6, 50.0)
            g = xi / (1.0 + xi) * torch.exp(0.5 * _expint_e1(v))
            g = torch.clamp(g, params.gain_floor, 1.0)
            xhat2 = (g ** 2) * gam * lam
            gains.append(g)
        g = torch.stack(gains)
    else:
        gain = torch.clamp(
            1.0 - params.over_subtract * est_noise[None]
            / torch.clamp(sm_seq, min=1e-12),
            min=params.gain_floor ** 2)
        g = torch.sqrt(gain)
        xhat2 = state.xhat2
    # one-sided shaped spectrum -> real frames (conjugate symmetry)
    out_frames = torch.fft.irfft(spec * g, n=fft, dim=1)
    out_frames = out_frames * win[None, :, None]
    # overlap-add (Hann^2 with 50% overlap sums to 1.5; normalize)
    y = torch.zeros((n + hop, c), dtype=x.dtype, device=x.device)
    for i in range(nfr):
        y[i * hop:i * hop + fft] += out_frames[i]
    y = y / 1.5
    out = y[:n].clone()
    out[:hop] += state.out_tail
    return out, SpectralNRState(in_tail=xin[-hop:], out_tail=y[n:],
                                psd_smooth=psd_smooth, min_ring=min_ring,
                                xhat2=xhat2)


# ---------------------------------------------------------------------------
# LMS autonotch -> denoiser chain (NR_ORIG semantics, `rx/kiwi/lms.cpp`)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class LmsParams:
    taps: int = 64
    delay: int = 16
    mu: float = 0.01               # adaptation rate (normalized)
    decay: float = 0.9999          # leakage
    notch: bool = False            # False: denoise (output = prediction)
                                   # True: autonotch (output = error)


@dataclasses.dataclass
class LmsState:
    weights: torch.Tensor          # (taps, C)
    line: torch.Tensor             # (taps + delay, C) delay line


def init_lms(params: LmsParams, num_channels: int,
             device: torch.device | str) -> LmsState:
    return LmsState(
        weights=torch.zeros((params.taps, num_channels), dtype=torch.float32,
                            device=device),
        line=torch.zeros((params.taps + params.delay, num_channels),
                         dtype=torch.float32, device=device),
    )


def lms_chain_block(notch_p: LmsParams, den_p: LmsParams,
                    x: torch.Tensor, st_notch: LmsState, st_den: LmsState,
                    en_notch: torch.Tensor, en_den: torch.Tensor
                    ) -> tuple[torch.Tensor, LmsState, LmsState]:
    """Autonotch -> denoiser chain, one loop over samples, per-channel
    gated (`rx/rx_sound.cpp:933-943`).  Disabled stages pass through and
    stop adapting."""
    def stage(w, line, xn, p, en, notch):
        ref = line[:w.shape[0]]
        pred = torch.sum(w * ref, dim=0)
        err = xn - pred
        norm = torch.sum(ref * ref, dim=0) + 1e-3
        w2 = p.decay * w + (p.mu / norm) * err[None, :] * ref
        w = torch.where(en[None, :], w2, w)
        line = torch.cat([line[1:], xn[None, :]])
        return w, line, torch.where(en, err if notch else pred, xn)

    wn, ln = st_notch.weights, st_notch.line
    wd, ld = st_den.weights, st_den.line
    y = torch.empty_like(x)
    for n in range(x.shape[0]):
        wn, ln, y1 = stage(wn, ln, x[n], notch_p, en_notch, True)
        wd, ld, y[n] = stage(wd, ld, y1, den_p, en_den, False)
    return y, LmsState(weights=wn, line=ln), LmsState(weights=wd, line=ld)
