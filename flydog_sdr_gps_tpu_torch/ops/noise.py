"""Noise blanking and noise reduction, channel-vectorized.

Port of :mod:`flydog_sdr_gps_tpu.ops.noise` (`rx/rx_sound.cpp:910-948`
dispatch): NB_STD and NB_WILD impulse blankers, spectral-subtraction NR
(subtraction or MMSE-LSA gain rule) and the LMS autonotch -> denoiser
chain.  The LMS chain is sequential in time; the reference runs it as a
``lax.scan`` (`noise.py:296`).  Here it is :func:`lms_chain_block`: the
CUDA kernel ``lms_chain_f32`` (``csrc/lms.cu``, eight lanes a channel)
for a CUDA tensor, its plain PyTorch loop for a tensor on the CPU.  The
spectral-NR frame recurrences (the reference's scans at `noise.py:150`
and `:172`) are :func:`spectral_nr_gains`: the CUDA kernel
``spectral_nr_c64`` (``csrc/spectral_nr.cu``, a thread a bin and
channel) for a CUDA tensor, its plain PyTorch loops over the frames of a
block (16 at audio_block=2048) for a tensor on the CPU; they run only
when a channel enables spectral NR.  The one-stage line enhancer
:func:`lms_block` (the reference's ``lms_block``) is one stage of that
chain: on the card it launches ``lms_chain_f32`` with the other stage
off.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import _build
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


def spectral_nr_gains_plain(params: SpectralNRParams, spec: torch.Tensor,
                            state: SpectralNRState):
    """Plain version: the frame recurrences as loops over the frames.

    spec: (nfr, fft/2+1, C) complex64, the block's one-sided spectra.
    Returns (spec * gain, psd_smooth, min_ring, xhat2).
    """
    nfr = spec.shape[0]
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
    return spec * g, psd_smooth, min_ring, xhat2


def spectral_nr_gains(params: SpectralNRParams, spec: torch.Tensor,
                      state: SpectralNRState):
    """The frame recurrences of spectral NR over one block's spectra
    (nfr, fft/2+1, C) complex64: the PSD's EMA, its block minimum and
    the ring of block minima, the noise estimate, and each frame's gain
    by ``params.gain_rule``.  Returns (spec * gain, psd_smooth,
    min_ring, xhat2), the state's fields new tensors (xhat2 is the
    state's own under the "subtract" rule, which does not advance it).

    CPU tensors run the plain version; CUDA tensors the kernel
    ``spectral_nr_c64``, which reads ``spec`` with its bins adjacent, as
    ``torch.fft`` leaves them (any channel and frame stride; another
    layout is copied into that one first), returns spec * gain in that
    layout, and needs the state's fields contiguous float32 on the same
    card.
    """
    if spec.device.type == "cpu":
        return spectral_nr_gains_plain(params, spec, state)
    _build.require_cuda(spec, "spectral_nr_gains")
    hb = params.fft_size // 2 + 1
    mw = params.min_window
    if spec.dtype != torch.complex64 or spec.dim() != 3 or \
            spec.shape[1] != hb or spec.shape[0] < 1:
        raise ValueError(f"spectral_nr_gains: spec must be complex64 (nfr, "
                         f"{hb}, C), got {spec.dtype} {tuple(spec.shape)}")
    nfr, _, c = spec.shape
    if spec.stride(1) != 1:
        spec = spec.transpose(1, 2).contiguous().transpose(1, 2)
    for name, shape in (("psd_smooth", (hb, c)), ("min_ring", (mw, hb, c)),
                        ("xhat2", (hb, c))):
        v = getattr(state, name)
        if v.device != spec.device or v.dtype != torch.float32 or \
                tuple(v.shape) != shape or not v.is_contiguous():
            raise ValueError(f"spectral_nr_gains: state.{name} must be a "
                             f"contiguous {shape} float32 tensor on "
                             f"{spec.device}, got {v.dtype} "
                             f"{tuple(v.shape)} on {v.device}")
    mmse = params.gain_rule == "mmse"
    out = torch.empty((nfr, c, hb), dtype=torch.complex64, device=spec.device)
    sm = torch.empty_like(state.psd_smooth)
    ring = torch.empty_like(state.min_ring)
    xhat2 = torch.empty_like(state.xhat2) if mmse else state.xhat2
    f32 = np.float32
    # the constants as the plain version's operations take them: a Python
    # float meets a float32 tensor as float32; (1 - a) is taken in double
    a = float(f32(params.dd_alpha))
    stream = torch.cuda.current_stream(spec.device).cuda_stream
    err = _build.lib().spectral_nr_c64(
        spec.data_ptr(), spec.stride(0), spec.stride(2), out.data_ptr(),
        state.psd_smooth.data_ptr(), sm.data_ptr(),
        state.min_ring.data_ptr(), ring.data_ptr(), state.xhat2.data_ptr(),
        xhat2.data_ptr(), nfr, hb, c, mw, int(mmse),
        f32(params.smooth_alpha), f32(params.floor_bias),
        f32(params.over_subtract), f32(params.gain_floor ** 2),
        f32(params.gain_floor), f32(a), f32(1 - a), stream)
    _build.check(err, "spectral_nr_c64")
    _build.count_launch(spectral_nr_gains)
    return out.transpose(1, 2), sm, ring, xhat2


spectral_nr_gains.launches = 0


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add of (nfr, 2*hop, C) frames at a hop of ``hop``:
    ((nfr + 1) * hop, C).  Two strided slice-adds onto zeros; each
    output sample is the same one addition as in a loop over frames
    (a + b = b + a exactly), so the result is the loop's to the bit."""
    nfr, fft, c = frames.shape
    if fft != 2 * hop:
        raise ValueError(f"overlap_add: frames of {fft}, hop {hop}")
    y = torch.zeros((nfr + 1, hop, c), dtype=frames.dtype,
                    device=frames.device)
    y[:nfr] += frames[:, :hop]
    y[1:] += frames[:, hop:]
    return y.reshape((nfr + 1) * hop, c)


@functools.lru_cache(maxsize=None)
def _hann(fft: int, device: torch.device) -> torch.Tensor:
    """The periodic Hann window of ``fft`` points on ``device``, made once
    (a constant of the block program, not a copy a block)."""
    return torch.as_tensor(np.hanning(fft + 1)[:fft].astype(np.float32),
                           device=device)


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
    frames = xin.unfold(0, fft, hop).transpose(1, 2)       # (nfr, fft, C)
    win = _hann(fft, x.device)
    spec = torch.fft.fft(frames * win[None, :, None], dim=1)
    spec = spec[:, :fft // 2 + 1]                           # one-sided
    shaped, psd_smooth, min_ring, xhat2 = spectral_nr_gains(params, spec,
                                                            state)
    # one-sided shaped spectrum -> real frames (conjugate symmetry)
    out_frames = torch.fft.irfft(shaped, n=fft, dim=1)
    out_frames = out_frames * win[None, :, None]
    # overlap-add (Hann^2 with 50% overlap sums to 1.5; normalize)
    y = overlap_add(out_frames.to(x.dtype), hop)
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


def lms_block_plain(params: LmsParams, x: torch.Tensor, state: LmsState
                    ) -> tuple[torch.Tensor, LmsState]:
    """Plain version of :func:`lms_block`: the reference scan step as a
    loop over samples."""
    w, line = state.weights, state.line
    y = torch.empty_like(x)
    for n in range(x.shape[0]):
        ref = line[:params.taps]
        pred = torch.sum(w * ref, dim=0)
        err = x[n] - pred
        norm = torch.sum(ref * ref, dim=0) + 1e-3
        w = params.decay * w + (params.mu / norm) * err[None, :] * ref
        line = torch.cat([line[1:], x[n][None, :]])
        y[n] = err if params.notch else pred
    return y, LmsState(weights=w, line=line)


def lms_block(params: LmsParams, x: torch.Tensor, state: LmsState
              ) -> tuple[torch.Tensor, LmsState]:
    """Adaptive line enhancer over (N, C) float32 audio
    (`rx/kiwi/lms.cpp:30-123`): the predictor estimates x[n] from samples
    older than ``delay``; denoise mode outputs the prediction, notch mode
    the prediction error.

    On the card this is kernel 5 (:func:`lms_chain_block`) with only the
    stage of ``params``' mode on: the notch stage for notch mode, the
    denoiser stage otherwise.  The stage that is off passes its input
    through, and its delay line, which it still advances, is dropped.
    """
    if x.device.type == "cpu":
        return lms_block_plain(params, x, state)
    c = x.shape[1]
    on = torch.ones(c, dtype=torch.bool, device=x.device)
    off = torch.zeros(c, dtype=torch.bool, device=x.device)
    spare = init_lms(params, c, x.device)
    if params.notch:
        y, st, _ = lms_chain_block(params, params, x, state, spare, on, off)
    else:
        y, _, st = lms_chain_block(params, params, x, spare, state, off, on)
    return y, st


def lms_chain_block_plain(notch_p: LmsParams, den_p: LmsParams,
                          x: torch.Tensor, st_notch: LmsState,
                          st_den: LmsState, en_notch: torch.Tensor,
                          en_den: torch.Tensor
                          ) -> tuple[torch.Tensor, LmsState, LmsState]:
    """Plain version: the reference scan step as a loop over samples."""
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


def lms_chain_block(notch_p: LmsParams, den_p: LmsParams,
                    x: torch.Tensor, st_notch: LmsState, st_den: LmsState,
                    en_notch: torch.Tensor, en_den: torch.Tensor
                    ) -> tuple[torch.Tensor, LmsState, LmsState]:
    """Autonotch -> denoiser chain over one (N, C) float32 block,
    per-channel gated (`rx/rx_sound.cpp:933-943`).  Disabled stages pass
    through and stop adapting; their delay lines still advance.

    en_notch, en_den: (C,) bool.  Returns (y (N, C), notch state,
    denoiser state).
    """
    if x.device.type == "cpu":
        return lms_chain_block_plain(notch_p, den_p, x, st_notch, st_den,
                                     en_notch, en_den)
    _build.require_cuda(x, "lms_chain_block")
    if (notch_p.taps, notch_p.delay) != (den_p.taps, den_p.delay):
        raise ValueError("lms_chain_block: the two stages must share taps "
                         "and delay")
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"lms_chain_block: x must be float32 (N, C), got "
                         f"{x.dtype} {tuple(x.shape)}")
    n, c = x.shape
    x = x.contiguous()
    y = torch.empty_like(x)
    carries = []
    for st in (st_notch, st_den):
        if st.weights.shape != (notch_p.taps, c) or \
                st.line.shape != (notch_p.taps + notch_p.delay, c):
            raise ValueError("lms_chain_block: state shapes do not match "
                             "the parameters")
        carries += [st.weights.to(torch.float32).clone(),
                    st.line.to(torch.float32).clone()]
    wn, ln, wd, ld = carries
    en_n = en_notch.to(torch.bool).contiguous()
    en_d = en_den.to(torch.bool).contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _build.lib().lms_chain_f32(
        x.data_ptr(), y.data_ptr(), wn.data_ptr(), ln.data_ptr(),
        wd.data_ptr(), ld.data_ptr(), en_n.data_ptr(), en_d.data_ptr(),
        n, c, notch_p.taps, notch_p.delay, notch_p.decay, notch_p.mu,
        den_p.decay, den_p.mu, stream)
    _build.check(err, "lms_chain_f32")
    _build.count_launch(lms_chain_block)
    return y, LmsState(weights=wn, line=ln), LmsState(weights=wd, line=ld)


lms_chain_block.launches = 0
