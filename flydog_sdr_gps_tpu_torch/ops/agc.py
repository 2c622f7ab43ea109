"""AGC — CuteSDR ``CAgc`` behavior.

Port of :mod:`flydog_sdr_gps_tpu.ops.agc` (`rx/CuteSDR/agc.cpp`):
look-ahead delay line, log-domain envelope follower with attack/decay
and hang, knee/slope gain law.  The envelope follower is sequential in
time; the reference runs it as a ``lax.scan`` (`agc.py:72-91`).  Here it
is :func:`envelope_scan`: the CUDA kernel ``agc_envelope_f32``
(``csrc/scans.cu``: a serial warp on a shared-memory tile ring that
mover warps fill and drain) for a CUDA tensor, its plain
PyTorch loop for a tensor on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _build
from .smeter import abs2


@dataclasses.dataclass(frozen=True, eq=False)
class AgcParams:
    """Static AGC configuration (per firmware defaults, adjustable)."""
    fs: float = 12_000.0
    delay_samples: int = 48        # ~4 ms look-ahead (ref SetParameters)
    attack_ms: float = 2.0
    decay_ms: float = 200.0
    hang_ms: float = 0.0           # 0 = hang off
    threshold_db: float = -100.0   # knee
    slope_db: float = 6.0          # gain reduction above knee
    max_gain_db: float = 84.0      # AGC_MAX_GAIN-ish ceiling
    out_target: float = 0.5        # output level at/above knee

    @property
    def attack_alpha(self) -> float:
        return 1.0 - float(np.exp(-1.0 / (self.fs * self.attack_ms * 1e-3)))

    @property
    def decay_alpha(self) -> float:
        return 1.0 - float(np.exp(-1.0 / (self.fs * self.decay_ms * 1e-3)))

    @property
    def hang_samples(self) -> int:
        return int(self.fs * self.hang_ms * 1e-3)


@dataclasses.dataclass
class AgcState:
    delay: torch.Tensor     # (delay_samples, C) complex64 look-ahead line
    env_db: torch.Tensor    # (C,) float32 envelope, dB
    hang: torch.Tensor      # (C,) int32 hang countdown


def init_state(params: AgcParams, num_channels: int,
               device: torch.device | str) -> AgcState:
    return AgcState(
        delay=torch.zeros((params.delay_samples, num_channels),
                          dtype=torch.complex64, device=device),
        env_db=torch.full((num_channels,), -160.0, dtype=torch.float32,
                          device=device),
        hang=torch.zeros(num_channels, dtype=torch.int32, device=device),
    )


def envelope_scan_plain(params: AgcParams, mag_db: torch.Tensor,
                        env0: torch.Tensor, hang0: torch.Tensor):
    """Plain version: the reference scan step as a loop over samples."""
    f32 = dict(dtype=torch.float32, device=mag_db.device)
    atk = torch.tensor(params.attack_alpha, **f32)
    dec = torch.tensor(params.decay_alpha, **f32)
    hang_n = torch.tensor(params.hang_samples, dtype=torch.int32,
                          device=mag_db.device)
    env, hang = env0, hang0
    out = torch.empty_like(mag_db)
    for n in range(mag_db.shape[0]):
        m = mag_db[n]
        rising = m > env
        env_up = env + atk * (m - env)
        env_dn = torch.where(hang > 0, env, env + dec * (m - env))
        env = torch.where(rising, env_up, env_dn)
        hang = torch.where(rising, hang_n, torch.clamp(hang - 1, min=0))
        out[n] = env
    return out, env, hang


def envelope_scan(params: AgcParams, mag_db: torch.Tensor,
                  env0: torch.Tensor, hang0: torch.Tensor):
    """Sequential envelope follower: fast attack, hang-then-decay.

    mag_db: (N, C) float32; env0 (C,) float32; hang0 (C,) int32.
    Returns (env_seq (N, C), env (C,), hang (C,)).
    """
    if mag_db.device.type == "cpu":
        return envelope_scan_plain(params, mag_db, env0, hang0)
    _build.require_cuda(mag_db, "envelope_scan")
    mag_db = mag_db.contiguous()
    n, c = mag_db.shape
    env_seq = torch.empty_like(mag_db)
    env = env0.to(torch.float32).clone()
    hang = hang0.to(torch.int32).clone()
    stream = torch.cuda.current_stream(mag_db.device).cuda_stream
    err = _build.lib().agc_envelope_f32(
        mag_db.data_ptr(), env_seq.data_ptr(), env.data_ptr(),
        hang.data_ptr(), n, c, params.attack_alpha, params.decay_alpha,
        params.hang_samples, stream)
    _build.check(err, "agc_envelope_f32")
    _build.count_launch(envelope_scan)
    return env_seq, env, hang


envelope_scan.launches = 0


def agc_block(params: AgcParams, x: torch.Tensor, state: AgcState,
              manual_gain_db: torch.Tensor | None = None,
              ) -> tuple[torch.Tensor, AgcState]:
    """Apply AGC to one (N, C) complex64 block; returns (y, new_state).

    Channels with a non-NaN ``manual_gain_db`` (C,) use that fixed gain
    (reference: AGC off = manual gain slider).
    """
    mag_db = 20.0 * torch.log10(torch.sqrt(abs2(x)) + 1e-12)
    env_seq, env, hang = envelope_scan(params, mag_db, state.env_db,
                                       state.hang)
    knee = params.threshold_db
    target_db = float(20.0 * np.log10(np.float32(params.out_target)))
    gain_db = torch.where(
        env_seq >= knee,
        target_db - env_seq + params.slope_db * (env_seq - knee) / 100.0,
        float(np.float32(target_db - knee)))
    gain_db = torch.clamp(gain_db, max=params.max_gain_db)
    if manual_gain_db is not None:
        manual = manual_gain_db.expand(gain_db.shape)
        gain_db = torch.where(torch.isnan(manual), gain_db, manual)
    gain = torch.pow(10.0, gain_db / 20.0)
    # look-ahead: gain derived from x[n], applied to x[n - delay]
    buf = torch.cat([state.delay, x])
    n = x.shape[0]
    return buf[:n] * gain, AgcState(delay=buf[n:], env_db=env, hang=hang)
