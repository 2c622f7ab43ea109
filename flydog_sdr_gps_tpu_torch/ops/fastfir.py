"""Overlap-save fast-convolution passband filter (batched over channels).

Port of :mod:`flydog_sdr_gps_tpu.ops.fastfir` (CuteSDR ``CFastFIR``,
`rx/CuteSDR/fastfir.cpp`): a complex Kaiser bandpass applied by FFT
with overlap-save.  The reference's matmul FFT on split re/im becomes
``torch.fft`` on complex64 along the time axis, so no transposes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .filters import complex_bandpass

FFT_SIZE = 1024          # CONV_FFT_SIZE  (rx/CuteSDR/cuteSDR.h:12)
NTAPS = 513              # CONV_FIR_SIZE  (rx/CuteSDR/cuteSDR.h:14)
HOP = FFT_SIZE - (NTAPS - 1)   # = 512 samples of valid output per transform


@dataclasses.dataclass(frozen=True, eq=False)
class FastFIRPlan:
    fft_size: int = FFT_SIZE
    ntaps: int = NTAPS

    @property
    def hop(self) -> int:
        return self.fft_size - (self.ntaps - 1)

    @property
    def group_delay(self) -> int:
        return (self.ntaps - 1) // 2


def plan_for_block(audio_block: int) -> FastFIRPlan:
    """Overlap-save geometry for a given hop (= audio block) size: the
    FFT is a power of two >= 2*hop, ntaps = fft - hop + 1."""
    fft = 1024
    while fft < 2 * audio_block:
        fft *= 2
    return FastFIRPlan(fft_size=fft, ntaps=fft - audio_block + 1)


def passband_freq_coef(fs: float, f_lo: float, f_hi: float,
                       atten_db: float = 70.0,
                       plan: FastFIRPlan = FastFIRPlan()) -> np.ndarray:
    """Frequency-domain coefficients H (fft_size,) complex64 (host side),
    as CuteSDR ``SetupParameters`` builds them (`fastfir.cpp:79-150`)."""
    h = complex_bandpass(fs, f_lo, f_hi, atten_db, plan.ntaps)
    buf = np.zeros(plan.fft_size, np.complex128)
    buf[:plan.ntaps] = h
    return np.fft.fft(buf).astype(np.complex64)


def init_state(plan: FastFIRPlan, num_channels: int,
               device: torch.device | str) -> torch.Tensor:
    """Overlap carry: the last (ntaps-1) input samples per channel."""
    return torch.zeros((plan.ntaps - 1, num_channels),
                       dtype=torch.complex64, device=device)


def _coef(coef: torch.Tensor) -> torch.Tensor:
    return coef[:, None] if coef.dim() == 1 else coef


def fastfir_block(plan: FastFIRPlan, x: torch.Tensor, tail: torch.Tensor,
                  coef: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Filter one hop for all channels.

    x: (hop, C) complex64; tail: (ntaps-1, C) carry; coef: (fft_size, C)
    or (fft_size,).  Returns (y (hop, C), new_tail).
    """
    buf = torch.cat([tail, x])                          # (fft_size, C)
    y = torch.fft.ifft(torch.fft.fft(buf, dim=0) * _coef(coef), dim=0)
    return y[plan.ntaps - 1:], buf[plan.hop:]


def fastfir_block2(plan: FastFIRPlan, x: torch.Tensor, tail: torch.Tensor,
                   coef_a: torch.Tensor, coef_b: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Like :func:`fastfir_block` with TWO coefficient sets sharing the
    forward FFT (the SAM sideband masks).  Returns (y_a, y_b, new_tail).
    """
    buf = torch.cat([tail, x])
    spec = torch.fft.fft(buf, dim=0)
    ya = torch.fft.ifft(spec * _coef(coef_a), dim=0)
    yb = torch.fft.ifft(spec * _coef(coef_b), dim=0)
    return ya[plan.ntaps - 1:], yb[plan.ntaps - 1:], buf[plan.hop:]
