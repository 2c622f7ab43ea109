"""48-bit numerically-controlled oscillator (NCO) on int64 words.

Port of :mod:`flydog_sdr_gps_tpu.ops.nco`.  The reference holds a phase
as three 16-bit limbs because the TPU has no int64; here a phase is one
``int64`` word in ``[0, 2**48)``, exact mod 2**48, and becomes float32
cycles only at the point of use (:func:`to_cycles`, the same three-term
float32 sum as the reference's ``limbs_to_cycles_f32``).

Overflow: ``n * dphi`` with ``n`` up to ~2**25 and ``dphi`` up to 2**48
overflows a signed int64, which is undefined in PyTorch's C++ kernels.
:func:`mul_mod48` therefore splits both factors into 24-bit halves so
that no partial product reaches 2**49.
"""

from __future__ import annotations

import numpy as np
import torch

from ..numerology import PHASE_BITS

MASK48 = (1 << PHASE_BITS) - 1
_MASK24 = (1 << 24) - 1


def freq_to_fcw(freq_hz: float, adc_clock_hz: float) -> int:
    """Frequency -> 48-bit frequency control word (exact Python int).

    Mirrors `rx/rx_sound_cmd.cpp:86-87`.  Negative frequencies wrap
    modulo 2**48 (two's-complement style), matching accumulator behavior.
    """
    fcw = round(freq_hz / adc_clock_hz * (1 << PHASE_BITS))
    return fcw % (1 << PHASE_BITS)


def freqs_to_fcws(freqs_hz, adc_clock_hz: float) -> np.ndarray:
    """:func:`freq_to_fcw` of each frequency, as an int64 array: the same
    float64 quotient and product and the same round-half-even, so each
    word equals the scalar function's."""
    q = np.asarray(freqs_hz, np.float64) / adc_clock_hz * float(
        1 << PHASE_BITS)
    return np.mod(np.rint(q).astype(np.int64), 1 << PHASE_BITS)


def fcw_to_freq(fcw: int, adc_clock_hz: float) -> float:
    """Inverse of :func:`freq_to_fcw` (principal value in [-fs/2, fs/2))."""
    fcw = fcw % (1 << PHASE_BITS)
    if fcw >= 1 << (PHASE_BITS - 1):
        fcw -= 1 << PHASE_BITS
    return fcw / (1 << PHASE_BITS) * adc_clock_hz


def mul_mod48(n, d: torch.Tensor) -> torch.Tensor:
    """Exact ``(n * d) mod 2**48`` for int64 ``n``, ``d`` in [0, 2**48).

    ``n`` is an int or an int64 tensor broadcasting against ``d``.  An
    int stays a Python scalar operand (no host-to-device copy, so the
    product can be recorded in a CUDA graph).
    """
    if isinstance(n, (int, np.integer)):
        n = int(n)
    elif not isinstance(n, torch.Tensor):
        n = torch.as_tensor(n, dtype=torch.int64, device=d.device)
    nl, nh = n & _MASK24, n >> 24
    dl, dh = d & _MASK24, d >> 24
    cross = (nl * dh + nh * dl) & _MASK24
    return (nl * dl + (cross << 24)) & MASK48


def advance(phi: torch.Tensor, dphi: torch.Tensor, num) -> torch.Tensor:
    """Advance a phase carry by ``num`` steps: (phi + num*dphi) mod 2**48."""
    return (phi + mul_mod48(num, dphi)) & MASK48


def ramp_words(phi0: torch.Tensor, dphi: torch.Tensor, num: int
               ) -> torch.Tensor:
    """Exact phase words ``(phi0 + k*dphi) mod 2**48``, shape
    ``(num,) + batch`` for k in [0, num)."""
    k = torch.arange(num, dtype=torch.int64, device=dphi.device)
    k = k.reshape((num,) + (1,) * dphi.ndim)
    return (phi0 + mul_mod48(k, dphi)) & MASK48


def to_cycles(words: torch.Tensor) -> torch.Tensor:
    """Phase words -> float32 cycles in [0, 1)."""
    l0 = (words & 0xFFFF).to(torch.float32)
    l1 = ((words >> 16) & 0xFFFF).to(torch.float32)
    l2 = ((words >> 32) & 0xFFFF).to(torch.float32)
    return l2 * 2.0 ** -16 + l1 * 2.0 ** -32 + l0 * 2.0 ** -48


def phase_ramp(phi0: torch.Tensor, dphi: torch.Tensor, num: int
               ) -> torch.Tensor:
    """Exact phase ramp as float32 cycles, shape ``(num,) + batch``.

    Unlike the reference there is no ramp-length limit: int64 words
    carry any ``num`` exactly.
    """
    return to_cycles(ramp_words(phi0, dphi, num))


def tone(phi0: torch.Tensor, dphi: torch.Tensor, num: int) -> torch.Tensor:
    """Complex exponential ``exp(+2j*pi*phase_ramp)`` as complex64, shape
    ``(num,) + batch``, from int64 phase words (the reference's ``tone``
    takes limbs)."""
    ang = (2.0 * np.pi) * phase_ramp(phi0, dphi, num)
    return torch.complex(torch.cos(ang), torch.sin(ang))


def words_from_limbs(limbs) -> torch.Tensor:
    """Reference limb phases ``[..., 3]`` (int32) -> int64 words."""
    l = torch.as_tensor(limbs).to(torch.int64)
    return l[..., 0] | (l[..., 1] << 16) | (l[..., 2] << 32)
