"""Multi-channel digital down-converter (DDC): filter-bank matmul + stage 2.

Port of :mod:`flydog_sdr_gps_tpu.ops.channelizer` (see its docstring
for the design: the mixer, first filter and first decimation of every
channel are ONE matmul ``(k1, L1) @ (L1, C)`` against a bank of
frequency-shifted prototype filters; the residual per-output phase
``exp(-j*w_c*D1*k)`` is applied exactly from the 48-bit NCO; a shared-
tap polyphase FIR finishes the decimation).

What differs from the reference:
- The bank is one complex64 ``(L1, C)`` tensor.  Its memory IS the
  interleaved ``(L1, C, 2)`` float32 layout, so the float32 matmul
  ``frames @ view_as_real(bank).reshape(L1, 2C)`` writes a tensor that
  is complex64 ``(k1, C)`` through ``view_as_complex`` — this replaces
  the reference's tile-paired ``pack_bank``/``pack_cols``.
- Stage 1 runs in full float32 whatever ``RxParams.precision`` says
  (the reference's "high" is a 3-pass bf16 product on the TPU).  On a
  CUDA card ``stage1_matmul`` raises unless TF32 is off for matmuls
  (``allow_tf32`` False, float32 matmul precision "highest": PyTorch's
  defaults); TF32 would cost the 80 dB SINAD.
- Stage 2 is :mod:`.kernels` (a CUDA kernel on the card, its plain
  version on the CPU).  The reference's ``"fft"`` method is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from flydog_sdr_gps_tpu.numerology import (ADC_CLOCK_NOM, AUDIO_BLOCK,
                                           DECIM_PLAN_12K, DECIM_PLAN_20K,
                                           PHASE_BITS, SND_RATE_12K)
from flydog_sdr_gps_tpu.ops.filters import design_decimation_stages

from . import kernels
from . import nco


# ---------------------------------------------------------------------------
# plan (host copy of the reference's DDCPlan / make_ddc_plan)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class DDCPlan:
    """Static description of a two-stage DDC chain (shapes, taps)."""
    adc_clock: float
    decims: tuple[int, int]
    h1: np.ndarray                    # (L1,) float64, stage-1 prototype
    h2: np.ndarray                    # (L2,) float64, stage-2 lowpass
    audio_block: int                  # output samples per block (K2)

    @property
    def d1(self) -> int: return self.decims[0]

    @property
    def d2(self) -> int: return self.decims[1]

    @property
    def l1(self) -> int: return len(self.h1)

    @property
    def l2(self) -> int: return len(self.h2)

    @property
    def m1(self) -> int: return self.l1 // self.d1

    @property
    def m2(self) -> int: return self.l2 // self.d2

    @property
    def total_decim(self) -> int: return self.d1 * self.d2

    @property
    def fs1(self) -> float: return self.adc_clock / self.d1

    @property
    def fs_out(self) -> float: return self.adc_clock / self.total_decim

    @property
    def k1(self) -> int:              # stage-1 outputs per block
        return self.audio_block * self.d2

    @property
    def adc_block(self) -> int:       # ADC samples consumed per block
        return self.k1 * self.d1

    @property
    def tail1(self) -> int:           # stage-1 input carry, samples
        return self.l1 - self.d1

    @property
    def tail2(self) -> int:           # stage-2 input carry, stage-1 samples
        return self.l2 - self.d2


def make_ddc_plan(adc_clock: float = ADC_CLOCK_NOM,
                  snd_rate: int = SND_RATE_12K,
                  audio_block: int = AUDIO_BLOCK,
                  atten_db: float = 90.0,
                  f_protect: float | None = None) -> DDCPlan:
    """Build the decimation plan for one audio-rate family.

    ``f_protect`` defaults to 0.38 * fs_out (4.56 kHz at 12 kHz rate).
    """
    decims = DECIM_PLAN_12K if snd_rate == SND_RATE_12K else DECIM_PLAN_20K
    fs_out = adc_clock / (decims[0] * decims[1])
    if f_protect is None:
        f_protect = 0.38 * fs_out
    h1, h2 = design_decimation_stages(adc_clock, decims, f_protect,
                                      atten_db=atten_db)
    return DDCPlan(adc_clock=adc_clock, decims=tuple(decims),
                   h1=h1, h2=h2, audio_block=audio_block)


# ---------------------------------------------------------------------------
# host-side filter-bank construction (exact, float64/int)
# ---------------------------------------------------------------------------

def build_filterbank(plan: DDCPlan, fcws: Sequence[int]
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Bank matrix + rotator increments for a set of 48-bit tuning words.

    Returns ``(bank, dphi1)``:
    - ``bank``: complex64 (L1, C), ``B[n, c] = 2 * h1[n] *
      exp(-j*2*pi*(n*fcw_c / 2**48))`` (factor 2: real->analytic).
    - ``dphi1``: int64 (C,) word ``fcw*D1 mod 2**48`` for the per-output
      phase rotator.
    """
    h1 = np.asarray(plan.h1, np.float64)
    n = np.arange(plan.l1, dtype=object)
    cols = []
    for fcw in fcws:
        fcw = int(fcw) % (1 << PHASE_BITS)
        ph = ((n * fcw) % (1 << PHASE_BITS)).astype(np.float64)
        ang = -2.0 * np.pi * ph * (2.0 ** -PHASE_BITS)
        # round each plane to float32 exactly as the reference does
        cols.append(np.asarray(2.0 * h1 * np.cos(ang), np.float32)
                    + 1j * np.asarray(2.0 * h1 * np.sin(ang), np.float32))
    bank = np.stack(cols, axis=-1).astype(np.complex64)
    dphi = np.array([(int(f) * plan.d1) % (1 << PHASE_BITS) for f in fcws],
                    np.int64)
    return bank, dphi


def build_filterbank_column(plan: DDCPlan, fcw: int
                            ) -> tuple[np.ndarray, int]:
    """Single-channel retune: one bank column + rotator increment."""
    bank, dphi = build_filterbank(plan, [fcw])
    return bank[:, 0], int(dphi[0])


# ---------------------------------------------------------------------------
# streaming state
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DDCState:
    """Per-block carries of the streaming DDC: raw-sample tail, stage-1
    output tail, exact 48-bit rotator phase."""
    x_tail: torch.Tensor              # (tail1,) float32
    y_tail: torch.Tensor              # (tail2, C) complex64
    phi1: torch.Tensor                # (C,) int64 rotator phase carry


def init_ddc_state(plan: DDCPlan, num_channels: int,
                   device: torch.device | str) -> DDCState:
    return DDCState(
        x_tail=torch.zeros(plan.tail1, dtype=torch.float32, device=device),
        y_tail=torch.zeros((plan.tail2, num_channels), dtype=torch.complex64,
                           device=device),
        phi1=torch.zeros(num_channels, dtype=torch.int64, device=device),
    )


# ---------------------------------------------------------------------------
# device-side computation
# ---------------------------------------------------------------------------

def frame(x: torch.Tensor, d: int, m: int) -> torch.Tensor:
    """Overlapping frames ``F[k, :] = x[k*d : k*d + m*d]`` as a strided
    view of ``x`` (length ``(K + m - 1) * d``); shape (K, m*d)."""
    return x.unfold(0, m * d, d)


def stage1_matmul(plan: DDCPlan, x_ext: torch.Tensor, bank: torch.Tensor,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """The stage-1 filter-bank matmul WITHOUT the NCO rotation.

    x_ext: (k1*d1 + tail1,) float32.  Returns (k1, C) complex64; with
    ``out`` (a contiguous complex64 (k1, C) tensor, e.g. rows of a larger
    buffer) the product is written there in place.  Full float32: on a
    CUDA tensor it raises if the process lets matmuls use TF32.
    """
    if x_ext.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                          or torch.get_float32_matmul_precision()
                          != "highest"):
        raise RuntimeError(
            "stage 1 needs full float32 matmuls: set torch.backends.cuda."
            "matmul.allow_tf32 = False and torch.set_float32_matmul_"
            "precision('highest') (TF32 costs the 80 dB SINAD)")
    frames = frame(x_ext, plan.d1, plan.m1)            # (k1, L1) view
    l1, c = bank.shape
    b = torch.view_as_real(bank).reshape(l1, 2 * c)
    if out is None:
        return torch.view_as_complex((frames @ b).reshape(-1, c, 2))
    torch.matmul(frames, b, out=torch.view_as_real(out).reshape(-1, 2 * c))
    return out


def stage1_apply(plan: DDCPlan, x_ext: torch.Tensor, bank: torch.Tensor,
                 phi1: torch.Tensor, dphi1: torch.Tensor) -> torch.Tensor:
    """Mix+filter+decimate all channels: the matmul + exact rotator.

    Returns (k1, C) complex64 baseband at fs1.  The rotation
    ``exp(-2pij*(phi_c + k*dphi_c))`` splits k = a*T + b into two small
    exact tables (as the reference does, `channelizer.py:289-321`)
    combined by two broadcast complex multiplies.
    """
    y = stage1_matmul(plan, x_ext, bank)
    k1, c = y.shape
    t = 128
    a = -(-k1 // t)
    rot_b = _expj_neg(nco.phase_ramp(phi1, dphi1, t))           # (T, C)
    dphi_t = nco.mul_mod48(t, dphi1)
    rot_a = _expj_neg(nco.phase_ramp(torch.zeros_like(phi1), dphi_t, a))
    pad = a * t - k1
    if pad:
        y = torch.cat([y, y.new_zeros((pad, c))])
    y = y.reshape(a, t, c)
    y.mul_(rot_b).mul_(rot_a[:, None, :])
    return y.reshape(a * t, c)[:k1]


def _expj_neg(cycles: torch.Tensor) -> torch.Tensor:
    """exp(-2*pi*j*cycles) as complex64."""
    ang = (-2.0 * np.pi) * cycles
    return torch.complex(torch.cos(ang), torch.sin(ang))


def stage2_apply(plan: DDCPlan, y_ext: torch.Tensor) -> torch.Tensor:
    """Shared-tap decimation over all channels (unrotated input).

    y_ext: (k1 + tail2, C) complex64.  Returns (k2, C) audio.
    """
    k2 = (y_ext.shape[0] - plan.tail2) // plan.d2
    return kernels.stage2(y_ext, plan.h2, plan.d2, k2)


def ddc_block(plan: DDCPlan, state: DDCState, x: torch.Tensor,
              bank: torch.Tensor, dphi1: torch.Tensor
              ) -> tuple[DDCState, torch.Tensor]:
    """Process one ADC block through the full DDC for all channels.

    x: (adc_block,) float32 (full scale = +-1.0).
    Returns (new_state, audio (audio_block, C) complex64 at fs_out).
    """
    x_ext = torch.cat([state.x_tail, x])
    y1 = stage1_apply(plan, x_ext, bank, state.phi1, dphi1)
    y_ext = torch.cat([state.y_tail, y1])
    audio = stage2_apply(plan, y_ext)
    new_state = DDCState(
        x_tail=x[-plan.tail1:].clone(),
        y_tail=y_ext[-plan.tail2:].clone(),
        phi1=nco.advance(state.phi1, dphi1, plan.k1),
    )
    return new_state, audio
