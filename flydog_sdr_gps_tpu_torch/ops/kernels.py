"""Stage-2 decimator kernels (``csrc/stage2.cu``) and their plain versions.

Port of the two Pallas kernels of :mod:`flydog_sdr_gps_tpu.ops.
pallas_kernels`:

- :func:`stage2_rot` replaces ``stage2_rot_pallas`` (`:178-286`): the
  fused NCO rotator + shared-tap polyphase decimator, the default
  main-path stage 2.
- :func:`stage2` replaces ``stage2_pallas``/``stage2_pallas_part``
  (`:48-115`): the same decimator without rotation, both planes of the
  complex input in one launch.

Each wrapper runs its plain PyTorch version for a tensor on the CPU and
launches its CUDA kernel for a CUDA tensor (no fallback), counting the
launches in its ``launches`` attribute.  The kernels take any channel
count (the ragged edge is masked) and the two decimation plans,
``(d2, m2)`` = (31, 24) and (4, 25).  The TPU-only tiling, padding and
packed layouts of the reference are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from . import nco

# (d2, m2) pairs the CUDA kernels are instantiated for
KERNEL_PLANS = ((31, 24), (4, 25))


def _check_args(y: torch.Tensor, h2: np.ndarray, d2: int, k2: int,
                name: str) -> int:
    m2 = len(h2) // d2
    if y.dtype != torch.complex64 or y.dim() != 2:
        raise ValueError(f"{name}: y must be complex64 (Kp, C), got "
                         f"{y.dtype} {tuple(y.shape)}")
    if len(h2) != m2 * d2 or y.shape[0] != (k2 + m2 - 1) * d2:
        raise ValueError(f"{name}: y has {y.shape[0]} rows; need "
                         f"(k2 + m2 - 1) * d2 = {(k2 + m2 - 1) * d2}")
    return m2


def _launch_args(y: torch.Tensor, h2: np.ndarray, d2: int, m2: int,
                 k2: int, name: str):
    """Contiguous input, float32 taps, the output and the stream."""
    _build.require_cuda(y, name)
    if (d2, m2) not in KERNEL_PLANS:
        raise ValueError(f"{name}: no kernel for (d2, m2) = ({d2}, {m2})")
    y = y.contiguous()
    taps = np.ascontiguousarray(h2, np.float32)
    out = torch.empty((k2, y.shape[1]), dtype=torch.complex64,
                      device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    return y, taps, out, stream


# ---------------------------------------------------------------------------
# kernel 2: stage 2, unfused
# ---------------------------------------------------------------------------

def stage2_plain(y: torch.Tensor, h2: np.ndarray, d2: int, k2: int
                 ) -> torch.Tensor:
    """Plain version: the reference's ``_stage2_poly`` — m2 shifted
    tensordots over the (rows, d2, C) reshape, both planes at once."""
    m2 = len(h2) // d2
    c = y.shape[1]
    z = torch.view_as_real(y).reshape(-1, d2, 2 * c)    # (k2+m2-1, d2, 2C)
    h2p = torch.as_tensor(np.asarray(h2, np.float32).reshape(m2, d2),
                          device=y.device)
    acc = torch.zeros((k2, 2 * c), dtype=torch.float32, device=y.device)
    for i in range(m2):
        acc = acc + torch.tensordot(z[i:i + k2], h2p[i], dims=([1], [0]))
    return torch.view_as_complex(acc.reshape(k2, c, 2))


def stage2(y: torch.Tensor, h2: np.ndarray, d2: int, k2: int
           ) -> torch.Tensor:
    """Shared-tap polyphase decimation: (Kp, C) complex64 -> (k2, C)."""
    m2 = _check_args(y, h2, d2, k2, "stage2")
    if y.device.type == "cpu":
        return stage2_plain(y, h2, d2, k2)
    y, taps, out, stream = _launch_args(y, h2, d2, m2, k2, "stage2")
    err = _build.lib().stage2_c64(
        y.data_ptr(), out.data_ptr(), taps.ctypes.data, y.shape[1], k2,
        d2, m2, stream)
    _build.check(err, "stage2_c64")
    stage2.launches += 1
    return out


stage2.launches = 0


# ---------------------------------------------------------------------------
# kernel 1: fused rotator + stage 2
# ---------------------------------------------------------------------------

def stage2_rot_plain(y: torch.Tensor, phi0: torch.Tensor,
                     dphi: torch.Tensor, h2: np.ndarray, d2: int, k2: int
                     ) -> torch.Tensor:
    """Plain version: rotate every sample by its exact phase, then
    :func:`stage2_plain`."""
    cyc = nco.phase_ramp(phi0, dphi, y.shape[0])        # (Kp, C)
    ang = (-2.0 * np.pi) * cyc
    rot = torch.complex(torch.cos(ang), torch.sin(ang))
    return stage2_plain(y * rot, h2, d2, k2)


def stage2_rot(y: torch.Tensor, phi0: torch.Tensor, dphi: torch.Tensor,
               h2: np.ndarray, d2: int, k2: int) -> torch.Tensor:
    """Rotate-and-decimate the UNROTATED stage-1 output.

    y: (Kp, C) complex64, Kp = (k2 + m2 - 1) * d2; phi0, dphi: (C,) int64
    words — the phase of row 0 and the per-row increment.  Row n is
    rotated by exp(-2j*pi*(phi0 + n*dphi) / 2**48) before the shared-tap
    reduction.  Returns (k2, C) complex64.
    """
    m2 = _check_args(y, h2, d2, k2, "stage2_rot")
    c = y.shape[1]
    if phi0.shape != (c,) or dphi.shape != (c,) or \
            phi0.dtype != torch.int64 or dphi.dtype != torch.int64:
        raise ValueError("stage2_rot: phi0 and dphi must be int64 (C,)")
    if y.device.type == "cpu":
        return stage2_rot_plain(y, phi0, dphi, h2, d2, k2)
    y, taps, out, stream = _launch_args(y, h2, d2, m2, k2, "stage2_rot")
    phi0 = phi0.contiguous()
    dphi = dphi.contiguous()
    err = _build.lib().stage2_rot_c64(
        y.data_ptr(), out.data_ptr(), phi0.data_ptr(), dphi.data_ptr(),
        taps.ctypes.data, c, k2, d2, m2, stream)
    _build.check(err, "stage2_rot_c64")
    stage2_rot.launches += 1
    return out


stage2_rot.launches = 0
