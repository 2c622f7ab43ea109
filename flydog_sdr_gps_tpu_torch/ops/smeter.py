"""S-meter: attack/decay-filtered signal level in dB.

Port of :mod:`flydog_sdr_gps_tpu.ops.smeter` (reference
`rx/rx_sound.cpp:677-696`; calibration -13 dBm full scale).
"""

from __future__ import annotations

import torch

from . import iir

DEFAULT_CAL_DBM = -13.0


def abs2(z: torch.Tensor) -> torch.Tensor:
    """|z|^2 of a complex tensor as re*re + im*im."""
    return z.real * z.real + z.imag * z.imag


def smeter_block(z: torch.Tensor, level: torch.Tensor,
                 attack_alpha: float = 0.2,
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Track filtered power of (N, C) IQ; returns (dBm_seq, peak_dBm, new).

    ``level``: (C,) float32 carried linear power; the peak is the block
    max of the filtered level in dBm.
    """
    filt = iir.one_pole_smoother(abs2(z), attack_alpha, level)
    dbm = 10.0 * torch.log10(filt + 1e-30) + DEFAULT_CAL_DBM
    return dbm, dbm.amax(dim=0), filt[-1]
