"""One channel's column of a block's taps, as a host numpy copy.

Extensions are fed two kinds of taps: the engine's ``RxTaps``, whose
``audio``/``audio2`` are (B, C) float32 tensors, ``iq_post_agc`` a
(B, C) complex64 tensor and ``smeter_dbm`` a (C,) tensor, on the
engine's device; and the server's ``HostTaps``, whose columns are host
rows (``_Cols``, ``_CplxCols`` with ``.re``/``.im``) and whose
``smeter_dbm`` is a host array.  The host decoders read one column a
block; these give it the same way from either, fetching only that
column from the card.
"""

from __future__ import annotations

import numpy as np
import torch


def host_column(tap, ch: int, dtype=np.float32) -> np.ndarray:
    """Channel ``ch`` of an ``audio``/``audio2`` tap as a host array of
    ``dtype`` (a copy, never a view of the tap)."""
    if isinstance(tap, torch.Tensor):
        return tap[:, ch].cpu().numpy().astype(dtype)
    return np.array(tap[:, ch], dtype)


def host_iq(iq, ch: int) -> tuple[np.ndarray, np.ndarray]:
    """Channel ``ch`` of the post-AGC IQ tap as float32 host arrays
    ``(re, im)``: of a complex64 tensor or of ``HostTaps``' rows."""
    if isinstance(iq, torch.Tensor):
        z = torch.view_as_real(iq[:, ch].cpu()).numpy()
        return (z[:, 0].astype(np.float32), z[:, 1].astype(np.float32))
    return (np.array(iq.re[:, ch], np.float32),
            np.array(iq.im[:, ch], np.float32))


def host_smeter(smeter, ch: int) -> float:
    """Channel ``ch``'s S-meter reading (dBm) of a (C,) tensor or host
    array."""
    if isinstance(smeter, torch.Tensor):
        return float(smeter[ch].item())
    return float(np.asarray(smeter[ch]))
