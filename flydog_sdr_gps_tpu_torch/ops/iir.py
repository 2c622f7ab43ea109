"""Linear recurrences (IIR) as log-depth parallel scans.

Port of the main-path part of :mod:`flydog_sdr_gps_tpu.ops.iir`.  The
reference evaluates ``y[n] = a[n]*y[n-1] + u[n]`` with
``lax.associative_scan``; here the same associative combine runs as a
Hillis-Steele doubling scan: ceil(log2 N) rounds of whole-tensor ops,
vectorized over channels — no per-sample loop.

Conventions: signals are (N, C) tensors (time major).
"""

from __future__ import annotations

import torch


def linear_recurrence(a, u: torch.Tensor, y0: torch.Tensor
                      ) -> torch.Tensor:
    """Solve ``y[n] = a[n]*y[n-1] + u[n]`` with ``y[-1] = y0``.

    ``a`` (tensor or float) broadcasts against ``u`` (N, C); returns y.
    """
    a = torch.as_tensor(a, dtype=u.dtype, device=u.device)
    a = a.expand(u.shape).clone()
    b = u.clone()
    b[0] += a[0] * y0
    n = u.shape[0]
    shift = 1
    while shift < n:
        # element i absorbs the prefix ending at i - shift:
        # (a_l, b_l) o (a_r, b_r) = (a_l*a_r, a_r*b_l + b_r)
        b_next = b.clone()
        b_next[shift:] += a[shift:] * b[:-shift]
        a_next = a.clone()
        a_next[shift:] *= a[:-shift]
        a, b = a_next, b_next
        shift *= 2
    return b


def dc_blocker(x: torch.Tensor, state: torch.Tensor, r: float = 0.999
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """DC-removal IIR: ``y[n] = x[n] - x[n-1] + r*y[n-1]``.

    state: (2, C) = [x[-1], y[-1]] (`rx/rx_sound.cpp:770-780`).
    """
    xd1 = torch.cat([state[0:1], x[:-1]])
    y = linear_recurrence(r, x - xd1, state[1])
    return y, torch.stack([x[-1], y[-1]])


def one_pole_smoother(x: torch.Tensor, alpha, y0: torch.Tensor
                      ) -> torch.Tensor:
    """``y[n] = (1-alpha)*y[n-1] + alpha*x[n]`` — attack/decay filter."""
    alpha = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
    return linear_recurrence(1.0 - alpha, alpha * x, y0)
