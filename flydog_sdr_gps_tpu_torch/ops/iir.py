"""Linear recurrences (IIR) as log-depth parallel scans.

Port of :mod:`flydog_sdr_gps_tpu.ops.iir`.  The reference evaluates
``y[n] = a[n]*y[n-1] + u[n]`` (and the second-order recurrence behind
its biquad) with ``lax.associative_scan``; here the same associative
combine runs as a Hillis-Steele doubling scan: ceil(log2 N) rounds of
whole-tensor ops, vectorized over channels — no per-sample loop.

Conventions: signals are (N, C) tensors (time major).
"""

from __future__ import annotations

import numpy as np
import torch


def linear_recurrence(a, u: torch.Tensor, y0: torch.Tensor
                      ) -> torch.Tensor:
    """Solve ``y[n] = a[n]*y[n-1] + u[n]`` with ``y[-1] = y0``.

    ``a`` (tensor or float) broadcasts against ``u`` (N, C); returns y.
    A float is filled in on the device (no host-to-device copy).
    """
    if isinstance(a, torch.Tensor):
        a = a.to(dtype=u.dtype, device=u.device).expand(u.shape).clone()
    else:
        a = torch.full_like(u, a)
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


def _full(a, v: torch.Tensor) -> torch.Tensor:
    """``a`` (tensor or float) broadcast to ``v``'s shape, in a new tensor
    of ``v``'s dtype on its device."""
    if isinstance(a, torch.Tensor):
        return a.to(dtype=v.dtype, device=v.device).expand(v.shape).clone()
    return torch.full_like(v, a)


def linear_recurrence_2(a1, a2, v: torch.Tensor, y1_0, y2_0
                        ) -> torch.Tensor:
    """Second order: ``y[n] = a1*y[n-1] + a2*y[n-2] + v[n]`` with
    ``y[-1] = y1_0``, ``y[-2] = y2_0``.

    Each sample is the affine map ``s[n] = M_n s[n-1] + w_n`` of the
    state ``s = [y[n], y[n-1]]``, ``M_n = [[a1, a2], [1, 0]]``,
    ``w_n = [v[n], 0]``; the maps compose associatively, as 2x2 products
    kept in their six components (the reference's combine).
    """
    m = [_full(a1, v), _full(a2, v), torch.ones_like(v),
         torch.zeros_like(v), v.clone(), torch.zeros_like(v)]
    n = v.shape[0]
    shift = 1
    while shift < n:
        # element i absorbs the prefix ending at i - shift (left), so its
        # map becomes right o left
        l11, l12, l21, l22, lw1, lw2 = (t[:-shift] for t in m)
        r11, r12, r21, r22, rw1, rw2 = (t[shift:] for t in m)
        comb = (r11 * l11 + r12 * l21, r11 * l12 + r12 * l22,
                r21 * l11 + r22 * l21, r21 * l12 + r22 * l22,
                r11 * lw1 + r12 * lw2 + rw1, r21 * lw1 + r22 * lw2 + rw2)
        m = [torch.cat([t[:shift], c]) for t, c in zip(m, comb)]
        shift *= 2
    # s[n] = A s[-1] + B; the first row of s[n] is y[n]
    return m[0] * y1_0 + m[1] * y2_0 + m[4]


def biquad(x: torch.Tensor, b, a, state: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Direct-form-I biquad over an (N, C) signal, channel-vectorized.

    ``b = (b0, b1, b2)``, ``a = (1, a1, a2)`` in scipy's sign convention:
    ``y[n] = b0 x[n] + b1 x[n-1] + b2 x[n-2] - a1 y[n-1] - a2 y[n-2]``.
    ``state``: (4, C) carrying [x[-1], x[-2], y[-1], y[-2]].  The
    coefficients are rounded to ``x``'s dtype, as the reference's are.
    Returns (y, new_state).
    """
    def coef(c):
        return float(torch.tensor(c, dtype=x.dtype))
    b0, b1, b2 = (coef(c) for c in b)
    a1, a2 = (coef(c) for c in a[1:])
    xm1, xm2, ym1, ym2 = state[0], state[1], state[2], state[3]
    xd1 = torch.cat([xm1[None], x[:-1]])
    xd2 = torch.cat([xm2[None], xm1[None], x[:-2]])
    v = b0 * x + b1 * xd1 + b2 * xd2
    y = linear_recurrence_2(-a1, -a2, v, ym1, ym2)
    return y, torch.stack([x[-1], x[-2], y[-1], y[-2]])


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
    """``y[n] = (1-alpha)*y[n-1] + alpha*x[n]`` — attack/decay filter.

    A float ``alpha`` is rounded to ``x``'s dtype and ``1 - alpha`` taken
    in that dtype on the host, so both enter as Python scalars and the
    result is the one a 0-d tensor of ``alpha`` gives, to the bit.
    """
    if isinstance(alpha, torch.Tensor):
        alpha = alpha.to(dtype=x.dtype, device=x.device)
        return linear_recurrence(1.0 - alpha, alpha * x, y0)
    a = torch.tensor(alpha, dtype=x.dtype)          # on the host
    return linear_recurrence(float(1.0 - a), float(a) * x, y0)


def design_biquad_lowpass(fs: float, fc: float, q: float = 0.7071
                          ) -> tuple[tuple, tuple]:
    """RBJ cookbook lowpass biquad (host side): ``(b, a)`` with a[0] = 1."""
    w0 = 2 * np.pi * fc / fs
    alpha = np.sin(w0) / (2 * q)
    cw = np.cos(w0)
    b = ((1 - cw) / 2, 1 - cw, (1 - cw) / 2)
    a = (1 + alpha, -2 * cw, 1 - alpha)
    a0 = a[0]
    return tuple(v / a0 for v in b), (1.0, a[1] / a0, a[2] / a0)
