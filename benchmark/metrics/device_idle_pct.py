"""Device: the share of the traced window in which no kernel ran
(copies count as idle)."""

from __future__ import annotations


def read(ctx, name):
    t = ctx["trace"]
    if t is None or not t.kernels:
        return None
    return 100.0 * (1.0 - t.covered_s(t.union(t.kernels)) / t.window_s)
