"""Set-up: host seconds before the window in the programs' first runs
and CUDA graph captures (``graphs.first_run``, ``graphs.capture``) and
the kernels' build and load (``build.load``), their spans' union."""

from __future__ import annotations

from _program import before_window, union_ns

NAMES = {"graphs.first_run", "graphs.capture", "build.load"}


def read(ctx, name):
    iv = union_ns(before_window(ctx, NAMES), hi=ctx["window"][0] * 1e9)
    return sum(b - a for a, b in iv) * 1e-9 if iv else None
