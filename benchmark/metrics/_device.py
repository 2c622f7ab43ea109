"""Shared by the readers of device time: the engine's stream (the one
that runs kernel 1, the stage-2 kernel, once a block), and the blocks the
trace holds whole."""

from __future__ import annotations


def matches(name: str, patterns) -> bool:
    low = name.lower()
    return any(p.lower() in low for p in patterns)


def engine_stream(ctx):
    """(engine stream id, its kernels, blocks traced) or None."""
    t = ctx["trace"]
    if t is None or not t.kernels:
        return None
    names = ctx["kernel_names"]("stage2_roofline_pct")
    for sid, evs in t.streams().items():
        n = sum(1 for e in evs if matches(e["name"], names))
        if n:
            return sid, evs, n
    return None
