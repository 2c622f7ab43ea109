"""Waterfall: device ms a block of the kernels on streams other than the
engine's (the waterfall chains' ingest and frame graphs), from the
trace."""

from __future__ import annotations

from _device import engine_stream


def read(ctx, name):
    got = engine_stream(ctx)
    if got is None:
        return None
    sid, _evs, blocks = got
    other = [e for s, evs in ctx["trace"].streams().items() if s != sid
             for e in evs]
    if not other:
        return None
    return sum(e["dur"] for e in other) * 1e-3 / blocks
