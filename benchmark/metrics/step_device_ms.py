"""Engine: device ms a block of the kernels on the engine's stream (the
step and serve graphs, ``run_block_gather``), from the trace."""

from __future__ import annotations

from _device import engine_stream


def read(ctx, name):
    got = engine_stream(ctx)
    if got is None:
        return None
    _sid, evs, blocks = got
    return sum(e["dur"] for e in evs) * 1e-3 / blocks
