"""Ingest: the copy of the block to the card in ``StreamEngine._next_x``,
host ms a block of its span ``engine.h2d`` (a copy from pageable memory:
the host waits for the stream's queued work, then copies), over the
window."""

from __future__ import annotations

from _program import in_window, mean_ms


def read(ctx, name):
    return mean_ms(in_window(ctx, {"engine.h2d"}))
