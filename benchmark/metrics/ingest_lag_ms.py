"""Ingest: how long a block sat in the program's ``ThreadedSource`` ring,
mean ms of the span ``source.queued`` (the end of its push to the start
of its pop) over the blocks pushed in the window."""

from __future__ import annotations

from _program import in_window, mean_ms


def read(ctx, name):
    return mean_ms(in_window(ctx, {"source.queued"}))
