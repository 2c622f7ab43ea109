"""Ingest: the ring pop inside the program's ``ThreadedSource``, host ms
a block of its span ``source.pop`` (the copy out of the ring and the
check for non-finite samples), over the window."""

from __future__ import annotations

from _program import in_window, mean_ms


def read(ctx, name):
    return mean_ms(in_window(ctx, {"source.pop"}))
