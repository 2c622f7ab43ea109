"""Server: the fan-out's wait for its block's host copy, ms a block of
the span ``fanout.fetch_wait``, over the window."""

from __future__ import annotations

from _program import in_window, mean_block_ms


def read(ctx, name):
    return mean_block_ms(in_window(ctx, {"fanout.fetch_wait"}))
