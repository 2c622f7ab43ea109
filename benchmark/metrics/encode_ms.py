"""Server: the SND payloads' encode, ms a block of the span
``fanout.encode`` (the job's run in its executor thread), over the
window."""

from __future__ import annotations

from _program import in_window, mean_block_ms


def read(ctx, name):
    return mean_block_ms(in_window(ctx, {"fanout.encode"}))
