"""Server: the fan-out's wait for the waterfall rows, ms a block of the
spans ``fanout.wf_row`` (one a W/F socket sent a row: the row's copy
awaited in an executor thread) added up, over the window."""

from __future__ import annotations

from _program import in_window, mean_block_ms


def read(ctx, name):
    return mean_block_ms(in_window(ctx, {"fanout.wf_row"}))
