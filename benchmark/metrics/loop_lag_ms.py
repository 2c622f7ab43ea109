"""Server: the event loop's lag, ms a block of the spans ``loop.lag``
(from an executor job's end until the coroutine awaiting it resumed)
added up, over the window."""

from __future__ import annotations

from _program import in_window, mean_block_ms


def read(ctx, name):
    return mean_block_ms(in_window(ctx, {"loop.lag"}))
