"""Server: how long a fetched block waited on the host before its
fan-out started, the median over the window's blocks of the span
``fanout.held`` (from the end of the block's ``server.fetch`` job to the
start of its ``server.fanout``; no time where the fan-out was there
first)."""

from __future__ import annotations

import statistics

from _program import in_window, ms


def read(ctx, name):
    spans = in_window(ctx, {"fanout.held"})
    return statistics.median(ms(s) for s in spans) if spans else None
