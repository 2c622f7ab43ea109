"""Server: the share (%) of the window's fanned-out blocks that went out
while the next block's step still ran (the span ``fanout.held`` with the
detail ``early``), against those that went out after it
(``after_next``)."""

from __future__ import annotations

from _program import in_window


def read(ctx, name):
    spans = in_window(ctx, {"fanout.held"})
    if not spans:
        return None
    return 100.0 * sum(s.detail == "early" for s in spans) / len(spans)
