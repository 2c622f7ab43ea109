"""Engine: host ms of one clock correction's retune of every channel
(the span ``engine.retune``, ``StreamEngine.retune_all`` on the caller's
thread), the mean over those in the window, or over the run's when the
window holds none."""

from __future__ import annotations

from _program import in_window, mean_ms, records

NAMES = {"engine.retune"}


def read(ctx, name):
    spans = in_window(ctx, NAMES) or [s for s in records(ctx)
                                      if s.name in NAMES]
    return mean_ms(spans)
