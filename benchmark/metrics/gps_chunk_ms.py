"""GPS: host ms of one IF chunk through the receiver (the span
``gps.chunk``, ``GpsManager.process`` in the receiver's executor job),
the mean over the chunks in the window."""

from __future__ import annotations

from _program import in_window, mean_ms


def read(ctx, name):
    return mean_ms(in_window(ctx, {"gps.chunk"}))
