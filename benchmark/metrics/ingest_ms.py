"""Ingest: the program's ``ThreadedSource`` ring and ``StreamEngine.
_next_x``.  Free: host ms a block of the ring pop (the source's
``next_block`` span) plus device ms a block of the copies to the card.
Paced: ms from a block's due time until it is on the card (the end of
``_next_x``), the wait a listener pays before the step can start."""

from __future__ import annotations

import numpy as np


def read(ctx, name):
    t0, t1 = ctx["window"]
    spans = ctx["spans"]
    if ctx["paced"]:
        due = ctx["due"]
        ages = [(e - due[b]) * 1e3 for s, b, _a, e in spans
                if s == "engine._next_x" and b in due and t0 <= due[b] <= t1]
        return float(np.mean(ages)) if ages else None
    pops = [(e - a) * 1e3 for s, _b, a, e in spans
            if s == "source.next_block" and t0 <= a <= t1]
    t = ctx["trace"]
    steps = [a for s, _b, a, _e in spans if s == "engine.run_block_gather"]
    if not pops or t is None:
        return None
    blocks = sum(1 for a in steps if t.t_lo <= t.to_trace_us(a) <= t.t_hi)
    h2d = sum(e["dur"] for e in t.copies if "htod" in e["name"].lower())
    if not blocks:
        return None
    return float(np.mean(pops)) + h2d * 1e-3 / blocks
