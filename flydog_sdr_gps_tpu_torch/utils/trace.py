"""Event tracer — the `ev*()` ring-buffer profiler, and spans.

Reference: `support/debug.h:21-76` + `debug.cpp` — timestamped events
per subsystem in a ring, compile-selected measurement sets, dump on
trigger.  Here: always-on cheap ring (perf_counter_ns + deque) with
per-subsystem filters and a dump method; the block engine and server
emit events so stalls are diagnosable in production.

Spans, beside the ring: finished intervals of the program's own layers
(the ingest, the block loop, the fan-out, the graphs' captures), each
with the number of the block it worked on (``StreamEngine.seq`` when the
block was dispatched; -1 for none), its start and end on the
``time.monotonic_ns`` clock, the name of the span it lies in (the
``parent``, "" at the top), its thread's name and a ``detail`` (a
graph's key).  They are kept in a store of their own, deep enough for a
set-up and a long run without eviction, and read in memory
(:meth:`EventTrace.span_records`); recording one costs a clock read and
an append.  ``enabled`` switches the ring and the spans together.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import NamedTuple

# subsystems (mirror of EV_NEXTTASK/SPILOOP/WF/SND/GPS/DPUMP naming)
EV_BLOCK, EV_SND, EV_WF, EV_GPS, EV_WS, EV_CTL = (
    "BLOCK", "SND", "WF", "GPS", "WS", "CTL")

# set-up plus minutes of blocks at ~8 blocks/s and ~25 spans a block
SPAN_DEPTH = 1 << 16


class Span(NamedTuple):
    """One finished span; ``t0``/``t1`` in ``time.monotonic_ns``."""
    name: str
    block: int
    t0: int
    t1: int
    parent: str
    thread: str
    detail: object


class EventTrace:
    def __init__(self, depth: int = 4096, enabled: bool = True):
        self.ring = collections.deque(maxlen=depth)
        self.enabled = enabled
        self.filters: set[str] | None = None   # None = all
        self.span_store = collections.deque(maxlen=SPAN_DEPTH)

    def ev(self, subsys: str, event: str, detail: str = "") -> None:
        if not self.enabled:
            return
        if self.filters is not None and subsys not in self.filters:
            return
        self.ring.append((time.perf_counter_ns(), subsys, event, detail))

    def dump(self, last: int = 200) -> list[str]:
        items = list(self.ring)[-last:]
        if not items:
            return []
        t0 = items[0][0]
        return [f"{(t - t0) / 1e6:10.3f}ms {s:5s} {e} {d}"
                for (t, s, e, d) in items]

    def spans(self, subsys: str, start_ev: str, end_ev: str
              ) -> list[float]:
        """Matched start/end durations in ms (simple profiler)."""
        out = []
        t_start = None
        for (t, s, e, _d) in self.ring:
            if s != subsys:
                continue
            if e == start_ev:
                t_start = t
            elif e == end_ev and t_start is not None:
                out.append((t - t_start) / 1e6)
                t_start = None
        return out

    # -- spans -------------------------------------------------------------
    def span(self, name: str, block: int, t0: int, parent: str = "",
             detail=None, t1: int | None = None) -> None:
        """Record span ``name`` of ``block`` from ``t0`` (a
        ``time.monotonic_ns()`` reading) to ``t1``, by default now."""
        if not self.enabled:
            return
        if t1 is None:
            t1 = time.monotonic_ns()
        self.span_store.append((name, block, t0, t1, parent,
                                threading.current_thread().name, detail))

    def span_records(self) -> list[Span]:
        """Every span in the store, in the order they ended."""
        return [Span(*s) for s in list(self.span_store)]

    def dump_spans(self, last: int = 200) -> list[str]:
        items = self.span_records()[-last:]
        if not items:
            return []
        t0 = min(s.t0 for s in items)
        return [f"{(s.t0 - t0) / 1e6:10.3f}ms {(s.t1 - s.t0) / 1e6:9.3f}ms "
                f"{s.name} #{s.block} <{s.parent}> {s.thread}"
                + ("" if s.detail is None else f" {s.detail}")
                for s in items]


_global = EventTrace()


def ev(subsys: str, event: str, detail: str = "") -> None:
    _global.ev(subsys, event, detail)


def get_trace() -> EventTrace:
    return _global
