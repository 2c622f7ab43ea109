"""Event tracer — the `ev*()` ring-buffer profiler.

Reference: `support/debug.h:21-76` + `debug.cpp` — timestamped events
per subsystem in a ring, compile-selected measurement sets, dump on
trigger.  Here: always-on cheap ring (perf_counter_ns + deque) with
per-subsystem filters and a dump method; the block engine and server
emit events so stalls are diagnosable in production.
"""

from __future__ import annotations

import collections
import time

# subsystems (mirror of EV_NEXTTASK/SPILOOP/WF/SND/GPS/DPUMP naming)
EV_BLOCK, EV_SND, EV_WF, EV_GPS, EV_WS, EV_CTL = (
    "BLOCK", "SND", "WF", "GPS", "WS", "CTL")


class EventTrace:
    def __init__(self, depth: int = 4096, enabled: bool = True):
        self.ring = collections.deque(maxlen=depth)
        self.enabled = enabled
        self.filters: set[str] | None = None   # None = all

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


_global = EventTrace()


def ev(subsys: str, event: str, detail: str = "") -> None:
    _global.ev(subsys, event, detail)


def get_trace() -> EventTrace:
    return _global
