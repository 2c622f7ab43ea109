"""The device trace of a traced run, reduced.

``torch.profiler`` (device activity only, so that it costs the host
little) runs over a stated number of steady blocks in the window; its
Chrome trace is read back as kernel, copy and set intervals on each
stream.  A marker kernel launched on a stream of its own at a known
instant of the host's monotonic clock ties the trace's clock to the host
spans, so that an idle gap can be named by what the host was doing.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

MARK = "spin_kernel"


class DeviceTrace:
    """The device intervals of a host window [t_a, t_b] (monotonic
    seconds), an interval cut at the window's edges."""

    def __init__(self, events: list[dict], t_host0: float, ts0: float,
                 window: tuple[float, float]):
        self._t_host0, self._ts0 = t_host0, ts0
        self.window_s = window[1] - window[0]
        lo, hi = (self.to_trace_us(t) for t in window)
        self.t_lo, self.t_hi = lo, hi

        def clip(evs):
            out = []
            for e in evs:
                a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
                if b > a:
                    out.append(dict(e, ts=a, dur=b - a))
            return out
        self.kernels = clip([e for e in events if e.get("cat") == "kernel"
                             and MARK not in e.get("name", "")])
        self.copies = clip([e for e in events
                            if e.get("cat") in ("gpu_memcpy", "gpu_memset")])

    def to_trace_us(self, t_host: float) -> float:
        return self._ts0 + (t_host - self._t_host0) * 1e6

    @staticmethod
    def union(evs) -> list[tuple[float, float]]:
        iv = sorted((e["ts"], e["ts"] + e["dur"]) for e in evs)
        out: list[list[float]] = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @staticmethod
    def covered_s(iv) -> float:
        return sum(b - a for a, b in iv) * 1e-6

    def streams(self) -> dict[int, list[dict]]:
        out: dict[int, list[dict]] = {}
        for e in self.kernels:
            out.setdefault(e.get("args", {}).get("stream", -1), []).append(e)
        return out

    def top_ops(self, n: int = 10) -> list[list]:
        tot: dict[str, float] = {}
        for e in self.kernels + self.copies:
            tot[e["name"]] = tot.get(e["name"], 0.0) + e["dur"] * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, spans, n: int = 10) -> list[list]:
        """The longest gaps with nothing on the device, each named by the
        innermost host span that covers most of it (the shortest of those
        that cover at least half of it, else the one that covers most)."""
        iv = self.union(self.kernels + self.copies)
        gaps = [(b0, a1) for (_, b0), (a1, _) in zip(iv, iv[1:]) if a1 > b0]
        gaps.sort(key=lambda g: g[0] - g[1])
        host = [(name, self.to_trace_us(t0), self.to_trace_us(t1))
                for name, _b, t0, t1 in spans]
        out = []
        for g0, g1 in gaps[:n]:
            over = [(min(g1, h1) - max(g0, h0), h1 - h0, name)
                    for name, h0, h1 in host if min(g1, h1) > max(g0, h0)]
            half = [o for o in over if o[0] >= 0.5 * (g1 - g0)]
            if half:
                label = min(half, key=lambda o: o[1])[2]
            elif over:
                label = max(over)[2]
            else:
                label = "host: no span"
            out.append([label, (g1 - g0) * 1e-6])
        return out


class Profiler:
    """torch.profiler over the window (CUDA activity only).  ``prime``
    runs one empty session in set-up, so that the tracer's first start,
    which takes seconds, falls outside the window."""

    def __init__(self, torch):
        self.torch = torch
        from torch.profiler import ProfilerActivity, profile
        self._profile = lambda: profile(activities=[ProfilerActivity.CUDA])
        self._prof = None
        self._side = torch.cuda.Stream()
        self.t0 = self.t1 = None
        self.window = None

    def prime(self) -> None:
        p = self._profile()
        p.start()
        with self.torch.cuda.stream(self._side):
            self.torch.cuda._sleep(1000)
        p.stop()

    def start(self) -> None:
        self._prof = self._profile()
        self._prof.start()
        with self.torch.cuda.stream(self._side):
            self.t0 = time.monotonic()
            self.torch.cuda._sleep(1000)        # the clock's marker

    def stop(self) -> None:
        self.t1 = time.monotonic()
        self._prof.stop()

    def read(self) -> DeviceTrace:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        for e in events:
            if "ts" in e:
                e["ts"] = float(e["ts"])
                e["dur"] = float(e.get("dur", 0.0))
        marks = [e for e in events if e.get("cat") == "kernel"
                 and MARK in e.get("name", "")]
        ts0 = marks[0]["ts"] if marks else min(
            (e["ts"] for e in events if e.get("cat") == "kernel"),
            default=0.0)
        return DeviceTrace(events, self.t0, ts0, self.window or
                           (self.t0, self.t1))
