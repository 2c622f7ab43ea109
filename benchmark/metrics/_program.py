"""Shared by the readers of the program's own spans: those of the port's
tracer (``flydog_sdr_gps_tpu_torch.utils.trace``), recorded inside the
ingest, the block loop, the fan-out and the graphs' captures on the host
clock the run's window is on (``time.monotonic``, in ns).  Readers run
in the harness's process after the run, so this reads ``get_trace()``
(a test gives a tracer of its own as ``ctx["tracer"]``).  A program
whose tracer keeps no spans gives none, and each reader returns None."""

from __future__ import annotations

import statistics


def records(ctx) -> list:
    tracer = ctx.get("tracer")
    if tracer is None:
        try:
            from flydog_sdr_gps_tpu_torch.utils.trace import get_trace
        except ImportError:
            return []
        tracer = get_trace()
    read = getattr(tracer, "span_records", None)
    return [] if read is None else read()


def in_window(ctx, names) -> list:
    """The spans of these names that started and ended inside
    ``ctx["window"]``.  One still open at its close is left out: the
    harness's work after the window (a traced run's profiler stop) may
    stall the loop inside it for seconds."""
    lo, hi = (t * 1e9 for t in ctx["window"])
    return [s for s in records(ctx)
            if s.name in names and lo <= s.t0 and s.t1 <= hi]


def before_window(ctx, names) -> list:
    """The spans of these names that started before the window."""
    lo = ctx["window"][0] * 1e9
    return [s for s in records(ctx) if s.name in names and s.t0 < lo]


def ms(s) -> float:
    return (s.t1 - s.t0) * 1e-6


def mean_ms(spans) -> float | None:
    """The mean span in ms."""
    return sum(ms(s) for s in spans) / len(spans) if spans else None


def mean_block_ms(spans) -> float | None:
    """The mean over blocks of the ms each block's spans add up to."""
    per: dict[int, float] = {}
    for s in spans:
        per[s.block] = per.get(s.block, 0.0) + ms(s)
    return sum(per.values()) / len(per) if per else None


def union_ns(spans, lo: float = float("-inf"), hi: float = float("inf")
             ) -> list[tuple[float, float]]:
    """The spans' intervals merged, cut at [lo, hi] (ns)."""
    iv = sorted((max(s.t0, lo), min(s.t1, hi)) for s in spans)
    out: list[list[float]] = []
    for a, b in iv:
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


COPY = "Memcpy HtoD (Pageable"      # a block's copy to the card
DRIFT_US = 25e3                     # the most the clocks drift in a trace


def clock_tie(ctx, t):
    """Host monotonic ns -> the device trace's us, and the correction
    made to the trace's own tie (ms at the trace window's start and end;
    None if none was needed).

    The trace ties its clock by a marker kernel, which can start tens of
    ms late (behind kernels that hold every SM), and the two clocks can
    drift apart over a run.  The block copies check the tie: a block's
    copy to the card (``engine.h2d``, from pageable memory) returns only
    once the copy is done, so each copy ends inside a call.  Where some
    do not, the shift that puts the most copies' ends inside calls (the
    smallest such) pairs each copy with a call, and a line through the
    gaps from the calls' ends to the copies' ends corrects the tie."""
    def marker(ns):
        return t.to_trace_us(ns * 1e-9)
    calls = sorted((marker(s.t0), marker(s.t1)) for s in records(ctx)
                   if s.name == "engine.h2d")
    calls = [c for c in calls if t.t_lo - 1e6 < c[1] < t.t_hi + 1e6]
    ends = sorted(e["ts"] + e["dur"] for e in t.copies
                  if e.get("name", "").startswith(COPY) and e["dur"] >= 1e3
                  and t.t_lo < e["ts"] and e["ts"] + e["dur"] < t.t_hi)

    def inside(d) -> int:
        return sum(1 for e in ends if any(c0 <= e - d <= c1
                                          for c0, c1 in calls))
    if not calls or inside(0.0) == len(ends):
        return marker, None
    shifts = sorted({e - c1 for e in ends for _c0, c1 in calls}, key=abs)
    d = max(shifts, key=inside)             # the first, so the smallest
    if inside(d) <= inside(0.0):
        return marker, None
    # each copy's call: the one whose end lies nearest the shifted copy's
    # end, if within DRIFT_US of it (else its call was not read)
    pairs = [(c1, e - c1) for e in ends for c1 in [min(
        (c1 for _c0, c1 in calls), key=lambda c1: abs(e - d - c1))]
        if abs(e - d - c1) <= DRIFT_US]
    x, y = [u for u, _v in pairs], [v for _u, v in pairs]
    mx, my = statistics.fmean(x), statistics.fmean(y)
    var = sum((u - mx) ** 2 for u in x)
    b = sum((u - mx) * (v - my) for u, v in zip(x, y)) / var if var else 0.0
    a = my - b * mx

    def tied(ns):
        u = marker(ns)
        return u + a + b * u
    return tied, ((a + b * t.t_lo) * 1e-3, (a + b * t.t_hi) * 1e-3)


def idle_inside(ctx, names) -> float | None:
    """Device-idle ms a traced block (no kernel on any stream; copies
    count as idle, as in ``device_idle_pct``) that falls inside the spans
    of these names, on the clock :func:`clock_tie` gives.  The blocks
    traced are the ``server.block`` spans that started inside the device
    trace's window."""
    t = ctx["trace"]
    if t is None or not t.kernels:
        return None
    spans = records(ctx)
    us, _fix = clock_tie(ctx, t)
    blocks = sum(1 for s in spans if s.name == "server.block"
                 and t.t_lo <= us(s.t0) <= t.t_hi)
    host = [(us(s.t0), us(s.t1)) for s in spans if s.name in names]
    if not blocks or not host:
        return None
    busy = t.union(t.kernels)
    idle, a = [], t.t_lo
    for b0, b1 in busy:
        if b0 > a:
            idle.append((a, b0))
        a = max(a, b1)
    if a < t.t_hi:
        idle.append((a, t.t_hi))
    inside = 0.0
    for h0, h1 in t.union([dict(ts=a, dur=b - a) for a, b in host]):
        for i0, i1 in idle:
            inside += max(0.0, min(h1, i1) - max(h0, i0))
    return inside * 1e-3 / blocks
