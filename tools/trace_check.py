"""The port's tracer on the card: what it costs, and whether its spans
agree with the benchmark's own, in runs of the benchmark's harness.

    python3 tools/trace_check.py cost [--workload <cell>] [--pairs 3] \
        [--seed N]
    python3 tools/trace_check.py agree --workload <cell> [--seed N] \
        [--dump FILE]
    python3 tools/trace_check.py micro

from the root of a checkout, on a machine with the card.  ``cost`` runs
the cell (by default ``kiwi12k_c4096.serve32_wf4``) 2 x pairs times in
one process, the tracer switched on and off in turns
(``get_trace().enabled``, set through the harness's ``install`` hook),
and prints each run's end-to-end metric (``rt_factor``, or
``snd_latency_p95_ms`` in a paced cell) and each side's median and
spread.  ``agree`` makes one traced run of the
cell, prints its result line (as ``benchmark/run.py --trace 1`` does),
then compares the program's spans with the wrappers the benchmark puts
around its methods: ``source.wait`` + ``source.pop`` against the outside
``source.next_block``, the inside fan-out's children and their loop lags
against the outside ``server.fanout``, the staged-ahead share of a staged
source's blocks (those whose ``engine.stage_wait`` was under 1 ms), and
the device-idle time of the traced blocks, by the program's span it
falls in (on the clock ``_program.clock_tie`` gives, with the correction
it made).  JSON lines on standard output; ``--cpu`` runs a small cell on
the CPU (a rehearsal).
``micro`` times the tracer's own work on this host, below the runs'
noise: one span (``EventTrace.span``, on and off), and what
``KiwiServer._job`` adds to an executor call (run inline, so that no
thread hop hides it); ``agree`` prints the spans a block to multiply
them by.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "benchmark", "metrics"))

FANOUT_KIDS = ("fanout.fetch_wait", "fanout.encode", "fanout.snd",
               "fanout.wf_row", "fanout.wf_send", "fanout.ext",
               "fanout.autorun")


def cell_of(name: str, cpu: bool):
    from benchmark import harness
    if not cpu:
        return harness.find_cell(ROOT, name)
    from benchmark.tests.tiny import tiny_cell
    cell = tiny_cell(traffic=name.split(".")[1], listeners=6, zooms=(0,))
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell.per_layer = [m for m in bench["per_layer"]
                      if name in m.get("workloads", [name])]
    return cell


def quartile_spread(values) -> float:
    q1, _q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def cost(args) -> None:
    from benchmark import harness
    from flydog_sdr_gps_tpu_torch.utils.trace import get_trace
    cell = cell_of(args.workload, args.cpu)
    metric = ("snd_latency_p95_ms" if cell.mix.get("pacing") == "paced"
              else "rt_factor")
    got: dict[bool, list[float]] = {True: [], False: []}
    for k in range(2 * args.pairs):
        on = (k % 4) in (0, 3)                # on, off, off, on, ...

        def install(eng, server, on=on):
            get_trace().enabled = on
        out = harness.run(cell, args.seed + k, args.seconds, False,
                          time.monotonic(), device=args.device,
                          install=install)
        get_trace().enabled = True
        got[on].append(out[metric])
        print(json.dumps({"run": k, "tracer": on, "seed": args.seed + k,
                          metric: out[metric], "setup_s": out["setup_s"]}),
              flush=True)
    summary = {}
    for on, v in got.items():
        summary["on" if on else "off"] = dict(
            median=statistics.median(v), runs=v,
            spread=quartile_spread(v) if len(v) >= 2 else None)
    # the share by which the tracer worsens the metric
    worse = summary["on"]["median"] / summary["off"]["median"] - 1.0
    summary["cost_pct"] = 100.0 * (-worse if metric == "rt_factor"
                                   else worse)
    print(json.dumps(summary), flush=True)


def micro(args) -> None:
    import asyncio
    from flydog_sdr_gps_tpu_torch.server.kiwi_server import KiwiServer
    from flydog_sdr_gps_tpu_torch.utils.trace import EventTrace, get_trace
    n, reps = 200_000, 7

    def per_call(fn) -> float:
        """The fastest of ``reps`` loops of ``n`` calls, ns a call."""
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter_ns()
            fn()
            best = min(best, (time.perf_counter_ns() - t0) / n)
        return best
    res: dict = {}
    for on in (True, False):
        tr = EventTrace(enabled=on)

        def spans(tr=tr):
            for _ in range(n):
                tr.span("source.pop", 7, time.monotonic_ns())
        res[f"span_ns_{'on' if on else 'off'}"] = per_call(spans)

    def bare():
        for _ in range(n):
            time.monotonic_ns()
    res["loop_and_clock_ns"] = per_call(bare)

    class InlineLoop(asyncio.SelectorEventLoop):
        """Runs an executor job at once, in the caller's thread."""
        def run_in_executor(self, executor, fn, *a):
            fut = self.create_future()
            fut.set_result(fn(*a))
            return fut

    def nothing():
        return None

    async def plain():
        loop = asyncio.get_running_loop()
        for _ in range(n):
            await loop.run_in_executor(None, nothing)

    async def wrapped():
        for _ in range(n):              # _job reads nothing of its server
            await KiwiServer._job(None, "fanout.encode", 7,
                                  "server.fanout", nothing)
    loop = InlineLoop()
    try:
        for on in (True, False):
            get_trace().enabled = on
            p = per_call(lambda: loop.run_until_complete(plain()))
            w = per_call(lambda: loop.run_until_complete(wrapped()))
            res[f"job_added_ns_{'on' if on else 'off'}"] = w - p
        res["executor_call_inline_ns"] = p
    finally:
        get_trace().enabled = True
        loop.close()
    print(json.dumps(res), flush=True)


def staged_ahead(spans) -> dict | None:
    """The blocks of a staged source (``engine.stage_wait``, the step's
    thread's wait for its staged block): how many, the mean and longest
    wait, and the share staged ahead, whose wait was under 1 ms."""
    import _program as prg
    waits = [prg.ms(s) for s in spans if s.name == "engine.stage_wait"]
    if not waits:
        return None
    return dict(blocks=len(waits), wait_ms=statistics.mean(waits),
                wait_max_ms=max(waits), staged_ahead_pct=100.0 * sum(
                    1 for w in waits if w < 1.0) / len(waits))


def agree(args) -> None:
    from benchmark import harness, report
    import _program as prg
    cell = cell_of(args.workload, args.cpu)
    trace = not args.cpu
    out = harness.run(cell, args.seed, args.seconds, trace, T_START,
                      device=args.device)
    if trace:
        from benchmark.run import power_limit
        print(json.dumps(report.result_line(cell, out, True, power_limit())),
              flush=True)
    ctx = dict(window=out["window"], trace=out["trace"])
    w0, w1 = out["window"]
    # spans that began and ended in the window: one still open at its
    # close is stretched by the harness's work after it (the profiler's
    # stop blocks the loop), and is shown apart
    outside = [s for s in out["spans"] if w0 <= s[2] and s[3] <= w1]
    inside = [s for s in prg.records(ctx)
              if w0 * 1e9 <= s.t0 and s.t1 <= w1 * 1e9]
    res: dict = {"workload": cell.name, "open_at_close": [
        dict(name=n, block=b, ms=(e - a) * 1e3, ends_after_window_s=e - w1)
        for n, b, a, e in out["spans"] if w0 <= a <= w1 < e]}
    n_blocks = sum(1 for s in inside if s.name == "server.block")
    if n_blocks:
        res["spans_a_block"] = len(inside) / n_blocks
        res["jobs_a_block"] = sum(1 for s in inside
                                  if s.name == "loop.lag") / n_blocks

    # the ingest: source.wait + source.pop against the source.next_block
    # call they lie in (paired by time: a staged source takes its blocks
    # ahead of the engine whose number the outside span bears)
    rows = []
    for n, _b, a, e in outside:
        if n != "source.next_block":
            continue
        got = {k: sum(prg.ms(s) for s in inside if s.name == k
                      and a * 1e9 <= s.t0 and s.t1 <= e * 1e9)
               for k in ("source.wait", "source.pop")}
        if got["source.pop"]:
            rows.append(((e - a) * 1e3, got["source.wait"],
                         got["source.pop"]))
    if rows:
        o = statistics.mean(r[0] for r in rows)
        i = statistics.mean(r[1] + r[2] for r in rows)
        res["ingest"] = dict(blocks=len(rows), outside_next_block_ms=o,
                             wait_ms=statistics.mean(r[1] for r in rows),
                             pop_ms=statistics.mean(r[2] for r in rows),
                             inside_ms=i, gap_pct=100.0 * (i - o) / o)
    # the staged ingest: how long the step's thread waited for its block
    stage = staged_ahead(inside)
    if stage is not None:
        res["stage"] = stage
    # the fan-out: children and their loop lags inside the outside span
    fan = {b: (a * 1e9, e * 1e9) for n, b, a, e in outside
           if n == "server.fanout"}
    covered, total, parts, gaps = 0.0, 0.0, {}, {}
    for b, (a, e) in fan.items():
        kids = [s for s in inside if s.block == b and (
            s.name in FANOUT_KIDS or (s.name == "loop.lag"
                                      and s.parent in FANOUT_KIDS))]
        if not kids:
            continue
        iv = prg.union_ns(kids, a, e)
        covered += sum(y - x for x, y in iv)
        total += e - a
        for s in kids:
            parts[s.name] = parts.get(s.name, 0.0) + prg.ms(s) / len(fan)
        # the uncovered time, by the spans on either side of it
        kids.sort(key=lambda s: s.t0)
        edge, before = a, "start"
        for s in kids + [None]:
            t = e if s is None else s.t0
            if t > edge:
                key = f"{before} -> {'end' if s is None else s.name}"
                gaps[key] = gaps.get(key, 0.0) + (t - edge) * 1e-6 / len(fan)
            if s is not None and s.t1 > edge:
                edge, before = s.t1, s.name
    if total:
        res["fanout"] = dict(blocks=len(fan), outside_ms=total * 1e-6
                             / len(fan), covered_pct=100.0 * covered / total,
                             uncovered_ms=(total - covered) * 1e-6
                             / len(fan), parts_ms=parts, gaps_ms=gaps)
    # device-idle ms a traced block, by the program's span it falls in
    t = out["trace"]
    if t is not None and t.kernels:
        groups = [
            ("ingest", {"source.wait", "source.pop", "engine.h2d",
                        "engine.stage_wait"}),
            ("fanout", {"server.fanout"} | set(FANOUT_KIDS)),
            ("step, not ingest", {"server.step"}),
            ("wf_ingest", {"server.wf_ingest"}),
            ("block loop, other", {"server.block"}),
        ]
        done: set = set()
        split = {}
        for label, names in groups:
            done |= names
            split[label] = prg.idle_inside(ctx, done)
        us, fix = prg.clock_tie(ctx, t)
        blocks = sum(1 for s in inside if s.name == "server.block"
                     and t.t_lo <= us(s.t0) <= t.t_hi)
        busy = t.covered_s(t.union(t.kernels))
        idle_ms = (t.window_s - busy) * 1e3 / blocks if blocks else None
        # cumulative: each group's idle ms is what the groups up to it
        # cover together
        res["idle"] = dict(blocks=blocks, tie_fix_ms=fix,
                           idle_ms_a_block=idle_ms,
                           cumulative_ms=split,
                           ingest_plus_fanout_pct=(
                               100.0 * (split["fanout"] or 0.0) / idle_ms
                               if idle_ms else None))
    print(json.dumps(res), flush=True)
    if args.dump and t is not None:
        # the spans and device intervals around the traced blocks, on the
        # trace's own clock (us; its marker's tie, and the correction
        # the block copies make to it), for a look by hand
        fix = prg.clock_tie(ctx, t)[1]
        spans = [[s.name, s.block, t.to_trace_us(s.t0 * 1e-9),
                  t.to_trace_us(s.t1 * 1e-9), s.parent, s.thread]
                 for s in inside if t.t_lo - 1e6 <= t.to_trace_us(s.t1 * 1e-9)
                 and t.to_trace_us(s.t0 * 1e-9) <= t.t_hi + 1e6]
        dev = [[e["name"][:60], e.get("args", {}).get("stream", -1),
                e["ts"], e["ts"] + e["dur"], e.get("cat")]
               for e in t.kernels + t.copies]
        with open(args.dump, "w") as f:
            json.dump(dict(window_us=[t.t_lo, t.t_hi], tie_fix_ms=fix,
                           spans=spans, device=dev), f)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("cost", "agree", "micro"))
    ap.add_argument("--workload", default="kiwi12k_c4096.serve32_wf4")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 77)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--dump", help="write the traced window's spans and "
                    "device intervals to this JSON file (agree)")
    args = ap.parse_args(argv)
    from benchmark.run import caches_in_checkout
    caches_in_checkout()
    args.device = "cpu" if args.cpu else "cuda"
    if args.seconds is None:
        args.seconds = 4.0 if args.cpu else harness_seconds()
    if not args.cpu:
        import torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    {"cost": cost, "agree": agree, "micro": micro}[args.mode](args)
    return 0


def harness_seconds() -> float:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return float(json.load(f)["run_seconds"])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
