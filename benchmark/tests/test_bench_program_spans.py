"""The readers of the program's own spans (``metrics/_program.py`` and
the metrics that use it) on a run made up here: a tracer holding known
spans, a window and a device trace with known kernels.  Each reader
returns the number worked out by hand below, and None when its spans
(or, for the idle metrics, the device trace) are not there."""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.trace import DeviceTrace
from flydog_sdr_gps_tpu_torch.utils.trace import EventTrace

S = 1e9                     # ns a second

# (name, block, start s, end s, parent)
SPANS = [
    # set-up, before the window (10 s to 11 s): first run 1.0-3.0 with the
    # kernels' build inside it, then its capture; a capture that crosses
    # the window's start counts up to it; one inside the window does not
    ("graphs.first_run", -1, 1.0, 3.0, ""),
    ("build.load", -1, 1.5, 2.5, ""),
    ("graphs.capture", -1, 3.0, 3.5, ""),
    ("graphs.capture", -1, 9.8, 10.2, ""),
    ("graphs.capture", -1, 10.5, 10.6, ""),
    # two blocks of the loop inside the window
    ("server.block", 5, 10.0, 10.5, ""),
    ("server.block", 6, 10.5, 11.0, ""),
    # ingest of blocks 5 and 6
    ("source.wait", 5, 10.0, 10.05, ""),
    ("source.pop", 5, 10.05, 10.08, ""),
    ("engine.h2d", 5, 10.08, 10.12, ""),
    ("source.wait", 6, 10.5, 10.5, ""),
    ("source.pop", 6, 10.5, 10.55, ""),
    ("engine.h2d", 6, 10.55, 10.62, ""),
    ("source.queued", 5, 9.0, 10.0, ""),          # pushed before the window
    ("source.queued", 6, 10.2, 10.5, ""),
    ("source.queued", 7, 10.6, 10.7, ""),
    # fan-out of blocks 4 and 5
    ("server.fanout", 4, 10.3, 10.45, "server.block"),
    ("fanout.fetch_wait", 4, 10.3, 10.32, "server.fanout"),
    ("fanout.encode", 4, 10.32, 10.36, "server.fanout"),
    ("loop.lag", 4, 10.36, 10.361, "fanout.encode"),
    ("fanout.wf_row", 4, 10.361, 10.381, "server.fanout"),
    ("loop.lag", 4, 10.381, 10.383, "fanout.wf_row"),
    ("fanout.wf_row", 4, 10.383, 10.413, "server.fanout"),
    ("server.fanout", 5, 10.8, 10.9, "server.block"),
    ("fanout.fetch_wait", 5, 10.8, 10.81, "server.fanout"),
    ("fanout.encode", 5, 10.81, 10.83, "server.fanout"),
    ("loop.lag", 5, 10.83, 10.835, "fanout.encode"),
    ("fanout.wf_row", 5, 10.835, 10.845, "server.fanout"),
    # a fan-out still open when the window closed, stretched by what the
    # harness does after it: not counted
    ("fanout.wf_row", 6, 10.95, 14.0, "server.fanout"),
    ("loop.lag", 6, 10.99, 14.0, "fanout.wf_row"),
]
# kernels (trace us = host s x 1e6): busy 10.1-10.3 and 10.6-10.8, so
# idle 10.0-10.1, 10.3-10.6 and 10.8-11.0
KERNELS = [(10.1, 10.3), (10.6, 10.8)]

WANT = {
    "ingest_pop_ms.free": (30 + 50) / 2,
    "h2d_host_ms.free": (40 + 70) / 2,
    # idle inside the ingest: 10.0-10.1 and 10.5-10.6, over two blocks
    "idle_ingest_ms.free": (100 + 100) / 2,
    # idle inside the fan-out: 10.3-10.45 and 10.8-10.9
    "idle_fanout_ms.free": (150 + 100) / 2,
    "fetch_wait_ms.free": (20 + 10) / 2,
    "encode_ms.free": (40 + 20) / 2,
    "wf_row_ms.free": ((20 + 30) + 10) / 2,
    "loop_lag_ms.free": ((1 + 2) + 5) / 2,
    "loop_lag_ms.paced": ((1 + 2) + 5) / 2,
    "ingest_lag_ms.paced": (300 + 100) / 2,
    # 1.0-3.5, and 9.8-10.0
    "capture_s.free": 2.5 + 0.2,
}


def tracer(spans=SPANS) -> EventTrace:
    tr = EventTrace()
    for name, block, a, b, parent in spans:
        tr.span(name, block, round(a * S), parent, t1=round(b * S))
    return tr


def device_trace() -> DeviceTrace:
    events = [dict(cat="kernel", name="k", ts=a * 1e6, dur=(b - a) * 1e6)
              for a, b in KERNELS]
    return DeviceTrace(events, 0.0, 0.0, (10.0, 11.0))


def ctx(tr, trace=True) -> dict:
    return dict(tracer=tr, window=(10.0, 11.0),
                trace=device_trace() if trace else None)


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_reads_the_known_spans(metric):
    got = harness.reader(metric)(ctx(tracer()), metric)
    assert got == pytest.approx(WANT[metric], rel=1e-9, abs=1e-9)


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_without_its_spans_returns_none(metric):
    read = harness.reader(metric)
    assert read(ctx(EventTrace()), metric) is None
    # a tracer that keeps no spans at all (the program before it had any)
    assert read(ctx(object()), metric) is None
    # only the block loop's own spans
    other = [s for s in SPANS if s[0] == "server.block"]
    assert read(ctx(tracer(other)), metric) is None


@pytest.mark.parametrize("metric", ["idle_ingest_ms.free",
                                    "idle_fanout_ms.free"])
def test_idle_reader_without_a_device_trace_returns_none(metric):
    assert harness.reader(metric)(ctx(tracer(), trace=False), metric) is None


def test_each_new_metric_is_declared_for_its_cell():
    import json
    import os
    bench = json.load(open(os.path.join(harness.HERE, os.pardir,
                                        "BENCHMARK.json")))
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for metric in WANT:
        m = per_layer[metric]
        assert m["source"] == ("device_trace" if metric.startswith("idle_")
                               else "program_span")
        cell = "kiwi12k_c4096.serve32_wf4" + (
            "_paced" if metric.endswith(".paced") else "")
        assert m["workloads"] == [cell]


@pytest.mark.parametrize("late_s", [0.0, 0.04, -0.035])
def test_idle_readers_tie_the_trace_by_the_block_copies(late_s):
    # four blocks 0.2 s apart: the pop, then the copy to the card (its
    # device part ends as the host call, which waits for it, returns),
    # the step's kernels, and the fan-out over the kernels' end: 80 ms of
    # idle inside the ingest and 30 inside the fan-out a block.  A trace
    # whose marker is off by ``late_s`` reads the same.
    spans, events = [], []
    for k, s in enumerate((10.1, 10.3, 10.5, 10.7)):
        spans += [("server.block", k, s, s + 0.2, ""),
                  ("source.pop", k, s, s + 0.05, ""),
                  ("engine.h2d", k, s + 0.05, s + 0.08, ""),
                  ("server.fanout", k, s + 0.1, s + 0.18, "server.block")]
        d = s + late_s
        events += [dict(cat="gpu_memcpy", name="Memcpy HtoD (Pageable -> "
                        "Device)", ts=(d + 0.065) * 1e6, dur=0.015e6),
                   dict(cat="kernel", name="k", ts=(d + 0.08) * 1e6,
                        dur=0.07e6)]
    c = dict(tracer=tracer(spans), window=(10.0, 11.0),
             trace=DeviceTrace(events, 0.0, 0.0, (10.0, 11.0)))
    for metric, want in (("idle_ingest_ms.free", 80.0),
                         ("idle_fanout_ms.free", 30.0)):
        got = harness.reader(metric)(c, metric)
        assert got == pytest.approx(want, rel=1e-6)
