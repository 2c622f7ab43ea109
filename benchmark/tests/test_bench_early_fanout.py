"""The readers of the span ``fanout.held`` (``metrics/fanout_held_ms.py``,
``metrics/early_fanout_pct.py``) on known spans: a window of 10 s to 11 s
holding four blocks' spans, one more that ends after the window closed,
and one that started before it.  Each returns None where the program
records no such span."""

from __future__ import annotations

import json
import os

import pytest

from benchmark import harness
from flydog_sdr_gps_tpu_torch.utils.trace import EventTrace

S = 1e9

# (block, start s, end s, detail)
HELD = [
    (3, 9.95, 10.01, "after_next"),          # started before the window
    (4, 10.10, 10.102, "early"),
    (5, 10.30, 10.304, "early"),
    (6, 10.50, 10.50, "after_next"),         # the fan-out was there first
    (7, 10.70, 10.701, "early"),
    (8, 10.99, 11.20, "early"),              # still open at the close
]

WANT = {
    # 2, 4, 0, 1 ms
    "fanout_held_ms.paced": 1.5,
    "early_fanout_pct.paced": 75.0,
    "early_fanout_pct.free": 75.0,
}


def tracer(held=HELD, other=True) -> EventTrace:
    tr = EventTrace()
    for block, a, b, detail in held:
        tr.span("fanout.held", block, round(a * S), "", detail,
                t1=round(b * S))
    if other:
        for block in range(4, 8):
            a = 10.1 + 0.2 * (block - 4)
            tr.span("server.fanout", block, round(a * S), "server.block",
                    t1=round((a + 0.05) * S))
    return tr


def ctx(tr) -> dict:
    return dict(tracer=tr, window=(10.0, 11.0), trace=None)


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_reads_the_known_spans(metric):
    got = harness.reader(metric)(ctx(tracer()), metric)
    assert got == pytest.approx(WANT[metric], rel=1e-9, abs=1e-9)


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_without_the_span_returns_none(metric):
    read = harness.reader(metric)
    assert read(ctx(EventTrace()), metric) is None
    # a tracer that keeps no spans at all
    assert read(ctx(object()), metric) is None
    # the fan-out's spans without ``fanout.held`` (the program before it)
    assert read(ctx(tracer(held=[])), metric) is None
    # only spans outside the window
    assert read(ctx(tracer(held=[HELD[0], HELD[-1]])), metric) is None


@pytest.mark.parametrize("detail,want", [("early", 100.0),
                                         ("after_next", 0.0)])
def test_early_share_of_one_kind(detail, want):
    held = [(b, a, e, detail) for b, a, e, _d in HELD]
    got = harness.reader("early_fanout_pct.free")(ctx(tracer(held)),
                                                  "early_fanout_pct.free")
    assert got == want


def test_each_metric_is_declared_for_its_cell():
    bench = json.load(open(os.path.join(harness.HERE, os.pardir,
                                        "BENCHMARK.json")))
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for metric in WANT:
        m = per_layer[metric]
        assert m["source"] == "program_span"
        assert m["layer"] == ("Server: server/kiwi_server.py block loop "
                              "and fan-out")
        paced = metric.endswith(".paced")
        assert m["workloads"] == ["kiwi12k_c4096.serve32_wf4"
                                  + ("_paced" if paced else "")]
        assert m["moves"] == ("snd_latency_p95_ms" if paced
                              else "rt_factor")
