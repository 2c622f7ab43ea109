"""The GPS cell's readers (``metrics/retune_ms.py``, ``gps_chunk_ms.py``,
``gps_device_ms.py``, ``gps_track_roofline_pct.py``) on a run made up
here: a tracer holding known spans, a window and a device trace with
known kernels on two streams.  Each returns the number worked out by hand
below, and None where it finds nothing to read (the parent's program,
which records no GPS or retune span, or a cell without the receiver).
The GPS cell's files are declared as the harness finds them."""

from __future__ import annotations

import json
import os

import pytest

from benchmark import harness, roofline
from benchmark.trace import DeviceTrace
from flydog_sdr_gps_tpu_torch.utils.trace import EventTrace

S = 1e9
CELL = "kiwi12k_c4096_gps.serve32_wf4"
CFG = harness.load_json(os.path.join(harness.HERE, "configs",
                                     "kiwi12k_c4096_gps.json"))

# (name, block, start s, end s, detail); the window is 10 s to 11 s
SPANS = [
    ("engine.retune", 3, 5.0, 5.004, None),          # set-up
    ("engine.retune_apply", 3, 5.003, 5.0031, None),
    ("engine.retune", 40, 10.2, 10.206, None),
    ("engine.retune", 44, 10.6, 10.602, None),
    ("engine.retune", 50, 10.99, 12.0, None),        # open at the close
    ("gps.chunk", 20, 9.9, 10.1, None),              # began before it
    ("gps.chunk", 21, 10.3, 10.35, "search"),
    ("gps.chunk", 22, 10.7, 10.71, None),
    ("gps.solve", 22, 10.71, 10.72, None),
    ("gps.correction", 22, 10.72, 10.73, "applied"),
]
# engine stream 7 (kernel 1 once a block, two blocks), receiver stream 9
# (kernel 6 twice, 1.2 ms each, and 0.3 ms of other kernels); one launch
# of kernel 6 cut by the window's start is left out of the roofline
KERNELS = [
    (7, "stage2_kernel<31, 24, true>", 10.10, 0.02),
    (7, "stage2_kernel<31, 24, true>", 10.50, 0.02),
    (9, "gps_track_kernel", 9.9995, 0.0010),
    (9, "gps_track_kernel", 10.30, 0.0012),
    (9, "gps_track_kernel", 10.70, 0.0012),
    (9, "vectorized_elementwise_kernel", 10.71, 0.0003),
]
GRID = [96, 1, 1]                   # 12 rows of 8-block clusters


def tracer(spans=SPANS) -> EventTrace:
    tr = EventTrace()
    for name, block, a, b, detail in spans:
        tr.span(name, block, round(a * S), detail=detail, t1=round(b * S))
    return tr


def device_trace(kernels=KERNELS) -> DeviceTrace:
    events = [dict(cat="kernel", name=n, ts=a * 1e6, dur=d * 1e6,
                   args=dict(stream=s, grid=GRID)) for s, n, a, d in kernels]
    return DeviceTrace(events, 0.0, 0.0, (10.0, 11.0))


def ctx(tr, trace=True, cfg=CFG) -> dict:
    return dict(tracer=tr, window=(10.0, 11.0), cfg=cfg,
                trace=device_trace() if trace else None,
                roofline=roofline, kernel_names=harness.kernel_names)


# the window holds 1 s of IF, 2.5 chunks of 0.4 s
SAMPLES = round(0.4 * 16.368e6)
WANT = {
    "retune_ms.gps": (6 + 2) / 2,
    "gps_chunk_ms.gps": (50 + 10) / 2,
    # kernel 6's part inside the window (0.5 ms of the cut launch), the
    # two whole launches and the other kernel, over 2.5 chunks
    "gps_device_ms.gps": (0.5 + 1.2 + 1.2 + 0.3) / 2.5,
    "gps_track_roofline_pct.gps": 100.0 * (2 * 19 * 12 * SAMPLES / 67e12)
    / 2.4e-3,
}


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_reads_the_known_run(metric):
    got = harness.reader(metric)(ctx(tracer()), metric)
    assert got == pytest.approx(WANT[metric], rel=1e-9)


def test_retune_ms_reads_the_runs_retunes_when_the_window_has_none():
    spans = [s for s in SPANS if not (s[0] == "engine.retune"
                                      and 10.0 <= s[2] < 10.9)]
    got = harness.reader("retune_ms.gps")(ctx(tracer(spans)), "retune_ms.gps")
    assert got == pytest.approx((4 + 1010) / 2, rel=1e-9)


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_finds_nothing_to_read(metric):
    read = harness.reader(metric)
    # the parent's program: no GPS or retune span, no kernel 6
    engine_only = [k for k in KERNELS if k[0] == 7]
    c = dict(ctx(EventTrace()), trace=device_trace(engine_only))
    assert read(c, metric) is None
    assert read(ctx(object(), trace=False), metric) is None


def test_roofline_share_without_the_grid_counts_the_banks_rows():
    read = harness.reader("gps_track_roofline_pct.gps")
    t = device_trace()
    for e in t.kernels:
        e["args"].pop("grid")
    got = read(dict(ctx(tracer()), trace=t), "gps_track_roofline_pct.gps")
    assert got == pytest.approx(WANT["gps_track_roofline_pct.gps"], rel=1e-9)


def test_the_gps_cell_is_declared_as_the_harness_finds_it():
    cell = harness.find_cell(os.path.join(harness.HERE, os.pardir), CELL)
    assert cell.cfg["parts"] == ["gps"] and cell.cfg["adc_ppm"] == 0.4
    assert cell.mix == harness.load_mix("serve32_wf4")
    assert [m["name"] for m in cell.end_to_end] == ["rt_factor", "setup_s"]
    names = {m["name"] for m in cell.per_layer}
    assert names == {"retune_ms.gps", "gps_chunk_ms.gps", "gps_device_ms.gps",
                     "gps_track_roofline_pct.gps", "step_device_ms.gps",
                     "device_idle_pct.gps", "loop_lag_ms.gps"}
    assert all(m["moves"] == "rt_factor" and m["workloads"] == [CELL]
               for m in cell.per_layer)
    mod = harness.part("gps")
    from benchmark.reference import judge
    lim = judge.limits(CELL)
    assert set(mod.NUMBERS) | {"clock_error_ppm"} <= set(lim)
    base = judge.limits("kiwi12k_c4096.serve32_wf4")
    assert set(base) <= set(lim)
    # the configuration is kiwi12k_c4096's, with adc_ppm, parts and gps
    with open(os.path.join(harness.HERE, "configs",
                           "kiwi12k_c4096.json")) as f:
        plain = json.load(f)
    for k, v in plain.items():
        if k not in ("name", "source", "guarantees", "assumed"):
            assert cell.cfg[k] == v, k
