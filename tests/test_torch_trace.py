"""The port's tracer (``utils/trace.py``): its spans, and the spans the
program records inside its ingest, block loop and fan-out.

The tracer alone: a span keeps its name, block, parent, thread and
detail; nothing is recorded while it is switched off; its clock is
``time.monotonic``'s; the store holds 2**16 spans without eviction; the
``ev()`` ring, ``dump()`` and ``spans()`` are what they were.  The
program on the CPU: a ``GraphSet`` that captures nothing records no
capture span; the server's executor helper records its job and one
``loop.lag`` per call; a tiny ``StreamEngine`` over a ``ThreadedSource``
served by a ``KiwiServer`` to one SND, one W/F and one EXT socket and an
autorun unit records every ingest and fan-out span once a block, under
that block's number, each child of ``server.fanout`` inside it.
"""

import asyncio
import time

import pytest

from flydog_sdr_gps_tpu_torch import _graphs
from flydog_sdr_gps_tpu_torch.models import rx_channel as trx
from flydog_sdr_gps_tpu_torch.runtime import source as tsource
from flydog_sdr_gps_tpu_torch.runtime import stream as tstream
from flydog_sdr_gps_tpu_torch.server import kiwi_server as tks
from flydog_sdr_gps_tpu_torch.utils import trace as ttrace
from flydog_sdr_gps_tpu_torch.utils.trace import get_trace


class Sock:
    def __init__(self):
        self.sent: list[bytes] = []
        self.closed = False

    async def send_bytes(self, data):
        self.sent.append(bytes(data))

    async def close(self):
        self.closed = True

    def of(self, tag: bytes) -> list[bytes]:
        return [p for p in self.sent if p[:len(tag)] == tag]


# -- the tracer --------------------------------------------------------------

def test_a_span_keeps_its_fields():
    tr = ttrace.EventTrace()
    t0 = time.monotonic_ns()
    tr.span("fanout.encode", 17, t0, "server.fanout", detail=("k", 3))
    tr.span("loop.lag", 17, t0, "fanout.encode", t1=t0 + 5)
    a, b = tr.span_records()
    assert (a.name, a.block, a.t0, a.parent, a.detail) == (
        "fanout.encode", 17, t0, "server.fanout", ("k", 3))
    assert a.t1 >= a.t0 and a.thread == "MainThread"
    assert (b.name, b.parent, b.t1 - b.t0, b.detail) == (
        "loop.lag", "fanout.encode", 5, None)
    lines = tr.dump_spans()
    assert len(lines) == 2 and "fanout.encode #17 <server.fanout>" in lines[0]


def test_switched_off_it_records_nothing():
    tr = ttrace.EventTrace(enabled=False)
    tr.span("source.pop", 0, time.monotonic_ns())
    tr.ev("SND", "x")
    assert tr.span_records() == [] and tr.dump() == []
    assert tr.dump_spans() == []


def test_the_clock_is_time_monotonic():
    tr = ttrace.EventTrace()
    before = time.monotonic()
    tr.span("x", 0, time.monotonic_ns())
    after = time.monotonic()
    s = tr.span_records()[0]
    assert before - 1e-3 <= s.t0 / 1e9 <= s.t1 / 1e9 <= after + 1e-3


def test_the_store_keeps_two_to_the_sixteen_spans():
    tr = ttrace.EventTrace()
    n = 1 << 16
    for k in range(n):
        tr.span("server.block", k, k, t1=k + 1)
    got = tr.span_records()
    assert len(got) == n == ttrace.SPAN_DEPTH
    assert [s.block for s in got[:3]] == [0, 1, 2] and got[-1].block == n - 1
    tr.span("server.block", n, n, t1=n + 1)      # one more evicts the oldest
    assert tr.span_records()[0].block == 1


def test_spans_leave_the_event_ring_alone():
    with_spans, plain = ttrace.EventTrace(depth=8), ttrace.EventTrace(depth=8)
    for k in range(10):
        for tr in (with_spans, plain):
            tr.ev("SND", "start" if k % 2 == 0 else "end", str(k))
        with_spans.span("server.block", k, time.monotonic_ns())
    assert len(with_spans.dump()) == len(plain.dump()) == 8
    assert [ln.split("ms ", 1)[1] for ln in with_spans.dump()] == \
        [ln.split("ms ", 1)[1] for ln in plain.dump()]
    assert len(with_spans.spans("SND", "start", "end")) == \
        len(plain.spans("SND", "start", "end")) == 4


# -- the program on the CPU ----------------------------------------------------

def _graph_spans(since):
    return [s for s in get_trace().span_records()
            if s.t0 >= since and s.name.startswith("graphs.")]


def test_a_graph_set_that_captures_nothing_records_no_span():
    since = time.monotonic_ns()
    gs = _graphs.GraphSet("cpu")
    ran = []
    gs.run(("prog", 1), lambda: ran.append(1))
    gs.run(("prog", 1), lambda: ran.append(2))
    gs.prepare(("prog", 2), lambda: ran.append(3), lambda: ran.append(4))
    assert ran == [1, 2] and gs.graphs == {}
    assert _graph_spans(since) == []


def _server(channels=4, block=128, autorun=None, threaded=True):
    params = trx.RxParams(num_channels=channels, audio_block=block,
                          stage2="unfused")
    src = tsource.SyntheticSource(tones=[(14.2018e6, 0.15)], noise_rms=3e-4,
                                  seed=7)
    if threaded:
        src = tsource.ThreadedSource(src, block=params.ddc.adc_block,
                                     nblocks=4)
    eng = tstream.StreamEngine(params, src, device="cpu")
    return tks.KiwiServer(eng, realtime=False, port=0, autorun=autorun), src


def test_the_executor_helper_records_its_job_and_one_lag_a_call():
    server, _src = _server(threaded=False)
    since = time.monotonic_ns()

    def job(x):
        if x < 0:
            raise ValueError("no")
        time.sleep(0.01)
        return 2 * x

    async def scenario():
        assert await server._job("t.job", 5, "t.parent", job, 21) == 42
        assert await server._job("t.job", 6, "t.parent", job, 1) == 2
        with pytest.raises(ValueError):
            await server._job("t.job", 7, "t.parent", job, -1)
    asyncio.run(scenario())
    got = [s for s in get_trace().span_records() if s.t0 >= since]
    jobs = [s for s in got if s.name == "t.job"]
    lags = [s for s in got if s.name == "loop.lag"]
    assert [s.block for s in jobs] == [5, 6, 7]
    assert [s.block for s in lags] == [5, 6, 7]
    for j, lag in zip(jobs, lags):
        assert j.parent == "t.parent" and lag.parent == "t.job"
        assert j.thread != "MainThread" and lag.thread == "MainThread"
        assert lag.t0 == j.t1 <= lag.t1
    assert (jobs[0].t1 - jobs[0].t0) / 1e9 >= 0.009


INGEST = ("source.wait", "source.pop", "source.queued", "engine.h2d")
LOOP = ("server.block", "server.step", "server.wf_ingest", "server.fetch")
FANOUT = ("server.fanout", "fanout.fetch_wait", "fanout.encode",
          "fanout.snd", "fanout.wf_row", "fanout.wf_send", "fanout.ext",
          "fanout.autorun")
JOBS = ("server.step", "server.wf_ingest", "server.fetch", "fanout.encode",
        "fanout.wf_row", "fanout.ext", "fanout.autorun")


def test_the_server_records_every_span_once_a_block(monkeypatch):
    # a row every block, however fast the CPU runs them (the waterfall's
    # rates, up to 23 rows/s, are slower than a tiny block)
    monkeypatch.setattr(tks.wf_service, "WF_SPEEDS_FPS", (1e9,) * 5)
    server, src = _server(autorun=["wspr:7038.6"])
    snd, wf, ext = Sock(), Sock(), Sock()
    auth = "SET auth t=kiwi p="

    async def scenario():
        conn = await server.open_stream("a", "SND", snd, "127.0.0.1")
        for cmd in (auth, "SET mod=usb low_cut=300 high_cut=2700 "
                    "freq=14201.000", "SET compression=0"):
            await conn.handle_set(cmd, "SND")
        await server.open_stream("a", "W/F", wf, "127.0.0.1")
        for cmd in (auth, "SET zoom=0 start=0"):
            await conn.handle_set(cmd, "W/F")
        await server.open_stream("a", "EXT", ext, "127.0.0.1")
        for cmd in (auth, "SET ext_switch_to_client=S_meter first_time=1"):
            await conn.handle_set(cmd, "EXT")
        since = time.monotonic_ns()
        server.start_tasks()
        t0 = time.monotonic()
        while len(snd.of(b"SND")) < 5:
            await asyncio.sleep(0.01)
            assert time.monotonic() - t0 < 300, "the server stalled"
        await server.stop()
        await asyncio.sleep(0.05)
        return since
    try:
        since = asyncio.run(scenario())
    finally:
        src.close()
    got = [s for s in get_trace().span_records() if s.t0 >= since]
    fanned = sorted(s.block for s in got if s.name == "server.fanout")
    assert fanned[:4] == [0, 1, 2, 3] and wf.of(b"W/F ")
    for b in fanned:
        mine = [s for s in got if s.block == b]
        count = {name: sum(1 for s in mine if s.name == name)
                 for name in INGEST + LOOP + FANOUT}
        assert count == dict.fromkeys(INGEST + LOOP + FANOUT, 1), (b, count)
        lags = [s for s in mine if s.name == "loop.lag"]
        assert sorted(s.parent for s in lags) == sorted(JOBS)
        fan = next(s for s in mine if s.name == "server.fanout")
        assert fan.parent == "server.block"
        for s in mine:
            if s.parent == "server.fanout" or s.parent.startswith("fanout."):
                assert fan.t0 <= s.t0 <= s.t1 <= fan.t1, (b, s)
        queued = next(s for s in mine if s.name == "source.queued")
        pop = next(s for s in mine if s.name == "source.pop")
        h2d = next(s for s in mine if s.name == "engine.h2d")
        assert queued.t1 <= pop.t0 <= pop.t1 <= h2d.t0
