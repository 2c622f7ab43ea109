"""The block loop's early fan-out (``KiwiServer._fan_out_early``), on the
CPU.

The same scene, listeners and W/F socket (C=4, audio_block=128) served
twice:

- paced: a source that lets block k leave the ADC only once the test has
  released it, and releases block k+1 only once every listener holds
  block k's SND packet.  The step of block k+1 then waits for its block,
  so block k has to go out while it waits;
- free: the blocks are always there, and the fetch is a stand-in for a
  card busy with the next block: block k's copy lands ``LAND_S`` after
  the step of block k+1 has returned, and never while a step runs (the
  copy queues behind what the host enqueued after it).  The loop keeps
  today's order: block k goes out after the step of block k+1.

Every listener gets every block once and in order, and both runs send
the same bytes (SND packets, the IQ header's GPS time, the TDoA
extension's stamped IQ, the W/F rows); the GPS time is the next block's
start in both.
``fanout.held`` is recorded once a block, ``early`` paced and
``after_next`` free.  Each fetch's result is taken before the second
fetch after it starts (the engine's two host buffers): a loop that lets
a third block into flight breaks this in the free run.
"""

import asyncio
import struct
import threading
import time

import numpy as np
import pytest

from flydog_sdr_gps_tpu_torch.models import rx_channel as trx
from flydog_sdr_gps_tpu_torch.runtime import source as tsource
from flydog_sdr_gps_tpu_torch.runtime import stream as tstream
from flydog_sdr_gps_tpu_torch.server import kiwi_server as tks
from flydog_sdr_gps_tpu_torch.server import wf_service as twf
from flydog_sdr_gps_tpu_torch.utils.trace import get_trace

C, BLOCK = 4, 128
N = 5                   # blocks every listener must hear in each run
WAIT_S = 20.0
LAND_S = 0.05           # the free run's copy lands this long after a step

# (ts, stream, commands): s16 of both byte orders, ADPCM, IQ, the TDoA
# extension, a W/F row every block
LISTENERS = [
    ("u", "SND", ["SET mod=usb low_cut=300 high_cut=2700 freq=14201.000",
                  "SET compression=0"]),
    ("a", "SND", ["SET mod=am low_cut=-4000 high_cut=4000 freq=7100.000",
                  "SET compression=0", "SET little-endian"]),
    ("s", "SND", ["SET mod=sam low_cut=-4000 high_cut=4000 freq=7100.000",
                  "SET compression=1"]),
    ("q", "SND", ["SET mod=iq low_cut=-5000 high_cut=5000 freq=14201.000"]),
    ("q", "EXT", ["SET ext_switch_to_client=TDoA"]),
    ("u", "W/F", ["SET zoom=0 start=0", "SET wf_speed=4"]),
]
SND_KEYS = [(ts, st) for ts, st, _ in LISTENERS if st == "SND"]
TDOA = b"EXT tdoa_iq "


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


class Gated:
    """A source whose block k leaves the ADC only once released (a paced
    ADC under the test's hand); ``given`` blocks have left it."""

    def __init__(self, inner):
        self.inner = inner
        self.gate = threading.Semaphore(0)
        self.stop = threading.Event()
        self.given = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def next_block(self, n):
        while not self.gate.acquire(timeout=0.01):
            if self.stop.is_set():
                return np.zeros(n, np.float32)
        x = self.inner.next_block(n)
        self.given += 1
        return x


class Fetches:
    """Counts the engine's fetches and notes each whose result is taken
    once the second fetch after it has started (its host buffer is then
    another block's)."""

    def __init__(self, eng):
        self.started = 0
        self.late: list[int] = []
        real = eng.start_fetch

        def start_fetch(packed):
            h = real(packed)
            h.k, self.started = self.started, self.started + 1
            take = h.result

            def result():
                if self.started > h.k + 2:
                    self.late.append(h.k)
                return take()
            h.result = result
            return h
        eng.start_fetch = start_fetch


def _server(source):
    eng = tstream.StreamEngine(
        trx.RxParams(num_channels=C, audio_block=BLOCK, stage2="unfused"),
        source, device="cpu")
    return tks.KiwiServer(eng, realtime=False, port=0)


def _scene():
    return tsource.SyntheticSource(
        tones=[(7.100e6, 0.30), (14.2018e6, 0.15)], noise_rms=3e-4, seed=7)


async def _connect(server) -> dict:
    socks = {}
    for ts, stream, cmds in LISTENERS:
        sock = socks[(ts, stream)] = Sock()
        conn = await server.open_stream(ts, stream, sock, "127.0.0.1")
        for cmd in ["SET auth t=kiwi p="] + cmds:
            await conn.handle_set(cmd, stream)
    return socks


async def _wait(cond, what):
    t0 = time.monotonic()
    while not cond():
        await asyncio.sleep(0.002)
        assert time.monotonic() - t0 < WAIT_S, f"timed out: {what}"


def _heard(socks, k) -> bool:
    return (all(len(socks[key].of(b"SND")) > k for key in SND_KEYS)
            and len(socks[("q", "EXT")].of(TDOA)) > k)


async def _paced() -> dict:
    src = Gated(_scene())
    server = _server(src)
    fetches = Fetches(server.engine)
    server._device_get = lambda h: h.result()
    socks = await _connect(server)
    given = []
    t0 = time.monotonic_ns()
    server.start_tasks()
    try:
        for k in range(N):
            src.gate.release()
            await _wait(lambda: _heard(socks, k), f"block {k}")
            given.append(src.given)
    finally:
        src.stop.set()
        await server.stop()
    return dict(socks=socks, given=given, fetches=fetches,
                spans=(t0, time.monotonic_ns()), params=server.engine.params)


async def _free() -> dict:
    server = _server(_scene())
    fetches = Fetches(server.engine)
    steps = dict(running=0, done=0)
    step = server._step_and_fetch

    def counted(idx):
        steps["running"] += 1
        try:
            return step(idx)
        finally:
            steps["running"] -= 1
            steps["done"] += 1
    server._step_and_fetch = counted
    stop = threading.Event()

    def card(h):
        # block h.k's copy lands behind the next block's step
        while not stop.is_set():
            if steps["done"] >= h.k + 2 and not steps["running"]:
                time.sleep(LAND_S)
                if not steps["running"]:
                    break
            time.sleep(0.001)
        return h.result()
    server._device_get = card
    socks = await _connect(server)
    t0 = time.monotonic_ns()
    server.start_tasks()
    try:
        await _wait(lambda: _heard(socks, N - 1), f"{N} blocks")
    finally:
        stop.set()
        await server.stop()
    return dict(socks=socks, fetches=fetches, spans=(t0, time.monotonic_ns()),
                params=server.engine.params)


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    mp.setattr(twf, "WF_SPEEDS_FPS", (0, 1e9, 1e9, 1e9, 1e9))
    try:
        yield dict(paced=asyncio.run(_paced()), free=asyncio.run(_free()))
    finally:
        mp.undo()


def _spans(run, name):
    lo, hi = run["spans"]
    return [s for s in get_trace().span_records()
            if s.name == name and lo <= s.t0 and s.t1 <= hi]


def _seq(pkt) -> int:
    return int.from_bytes(pkt[4:8], "little")


def test_each_block_goes_out_before_the_next_leaves_the_adc(runs):
    assert runs["paced"]["given"] == list(range(1, N + 1))


@pytest.mark.parametrize("run", ["paced", "free"])
def test_every_listener_gets_every_block_once_in_order(runs, run):
    for key in SND_KEYS:
        seqs = [_seq(p) for p in runs[run]["socks"][key].of(b"SND")]
        assert seqs == list(range(len(seqs))) and len(seqs) >= N, key


def test_early_fan_out_sends_what_todays_order_sends(runs):
    paced, free = runs["paced"]["socks"], runs["free"]["socks"]
    for key in SND_KEYS:
        assert paced[key].of(b"SND")[:N] == free[key].of(b"SND")[:N], key
    rows = paced[("u", "W/F")].of(b"W/F"), free[("u", "W/F")].of(b"W/F")
    n = min(map(len, rows))
    assert n >= N - 1
    assert rows[0][:n] == rows[1][:n]


@pytest.mark.parametrize("run", ["paced", "free"])
def test_tdoa_stamps_each_block_with_the_next_blocks_start(runs, run):
    """The TDoA extension's header (48-bit ticks, seconds, samples) reads
    the block's stamp, not the engine's clock, which the next step moves
    while an early fan-out runs: both orders send the same bytes."""
    p = runs[run]["params"]
    got = runs[run]["socks"][("q", "EXT")].of(TDOA)[:N]
    want = runs["free"]["socks"][("q", "EXT")].of(TDOA)[:N]
    assert len(got) == N and got == want
    for k, msg in enumerate(got):
        ticks, secs, _n = struct.unpack("<QdI", msg[len(TDOA):][:20])
        assert ticks == (k + 1) * p.ddc.adc_block, k
        assert secs == ticks / p.adc_clock, k


@pytest.mark.parametrize("run,detail", [("paced", "early"),
                                        ("free", "after_next")])
def test_fanout_held_once_a_block(runs, run, detail):
    held = _spans(runs[run], "fanout.held")
    blocks = sorted(s.block for s in held)
    assert blocks == list(range(len(blocks))) and len(blocks) >= N
    assert {s.detail for s in held} == {detail}
    assert all(s.t1 >= s.t0 for s in held)


@pytest.mark.parametrize("run,after", [("paced", False), ("free", True)])
def test_fan_out_against_the_next_step(runs, run, after):
    """Free, each block goes out after the next block's step returned
    (today's order); paced, before it."""
    steps = {s.block: s for s in _spans(runs[run], "server.step")}
    fanned = [s for s in _spans(runs[run], "server.fanout")
              if s.block + 1 in steps]
    assert len(fanned) >= N - 1
    for s in fanned:
        assert (s.t0 >= steps[s.block + 1].t1) == after, s.block


@pytest.mark.parametrize("run", ["paced", "free"])
def test_fetch_results_are_taken_before_the_second_fetch_after(runs, run):
    fetches = runs[run]["fetches"]
    assert fetches.started > N and fetches.late == []
