"""The ingest's staging (``runtime/source.py``: ``BlockStage``,
``ThreadedSource.stage``, the rings' ``pop_into``; ``StreamEngine._next_x``
on a staged source), on the CPU, where the stage's buffers are plain
memory and its copy synchronous (a card's engine stages a threaded
source by itself; here a test hands the engine its source's stage).

The rings pop into a caller's buffer what they pop into a new one; the
engine on the staged path gives today's blocks, ticks, sequence and
audio to the bit; non-finite samples are replaced as
``SampleSource.next_block`` replaces them; a ring that runs dry and
refills loses and repeats no block; ``close()`` stops the staging
thread wherever it waits; only a threaded source on a card is staged,
and the mesh engine takes its block as before.
"""

import threading
import time

import numpy as np
import pytest
import torch

from flydog_sdr_gps_tpu_torch import parallel as tpar
from flydog_sdr_gps_tpu_torch.models import rx_channel as trx
from flydog_sdr_gps_tpu_torch.ops import demod
from flydog_sdr_gps_tpu_torch.runtime import ShardedStreamEngine
from flydog_sdr_gps_tpu_torch.runtime import native
from flydog_sdr_gps_tpu_torch.runtime import source as tsource
from flydog_sdr_gps_tpu_torch.runtime import stream as tstream
from flydog_sdr_gps_tpu_torch.utils.trace import get_trace

RINGS = {"native": lambda: native.NativeRing,
         "numpy": lambda: tsource.BlockRing}


def _params(**kw):
    return trx.RxParams(num_channels=4, audio_block=128, **kw)


def _threaded(params, inner=None, nblocks=4):
    inner = inner or tsource.SyntheticSource(
        tones=[(14.2018e6, 0.15), (7.1e6, 0.05)], noise_rms=3e-4, seed=7)
    return tsource.ThreadedSource(inner, block=params.ddc.adc_block,
                                  nblocks=nblocks)


def _staged(eng):
    """The engine on its source's stage, as a card's engine is."""
    eng._stage = eng.source.stage(eng.device)
    return eng


class Raw:
    """An ADC replay that hands its blocks on as they are (no check for
    non-finite samples), each filled with its number; ``gated``: block k
    is released only once the test lets it go (a paced producer)."""

    def __init__(self, gated=False, spikes=False):
        self.adc_clock = 125e6
        self.k = 0
        self.spikes = spikes
        self.gate = threading.Semaphore(0) if gated else None
        self.stop = threading.Event()

    def block(self, k, n):
        x = np.full(n, float(k), np.float32)
        x += np.linspace(0.0, 0.5, n, dtype=np.float32)
        if self.spikes:
            x[k::97] = np.nan
            x[k + 1::89] = np.inf
            x[k + 2::83] = -np.inf
        return x

    def next_block(self, n):
        if self.gate is not None:
            while not self.gate.acquire(timeout=0.01):
                if self.stop.is_set():
                    return np.zeros(n, np.float32)
        x = self.block(self.k, n)
        self.k += 1
        return x


def _close(src, inner=None):
    if inner is not None:
        inner.stop.set()
    src.close()


@pytest.mark.parametrize("ring", sorted(RINGS))
def test_pop_into_is_pop(ring):
    make = RINGS[ring]()
    if make is None:                        # pragma: no cover - no cc
        pytest.skip("no C compiler: the native ring was not built")
    a, b = make(16, 4), make(16, 4)
    rng = np.random.default_rng(3)
    blocks = [rng.standard_normal(16).astype(np.float32) for _ in range(3)]
    blocks[1][5] = np.nan
    for x in blocks:
        assert not a.push(x) and not b.push(x)
    out = np.full(16, -7.0, np.float32)
    for _ in blocks:
        want = a.pop()
        got = b.pop_into(out)
        assert got is out
        assert want.tobytes() == out.tobytes()
    # empty: None, and the buffer is left as it was
    before = out.copy()
    assert a.pop() is None and b.pop_into(out) is None
    assert out.tobytes() == before.tobytes()
    with pytest.raises(ValueError):
        b.pop_into(np.zeros(15, np.float32))
    with pytest.raises(ValueError):
        b.pop_into(np.zeros(16, np.float64))


@pytest.mark.parametrize("serve", [False, True], ids=["run_block",
                                                      "run_block_gather"])
def test_staged_engine_equals_todays_path(serve):
    params = _params(stage2="unfused")
    plain = tstream.StreamEngine(params, _threaded(params), device="cpu")
    staged = _staged(tstream.StreamEngine(params, _threaded(params),
                                          device="cpu"))
    assert plain._stage is None
    idx = np.arange(4)
    try:
        for e in (plain, staged):
            e.set_channel(0, freq_hz=14.2e6, mode=demod.MODE_USB)
            e.set_channel(1, freq_hz=7.1e6, mode=demod.MODE_AM)
            e.set_channel(2, freq_hz=7.1e6, mode=demod.MODE_SAM)
        for i in range(7):
            got = [e.run_block_gather(idx) if serve else e.run_block().audio
                   for e in (plain, staged)]
            assert torch.equal(got[0], got[1]), i
            assert torch.equal(plain._last_x, staged._last_x), i
            assert plain.block_ticks == staged.block_ticks \
                == i * params.ddc.adc_block
            assert plain.seq == staged.seq == i + 1
        assert staged._stage._thread.is_alive()
        # the stage takes blocks ahead of the step, through next_block
        assert staged.source.popped >= staged.seq
    finally:
        plain.source.close()
        staged.source.close()


def test_staged_spans_are_numbered_by_block():
    params = _params(stage2="unfused")
    since = time.monotonic_ns()
    eng = _staged(tstream.StreamEngine(params, _threaded(params),
                                       device="cpu"))
    try:
        for _ in range(4):
            eng.run_block()
    finally:
        eng.source.close()
    got = [s for s in get_trace().span_records() if s.t0 >= since]

    def of(name):
        return [s for s in got if s.name == name]
    waits = of("engine.stage_wait")
    assert [s.block for s in waits] == [0, 1, 2, 3]
    assert {s.thread for s in waits} == {threading.current_thread().name}
    for name in ("source.wait", "source.pop", "source.queued", "engine.h2d"):
        spans = of(name)
        assert [s.block for s in spans] == list(range(len(spans))), name
        assert len(spans) >= 4, name
        assert {s.thread for s in spans} == {"block-stage"}, name


def test_non_finite_samples_are_replaced_as_before():
    params = _params(stage2="unfused")
    n = params.ddc.adc_block
    inner_a, inner_b = Raw(spikes=True), Raw(spikes=True)
    a = _threaded(params, inner_a)
    b = _threaded(params, inner_b)
    stage = b.stage("cpu")
    ref = tsource.SampleSource()
    try:
        for k in range(3):
            raw = inner_a.block(k, n)
            assert not np.isfinite(raw).all()
            ref._produce = lambda n, raw=raw: raw.copy()
            want = ref.next_block(n)
            today = a.next_block(n)
            ticks, got = stage.take(k)
            assert ticks == k * n
            assert today.tobytes() == want.tobytes()
            assert got.numpy().tobytes() == want.tobytes()
            assert np.isfinite(want).all()
    finally:
        _close(a)
        _close(b)


def test_a_ring_that_runs_dry_and_refills_skips_and_repeats_nothing():
    inner = Raw(gated=True)
    src = tsource.ThreadedSource(inner, block=64, nblocks=4)
    stage = src.stage("cpu")
    got = []
    try:
        k = 0
        for burst in (1, 1, 3, 1, 2, 1, 4, 1):
            # the ring is dry here: the stage polls it until the burst
            time.sleep(0.02)
            assert src.ring.fill == 0
            inner.gate.release(burst)
            for _ in range(burst):
                ticks, x = stage.take(k)
                got.append((ticks, x.numpy().copy()))
                k += 1
        assert [t for t, _ in got] == [j * 64 for j in range(k)]
        for j, (_t, x) in enumerate(got):
            assert x.tobytes() == inner.block(j, 64).tobytes(), j
        assert src.overruns == 0 and src.popped == k
    finally:
        _close(src, inner)


@pytest.mark.parametrize("where", ["never_started", "ring_dry",
                                   "ahead_of_the_step"])
def test_close_stops_the_staging_thread(where):
    inner = Raw(gated=where == "ring_dry")
    src = tsource.ThreadedSource(inner, block=64, nblocks=4)
    stage = src.stage("cpu")
    if where == "ring_dry":
        inner.gate.release(1)
        assert stage.take(0)[0] == 0
        time.sleep(0.05)                  # the stage polls the empty ring
    elif where == "ahead_of_the_step":
        assert stage.take(0)[0] == 0
        time.sleep(0.05)                  # the stage waits for a take
        assert len(stage._staged) == 1
    t0 = time.monotonic()
    _close(src, inner)
    assert time.monotonic() - t0 < 2.0
    if stage._thread is not None:
        assert not stage._thread.is_alive()
    assert not src._thread.is_alive()
    if where == "ahead_of_the_step":
        assert stage.take(1)[0] == 64      # staged before the close
    if where != "never_started":
        with pytest.raises(RuntimeError, match="stopped"):
            stage.take(2)


def test_only_a_threaded_source_on_a_card_is_staged():
    params = _params(stage2="unfused")
    src = _threaded(params)
    cuda = torch.device("cuda")
    try:
        stage = tstream.block_stage(src, cuda)
        # made, not started: nothing touches a card until the first take
        assert isinstance(stage, tsource.BlockStage)
        assert stage._thread is None
        assert tstream.block_stage(src, cuda) is stage
        assert tstream.block_stage(src, torch.device("cpu")) is None
        assert tstream.block_stage(src.inner, cuda) is None
        scene = tsource.DeviceSceneSource(
            tones=[(14.2e6, 0.1)], block=params.ddc.adc_block,
            device="cpu")
        assert tstream.block_stage(scene, cuda) is None
        with pytest.raises(ValueError):
            src.stage("cpu")
        # a scene source's engine takes its block on the step's thread
        eng = tstream.StreamEngine(params, scene, device="cpu")
        assert eng._stage is None
        eng.run_block()
        assert eng._last_x is scene.out or torch.equal(eng._last_x,
                                                       scene.out)
    finally:
        src.close()


def test_the_mesh_engine_takes_its_block_as_before():
    params = trx.RxParams(num_channels=8, audio_block=128)
    src = _threaded(params)
    eng = ShardedStreamEngine(params, src, mesh=tpar.make_mesh(
        1, 2, devices=["cpu"] * 2))
    # a stage to be had, as where the engine's device is a card
    stage = eng._stage = src.stage("cpu")
    try:
        for _ in range(2):
            eng.run_block()
        assert stage._thread is None
        assert src.popped == eng.seq == 2
        assert eng.block_ticks == params.ddc.adc_block
    finally:
        src.close()
