"""The compiled programs beside the block step, on the CPU: the scene
source, the waterfall's ingest and frame, the GPS sky, the tracking step
and the mesh step.  On a card each is a CUDA graph over buffers its owner
keeps (``_graphs.GraphSet``); here ``use_graphs=True`` runs the same
static-buffer bodies with nothing captured.

For each program:
- the static-buffer body equals the port's eager path to the bit;
- no buffer is rebound by the control plane (``data_ptr`` stays): the
  source across blocks, the waterfall across a zoom change and a mask
  change, GPS across activating and dropping rows, the mesh across a SET,
  ``retune_all`` and ``load_state``;
- it stays within the bounds the existing parity tests hold the eager
  path to against the reference: the scene 1e-6 of the exact float64
  scene and 2e-6 of the reference's source (``test_torch_stream.py``),
  waterfall rings within 2e-5 of their peak and rows within 0.1 dB
  (``test_torch_waterfall.py``), the device sky within 1e-5 of the
  reference's device path (``test_torch_gps.py``), unwrapped chips within
  1e-3, the mesh's audio within 3e-3 and S-meter within 0.2 dB of the
  reference's mesh engine (``test_torch_sharded_engine.py``).
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flydog_sdr_gps_tpu import parallel as jpar
from flydog_sdr_gps_tpu.models import rx_channel as jrx
from flydog_sdr_gps_tpu.models.gps import manager as jman
from flydog_sdr_gps_tpu.models.gps import scene as jscene
from flydog_sdr_gps_tpu.runtime import ShardedStreamEngine as JSharded
from flydog_sdr_gps_tpu.runtime import SyntheticSource as JSyntheticSource
from flydog_sdr_gps_tpu.runtime import source as jsource
from flydog_sdr_gps_tpu.server import wf_service as jsvc
from flydog_sdr_gps_tpu_torch import _graphs, convert
from flydog_sdr_gps_tpu_torch import parallel as tpar
from flydog_sdr_gps_tpu_torch.models import rx_channel as trx
from flydog_sdr_gps_tpu_torch.models import waterfall as twf
from flydog_sdr_gps_tpu_torch.models.gps import manager as tman
from flydog_sdr_gps_tpu_torch.models.gps import scene as tscene
from flydog_sdr_gps_tpu_torch.numerology import ADC_CLOCK_NOM, UI_SRATE_30M
from flydog_sdr_gps_tpu_torch.ops import demod
from flydog_sdr_gps_tpu_torch.runtime import (ShardedStreamEngine,
                                              SyntheticSource)
from flydog_sdr_gps_tpu_torch.runtime import source as tsource
from flydog_sdr_gps_tpu_torch.server import wf_service as tsvc

sys.path.insert(0, os.path.dirname(__file__))
from test_gps import synth_if  # noqa: E402
from test_torch_stream import _scene_truth  # noqa: E402
from test_torch_waterfall import ref_complex  # noqa: E402

CPU = torch.device("cpu")
RING_TOL = 2e-5                 # test_torch_waterfall.py's


def _leaves(obj) -> list[torch.Tensor]:
    """Every tensor of nested dataclasses and lists, in order."""
    if obj is None:
        return []
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for x in obj for t in _leaves(x)]
    if not dataclasses.is_dataclass(obj):
        return []                   # a host field (a gate)
    return [t for f in dataclasses.fields(obj)
            for t in _leaves(getattr(obj, f.name))]


def _ptrs(obj) -> list[int]:
    return [t.data_ptr() for t in _leaves(obj)]


def _equal(got, want) -> bool:
    a, b = _leaves(got), _leaves(want)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


# -- the scene source ---------------------------------------------------------

# AM, a carrier, a 100 Bd-like FSK emitter (3 output samples a symbol: 2-3
# boundaries a block of 8 output samples, idle slots) and a slow one
SCENE = [(7.1e6, 0.3, ("am", 1000.0, 0.6)), (14.2018e6, 0.15),
         (518.0e3 + 1000.0, 0.05, ("fsk", 3, 170.0,
                                   [1, 0, 1, 1, 0, 0, 1, 0, 1, 1], 13)),
         (10.1387e6, 0.1, ("fsk", 20, 1.4648, [0, 1, 2, 3], 6))]
SCENE_BLOCK = 8 * 10416


def test_static_scene_equals_eager_to_the_bit():
    eager = tsource.DeviceSceneSource(SCENE, noise_rms=1e-3,
                                      block=SCENE_BLOCK, device="cpu",
                                      seed=3, use_graphs=False)
    static = tsource.DeviceSceneSource(SCENE, noise_rms=1e-3,
                                       block=SCENE_BLOCK, device="cpu",
                                       seed=3, use_graphs=True)
    bufs = [static.out, static._phi_dev, static._seg_words, static._seg_amps]
    ptrs = [b.data_ptr() for b in bufs]
    assert static._fsk_cap == [-(-SCENE_BLOCK // (3 * 10416)) + 1, 2]
    for blk in range(14):                           # past a whole cycle
        want, got = eager.next_block(), static.next_block()
        assert torch.equal(got, want), blk
        assert got is static.out
        assert [st["phi"] for st in static._fsk] == \
            [st["phi"] for st in eager._fsk]
    assert [b.data_ptr() for b in bufs] == ptrs
    assert static.ticks == eager.ticks == 14 * SCENE_BLOCK
    assert static._phi_dev.tolist() == eager._phi_dev.tolist() == [
        fcw * 14 * SCENE_BLOCK % (1 << 48) for fcw in eager._fcws]
    assert static.graphs == {} and eager.graphs == {}


def test_static_scene_matches_reference():
    tones = SCENE[:2] + [(10.0e6, 0.2)]
    ref = jsource.DeviceSceneSource(tones=tones, block=SCENE_BLOCK)
    got = tsource.DeviceSceneSource(tones=tones, block=SCENE_BLOCK,
                                    device="cpu", use_graphs=True)
    for blk in range(3):
        r = np.asarray(ref.next_block())
        g = got.next_block().numpy()
        truth = _scene_truth(tones, blk * SCENE_BLOCK, SCENE_BLOCK)
        np.testing.assert_allclose(g, truth, rtol=0, atol=1e-6)
        np.testing.assert_allclose(g, r, rtol=0, atol=2e-6)
    # one boundary a block: the reference's FSK source
    fsk = [(10.1387e6, 0.25, ("fsk", 8, 1.4648, [0, 1, 2, 3], 5))]
    ref = jsource.DeviceSceneSource(tones=fsk, block=SCENE_BLOCK)
    got = tsource.DeviceSceneSource(tones=fsk, block=SCENE_BLOCK,
                                    device="cpu", use_graphs=True)
    for blk in range(12):
        np.testing.assert_allclose(got.next_block().numpy(),
                                   np.asarray(ref.next_block()), rtol=0,
                                   atol=2e-6, err_msg=f"block {blk}")


# -- the waterfall ------------------------------------------------------------

WF_BLOCK = 1 << 15


class _EagerSlot:
    """Today's eager waterfall arithmetic for one view: ``wf_ingest`` on
    the accumulated blocks, ``wf_frame`` of the state (mask None when
    nothing is masked)."""

    def __init__(self, wf, key):
        zoom, start, interp = key
        self.params = twf.make_wf_params(zoom, ADC_CLOCK_NOM, UI_SRATE_30M)
        slot = wf._make_slot(key)
        self.cf, self.tune, self.interp = slot.cf, slot.tune, interp
        self.state = twf.init_state(self.params, CPU)
        self.acc = []

    def ingest(self, x):
        self.acc.append(x.clone())
        if len(self.acc) < self.params.ingest_blocks(x.shape[0]):
            return
        x = torch.cat(self.acc)
        self.acc = []
        self.state = twf.wf_ingest(self.params, self.state, x, *self.tune)

    def frame(self, mask):
        return twf.wf_frame(self.params, self.state, "hanning", self.interp,
                            mask=mask).numpy()


def _chain_ptrs(wf):
    return [_ptrs([c.phi, c.base_tail, c.hb_tails, c.ring, c.bank, c.dphi,
                   c.mask, c.row] + list(c.inputs.values()))
            for c in wf._chains]


def test_static_waterfall_equals_eager_to_the_bit():
    """Two views, then a zoom change (the freed chain's buffers serve the
    new view) and a mask change: every row equal to the eager arithmetic,
    a clean slot's row returned again without a new sequence number."""
    wf = tsvc.WfSubsystem(ADC_CLOCK_NOM, UI_SRATE_30M, capacity=2,
                          device="cpu")
    keys = [(0, 0, "cma"), (3, 4000, "max")]
    slots = [wf.attach(*k) for k in keys]
    eager = [_EagerSlot(wf, k) for k in keys]
    rng = np.random.default_rng(5)

    def blocks(n, start):
        for blk in range(start, start + n):
            t = (blk * WF_BLOCK + np.arange(WF_BLOCK)) / ADC_CLOCK_NOM
            x = torch.from_numpy((0.3 * np.cos(2 * np.pi * 10.0e6 * t)
                                  + 0.05 * rng.standard_normal(WF_BLOCK)
                                  ).astype(np.float32))
            wf.ingest(x)
            for e in eager:
                e.ingest(x)

    def rows(masks):
        for s, e, m in zip(slots, eager, masks):
            seq = s.row_seq
            row = wf.frame(s)
            np.testing.assert_array_equal(row, e.frame(m))
            assert s.row_seq == seq + 1 and not s.dirty
            assert wf.frame(s) is row and s.row_seq == seq + 1   # clean
    blocks(3, 0)
    rows([None, None])
    ptrs = _chain_ptrs(wf)
    # zoom change: the first view goes, a z14 view (two blocks an
    # ingest) takes its chain
    wf.detach(slots[0])
    wf._evict_unreferenced()
    slots[0], eager[0] = wf.attach(14, 20000), _EagerSlot(wf, (14, 20000,
                                                                "cma"))
    assert slots[0].chain is wf._chains[0] and len(wf._chains) == 2
    blocks(5, 3)
    assert len(slots[0].acc) == 1 and slots[0].params.ingest_blocks(
        WF_BLOCK) == 2
    rows([None, None])
    # a mask over each view's centre
    wf.set_masked([(s.cf - 1e3, s.cf + 1e3) for s in slots])
    masks = [wf._device_mask(s.cf, s.params.span) for s in slots]
    assert all(m is not None for m in masks)
    rows(masks)
    blocks(1, 8)
    rows(masks)
    after = _chain_ptrs(wf)
    assert [p[:8] for p in after] == [p[:8] for p in ptrs]
    assert set(ptrs[0][8:]) <= set(after[0][8:])


def test_control_plane_leaves_the_chains_to_the_data_plane():
    """``attach`` (a view on a chain another view left) and ``set_masked``
    write nothing into the chains: they mark the chain, and the next
    ingest or frame binds or re-masks it first, so that only the data
    plane's thread touches a chain (on a card, the stream its graphs are
    captured beside).  A carried-in state lands after the bind."""
    wf = tsvc.WfSubsystem(ADC_CLOCK_NOM, UI_SRATE_30M, capacity=1,
                          device="cpu")
    old = wf.attach(2, 1000)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(WF_BLOCK).astype(np.float32))
    wf.ingest(x)
    chain = old.chain
    before = [t.clone() for t in (chain.ring, chain.bank, chain.mask)]
    wf.detach(old)
    new = wf.attach(5, 3000, "max")
    assert new.chain is chain and new.bind
    wf.set_masked([(new.cf - 1e3, new.cf + 1e3)])
    assert new.remask
    for t, b in zip((chain.ring, chain.bank, chain.mask), before):
        assert torch.equal(t, b)
    e = _EagerSlot(wf, (5, 3000, "max"))
    mask = wf._device_mask(new.cf, new.params.span)
    np.testing.assert_array_equal(wf.frame(new), e.frame(mask))
    assert not new.bind and not new.remask
    assert torch.equal(chain.bank, e.tune[0])
    empty = wf.frame(old)           # evicted: the row of an empty state
    assert (empty == -300.0).all() and wf.frame(old) is empty
    # a state carried in after an attach is not zeroed by the bind
    wf.detach(new)
    again = wf.attach(6, 3000, "max")
    assert again.chain is chain and again.bind
    e = _EagerSlot(wf, (6, 3000, "max"))
    again.state = e.state = twf.wf_ingest(e.params, e.state, x, *e.tune)
    wf.ingest(x)
    e.ingest(x)
    np.testing.assert_array_equal(
        wf.frame(again), e.frame(wf._device_mask(again.cf,
                                                 again.params.span)))


def test_deep_zoom_on_a_reused_source_buffer_matches_reference():
    """z14 takes two 32768-sample blocks an ingest.  The compiled scene
    source overwrites its one output buffer every block, so the first
    block of a pair must be copied when it is accumulated (a kept
    reference would read the second block twice): the ring
    stays within the reference's bound, fed the same samples."""
    start = int(10.0e6 / (UI_SRATE_30M / (1024 << 14)))
    jw = jsvc.WfSubsystem(ADC_CLOCK_NOM, UI_SRATE_30M, capacity=1)
    wf = tsvc.WfSubsystem(ADC_CLOCK_NOM, UI_SRATE_30M, capacity=1,
                          device="cpu")
    js, slot = jw.attach(14, start), wf.attach(14, start)
    assert slot.params.ingest_blocks(WF_BLOCK) == 2
    src = tsource.DeviceSceneSource([(slot.cf + 100.0, 0.5)], noise_rms=0.05,
                                    block=WF_BLOCK, device="cpu", seed=2,
                                    use_graphs=True)
    for blk in range(101):        # the 14-stage cascade settles in ~90
        x = src.next_block()
        assert x is src.out
        jw.ingest(jnp.asarray(x.numpy().copy()))
        wf.ingest(x)
    ring = ref_complex(js.state.ring)
    assert np.abs(ring[-1]) > 0.2
    np.testing.assert_allclose(slot.state.ring.numpy(), ring, rtol=0,
                               atol=RING_TOL * np.abs(ring).max())
    assert np.isfinite(wf.frame(slot)).all()


def test_frame_returns_todays_row_and_seq():
    """``frame`` of a dirty slot gives the row of the last ingest (the
    fetch that ingest started) and a new sequence number; of a clean slot
    the same row again; before any ingest the row of the initial state;
    all equal to ``wf_frame`` of the eager state."""
    wf = tsvc.WfSubsystem(ADC_CLOCK_NOM, UI_SRATE_30M, capacity=1,
                          device="cpu")
    slot = wf.attach(2, 1000)
    e = _EagerSlot(wf, (2, 1000, "cma"))
    first = wf.frame(slot)
    np.testing.assert_array_equal(first, e.frame(None))
    assert slot.row_seq == 1 and slot.fetch is None
    rng = np.random.default_rng(1)
    for blk in range(2):
        x = torch.from_numpy(rng.standard_normal(WF_BLOCK).astype(
            np.float32))
        wf.ingest(x)
        e.ingest(x)
        assert slot.dirty and slot.fetch is not None
    row = wf.frame(slot)
    np.testing.assert_array_equal(row, e.frame(None))
    assert slot.row_seq == 2 and not slot.dirty
    assert wf.frame(slot) is row and slot.row_seq == 2


# -- GPS: the sky and the tracking step ---------------------------------------

RX_LLA, T0 = (47.37, 8.54, 450.0), 345600.0 + 3.0


def _sky(mod, noise, one_bit, **kw):
    rx = mod.ecef_from_lla(*RX_LLA)
    return mod.GpsScene(rx, mod.visible_constellation(rx, T0, n_sats=4), T0,
                        duration=30.0, clock_ppm=0.4, noise=noise,
                        amplitude=0.5, one_bit=one_bit,
                        galileo_ephemerides=mod.visible_galileo(
                            rx, T0, n_sats=2), **kw)


@pytest.mark.parametrize("noise, one_bit", [(0.0, False), (0.9, True)])
def test_static_sky_equals_eager_to_the_bit(noise, one_bit):
    eager = _sky(tscene, noise, one_bit, device="cpu", use_graphs=False)
    static = _sky(tscene, noise, one_bit, device="cpu", use_graphs=True)
    outs = {}
    for n_ep in (3, 3, 2, 3):                   # two programs, by length
        want, got = (s.next_block(16368 * n_ep) for s in (eager, static))
        assert torch.equal(got, want), n_ep
        assert outs.setdefault(n_ep, got.data_ptr()) == got.data_ptr()
    assert static.ticks == eager.ticks and set(static._sky) == {2, 3}


def test_static_sky_matches_reference_device_path():
    ref = _sky(jscene, 0.0, False, device=True)
    got = _sky(tscene, 0.0, False, device="cpu", use_graphs=True)
    for _ in range(2):
        xr = np.asarray(ref.next_block(16368 * 20))
        xg = got.next_block(16368 * 20)
        assert np.abs(xg.numpy() - xr).max() <= 1e-5
    assert got.ticks == ref.ticks


SATS = [(9, 210.0, +1200.0, 0.7), (22, 555.5, -900.0, 0.65)]


def test_static_tracking_step_equals_eager_to_the_bit():
    """Search, track, drop a row, track, search it back, track: every
    channel's chips and prompt log, and the state, equal to the eager
    manager's; the state and code table are the same tensors
    throughout."""
    kw = dict(max_chans=3, prns=(9, 22, 30), device=CPU)
    eager = tman.GpsManager(**kw, use_graphs=False)
    static = tman.GpsManager(**kw, use_graphs=True)
    ptrs = _ptrs([static._track_state, static._code_table])
    raw = synth_if(SATS, eager.acq.n_raw, noise=0.5)
    for m in (eager, static):
        m.cold_search(raw)
    assert set(static.channels) == {9, 22}

    def track(n_ep, seed):
        x = synth_if(SATS, 16368 * n_ep, noise=0.5, seed=seed)
        for m in (eager, static):
            m.track_block(torch.as_tensor(x))
        for prn, ch in static.channels.items():
            assert ch.chips == eager.channels[prn].chips
            assert list(ch.iq_log) == list(eager.channels[prn].iq_log)
        assert _equal(static._track_state, eager._track_state)
    track(20, 1)
    for m in (eager, static):
        m._drop_channel(9)
    track(20, 2)
    track(7, 3)                                 # another program
    for m in (eager, static):
        m.cold_search(raw)
    assert set(static.channels) == {9, 22}
    track(20, 4)
    assert _ptrs([static._track_state, static._code_table]) == ptrs
    assert set(static._track_bufs) == {20, 7}


def test_static_tracking_step_tracks_like_the_reference():
    """From one state (``convert``: copied into the step's buffers), 120
    epochs: the reference's channels, epochs and chips within 1e-3."""
    kw = dict(max_chans=4, prns=(3, 9, 14, 22, 30))
    ref = jman.GpsManager(**kw)
    got = tman.GpsManager(**kw, device=CPU, use_graphs=True)
    ptrs = _ptrs([got._track_state, got._code_table])
    ref.cold_search(synth_if(SATS, ref.acq.n_raw, noise=0.5))
    convert.gps_manager_from_ref(ref, got)
    assert _ptrs([got._track_state, got._code_table]) == ptrs
    assert set(got.channels) == {9, 22}
    for i in range(2):
        x = synth_if(SATS, 16368 * 60, noise=0.5, seed=i + 1)
        ref.track_block(x)
        got.track_block(x)
        for prn, ch in got.channels.items():
            assert ch.epochs == ref.channels[prn].epochs == 60 * (i + 1)
            assert abs(ch.chips - ref.channels[prn].chips) <= 1e-3


# -- the mesh step ------------------------------------------------------------

C, BLOCK = 8, 128
TONES = ((7.100e6, 0.3), (14.2018e6, 0.2))


def _mesh_engine(use_graphs, whole=None, t_sz=2, k_sz=2):
    eng = ShardedStreamEngine(
        trx.RxParams(num_channels=C, audio_block=BLOCK),
        SyntheticSource(tones=TONES, noise_rms=1e-3, seed=11),
        mesh=tpar.make_mesh(t_sz, k_sz, devices=["cpu"] * (t_sz * k_sz)),
        use_graphs=use_graphs)
    if use_graphs and whole is not None:
        eng.program.whole = whole
    return eng


@pytest.mark.parametrize("whole", [True, False], ids=["whole", "segments"])
def test_static_mesh_step_equals_eager_to_the_bit(whole, tmp_path):
    """The compiled mesh step (one program, or a program a segment with
    the exchanges between) against the eager mesh step through SETs that
    open the LMS and spectral-NR gates of one group, ``retune_all`` and
    ``load_state``: taps and state equal in every block, and no state or
    tuning buffer rebound."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # a parallel sum's team may shrink
    try:
        _mesh_step_equals_eager(whole, tmp_path)
    finally:
        torch.set_num_threads(threads)


def _mesh_step_equals_eager(whole, tmp_path):
    eager, static = _mesh_engine(False), _mesh_engine(True, whole)
    assert not any(g.enabled for g in eager.program._graphs.values())
    assert all(g.enabled for g in static.program._graphs.values())
    assert static.program.whole is whole
    ptrs = (_ptrs(static.state), _ptrs(static.sharded_tuning.shards))
    ckpt = str(tmp_path / "mesh.pkl")
    for blk in range(7):
        for e in (eager, static):
            if blk == 2:
                e.set_channel(1, freq_hz=14.2e6, mode=demod.MODE_USB,
                              nr_notch_on=True, nr_den_on=True)
            if blk == 3:
                e.retune_all(e.params.adc_clock * (1 + 4e-7))
            if blk == 4:
                e.set_channel(5, freq_hz=7.1e6, mode=demod.MODE_AM,
                              nr_on=True)
            if blk == 5:
                if e is eager:
                    e.save_state(ckpt)
                e.load_state(ckpt)
        want, got = eager.run_block(), static.run_block()
        assert _equal(got, want), blk
        assert _equal(static.state, eager.state), blk
        assert [trx.gates(s) for r in static.sharded_tuning.shards
                for s in r] == [trx.gates(s) for r in
                                eager.sharded_tuning.shards for s in r]
    assert (_ptrs(static.state), _ptrs(static.sharded_tuning.shards)) == ptrs


def test_static_mesh_step_matches_reference():
    ref = JSharded(jrx.RxParams(num_channels=C, audio_block=BLOCK),
                   JSyntheticSource(tones=TONES, noise_rms=1e-3, seed=11),
                   mesh=jpar.make_mesh(time=2, chan=4))
    eng = _mesh_engine(True, t_sz=2, k_sz=4)
    for e in (ref, eng):
        e.set_channel(0, freq_hz=7.100e6, mode=demod.MODE_AM)
        e.set_channel(1, freq_hz=14.2e6, mode=demod.MODE_USB)
    for i in range(4):
        if i == 2:
            for e in (ref, eng):
                e.retune_all(e.params.adc_clock * (1 + 0.4e-6))
        r, g = ref.run_block(), eng.run_block()
        np.testing.assert_allclose(g.audio.numpy(), np.asarray(r.audio),
                                   rtol=0, atol=3e-3, err_msg=f"block {i}")
        np.testing.assert_allclose(g.smeter_dbm.numpy(),
                                   np.asarray(r.smeter_dbm), rtol=0,
                                   atol=0.2, err_msg=f"block {i}")


def test_static_mesh_step_across_two_processes_matches_one(tmp_path):
    """time=2 across two gloo processes, each running the compiled mesh
    step's segments with the halos, the re-shard and the carries as
    ``batch_isend_irecv`` and ``all_gather`` between them: the taps equal
    the one-process eager mesh's bit for bit, and the carries reach
    process 0 (``test_torch_parallel.py``'s two-process test, on the
    program)."""
    import multiprocessing
    import pickle
    from torch_mesh_helpers import (C as HC, BLOCK as HB, port_tunings,
                                    run_two_process_worker, scene)
    tp = trx.RxParams(num_channels=HC, audio_block=HB, stage2="unfused")
    blocks = list(scene(tp)[:2])
    ctx = multiprocessing.get_context("spawn")
    init = f"file://{tmp_path / 'store'}"
    out_path = str(tmp_path / "taps")
    procs = [ctx.Process(target=run_two_process_worker,
                         args=(r, init, out_path, blocks, True))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
        assert p.exitcode == 0
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mesh = tpar.make_mesh(2, 2, devices=["cpu"] * 4)
        step = tpar.make_sharded_rx_step(tp, mesh)
        st = tpar.shard_rx_state(trx.init_state(tp, "cpu"), mesh, tp)
        tts = tpar.shard_rx_tuning(port_tunings(tp, lms=True), mesh)
        want = []
        for x in blocks:
            st, sh_taps = step(st, tts, x)
            want.append(tpar.gather_taps(sh_taps, mesh, "cpu"))
    finally:
        torch.set_num_threads(threads)
    whole = tpar.gather_rx_state(st, mesh, "cpu")
    for rank in range(2):
        with open(f"{out_path}.{rank}", "rb") as f:
            got = pickle.load(f)
        for blk, taps in enumerate(want):
            for f in dataclasses.fields(taps):
                assert np.array_equal(got[blk][f.name],
                                      getattr(taps, f.name).numpy()), \
                    (rank, blk, f.name)
        assert np.array_equal(got[-1]["phi1"], whole.ddc.phi1.numpy())
        if rank == 0:
            assert np.array_equal(got[-1]["x_tail"],
                                  whole.ddc.x_tail.numpy())
            assert np.array_equal(got[-1]["y_tail"],
                                  whole.ddc.y_tail.numpy())


# -- the helper ---------------------------------------------------------------

def test_graph_set_runs_the_body_on_the_cpu_and_copy_into_checks_shapes():
    gs = _graphs.GraphSet("cpu")
    calls = []
    for _ in range(3):
        gs.run(("p",), lambda: calls.append(1))
    assert len(calls) == 3 and gs.graphs == {} and not gs.captures
    gs.prepare(("p",), lambda: calls.append(1), lambda: calls.append(2))
    assert len(calls) == 3                  # nothing to prepare here
    buf = torch.zeros(4)
    _graphs.copy_into(buf, torch.ones(4))
    assert torch.equal(buf, torch.ones(4))
    with pytest.raises(ValueError):
        _graphs.copy_into(buf, torch.ones(5))
    assert trx.copy_into is _graphs.copy_into
