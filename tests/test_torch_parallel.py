"""Port parity: the multi-device receiver step (``parallel/``) against the
JAX reference's sharded step and against the port's own single-device
``rx_block``, on the CPU.

The reference runs its ``shard_map`` on the eight virtual CPU devices
that ``tests/conftest.py`` gives JAX; the port runs its step over a mesh
of ``["cpu"] * 8``.  Both get the same numpy scene (a tone in every
channel's passband, noise) and the same tuning: distinct frequencies and
modes per channel, and the LMS notch and denoiser switched on for one
channel, in one shard, after two blocks.  C=8, audio_block=128 (k1/T =
992 >= tail2 = 713 at T=4).

Bounds: against the reference, ``iq_pre_fir`` within 1e-5, the audio of
the linear lanes (USB, LSB, CW, IQ) within 2e-4*max|audio| + 5e-5 (the
port's rx parity bound, ``tests/test_torch_rx.py``), every lane within
the reference's own mesh bound (3e-3), the S-meter within 1e-3 dB; the
LMS delay lines of the gathered state equal the reference's (zero in the
shards whose gates kept LMS off).  Against the port's single-device
step, the reference's mesh-against-single bounds
(``tests/test_parallel.py``): iq 1e-5, audio 3e-3, S-meter 0.1 dB.
"""

import dataclasses
import multiprocessing
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flydog_sdr_gps_tpu import parallel as jpar
from flydog_sdr_gps_tpu.models import rx_channel as jrx
from flydog_sdr_gps_tpu.ops import demod
from flydog_sdr_gps_tpu_torch import convert
from flydog_sdr_gps_tpu_torch import parallel as tpar
from flydog_sdr_gps_tpu_torch.models import rx_channel as trx
from flydog_sdr_gps_tpu_torch.parallel import distributed as tdist
from flydog_sdr_gps_tpu_torch.parallel import sharded_rx

from torch_mesh_helpers import (BLOCK, C, FREQS, LMS_CH, MODES, WARMUP,
                                port_tunings, run_two_process_worker, scene)

LMS_AT = WARMUP + 1
MESHES = [(1, 8), (2, 4), (4, 2)]
LINEAR = np.isin(MODES, (demod.MODE_USB, demod.MODE_LSB, demod.MODE_CW,
                         demod.MODE_IQ))


def _params():
    return (jrx.RxParams(num_channels=C, audio_block=BLOCK),
            trx.RxParams(num_channels=C, audio_block=BLOCK, stage2="unfused"))


def _tunings(jp):
    """The reference's tuning of the scene's channels and its port."""
    jt = jrx.default_tuning(jp, freqs_hz=FREQS, modes=MODES)
    return jt, convert.tuning_from_ref(jax.tree.map(np.asarray, jt), "cpu")


def _lms_on(jt, tt, mesh):
    """Switch the LMS chain on for LMS_CH in both tunings; the port's is
    re-sharded over ``mesh``, as the engine does on a SET."""
    jt = dataclasses.replace(jt, nr_notch_on=jt.nr_notch_on.at[LMS_CH].set(
        True), nr_den_on=jt.nr_den_on.at[LMS_CH].set(True))
    tt.nr_notch_on[LMS_CH] = True
    tt.nr_den_on[LMS_CH] = True
    tt = trx.with_gates(tt)
    return jt, tt, tpar.shard_rx_tuning(tt, mesh)


def _cpu_mesh(t_sz, k_sz):
    return tpar.make_mesh(t_sz, k_sz, devices=["cpu"] * (t_sz * k_sz))


def _audio_tol(ref):
    return 2e-4 * max(np.abs(ref).max(), 1e-6) + 5e-5


@pytest.mark.parametrize("t_sz,k_sz", MESHES)
def test_mesh_step_matches_reference(t_sz, k_sz):
    jp, tp = _params()
    jt, tt = _tunings(jp)
    jmesh = jpar.make_mesh(time=t_sz, chan=k_sz)
    jstep = jpar.make_sharded_rx_step(jp, jmesh)
    js = jpar.shard_rx_state(jrx.init_state(jp), jmesh, jp)
    mesh = _cpu_mesh(t_sz, k_sz)
    step = tpar.make_sharded_rx_step(tp, mesh)
    run_a = tpar.shard_rx_state(trx.init_state(tp, "cpu"), mesh, tp)
    run_b = None
    tts = tpar.shard_rx_tuning(tt, mesh)
    for blk, x in enumerate(scene(tp)):
        if blk == WARMUP:
            run_b = tpar.shard_rx_state(convert.state_from_ref(
                jax.tree.map(np.asarray, js), tp, "unfused", "cpu"), mesh, tp)
        if blk == LMS_AT:
            jt, tt, tts = _lms_on(jt, tt, mesh)
            gate = [[s.any_lms for s in row] for row in tts.shards]
            assert sum(map(sum, gate)) == 1       # one shard runs LMS
        js, jtaps = jstep(js, jpar.shard_rx_tuning(jt, jmesh),
                          jnp.asarray(x))
        jiq = (np.asarray(jtaps.iq_pre_fir.re)
               + 1j * np.asarray(jtaps.iq_pre_fir.im))
        ref = np.asarray(jtaps.audio)
        runs = [("A", run_a)] if run_b is None else [("B", run_b)]
        for name, st in runs:
            st, sh_taps = step(st, tts, x)
            taps = tpar.gather_taps(sh_taps, mesh, "cpu")
            msg = f"mesh {t_sz}x{k_sz}, run {name}, block {blk}"
            got = taps.audio.numpy()
            np.testing.assert_allclose(taps.iq_pre_fir.numpy(), jiq, rtol=0,
                                       atol=1e-5, err_msg=msg)
            np.testing.assert_allclose(got, ref, rtol=0, atol=3e-3,
                                       err_msg=msg)
            if name == "B":
                np.testing.assert_allclose(got[:, LINEAR], ref[:, LINEAR],
                                           rtol=0, atol=_audio_tol(ref),
                                           err_msg=msg)
                np.testing.assert_allclose(taps.smeter_dbm.numpy(),
                                           np.asarray(jtaps.smeter_dbm),
                                           rtol=0, atol=1e-3, err_msg=msg)
                run_b = st
            else:
                run_a = st
    assert np.abs(ref[:, LMS_CH]).max() > 0.05
    # gates are per shard: only the LMS channel's shard advanced its lines
    whole = tpar.gather_rx_state(run_b, mesh, "cpu")
    for name in ("lms_notch", "lms_den"):
        want = np.asarray(getattr(js, name).line)
        got = getattr(whole, name).line.numpy()
        assert np.abs(want[:, LMS_CH]).max() > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=_audio_tol(want))
        if t_sz * k_sz == C:                   # one channel a shard
            others = np.delete(np.arange(C), LMS_CH)
            assert not got[:, others].any() and not want[:, others].any()


@pytest.mark.parametrize("t_sz,k_sz", MESHES + [(2, 2)])
def test_mesh_step_matches_single_device(t_sz, k_sz):
    _, tp = _params()
    _, tt = _tunings(_params()[0])
    mesh = _cpu_mesh(t_sz, k_sz)
    step = tpar.make_sharded_rx_step(tp, mesh)
    ts = tpar.shard_rx_state(trx.init_state(tp, "cpu"), mesh, tp)
    tts = tpar.shard_rx_tuning(tt, mesh)
    ss = trx.init_state(tp, "cpu")
    for x in scene(tp)[:4]:
        ss, ref = trx.rx_block(tp, ss, tt, torch.from_numpy(x))
        ts, sh_taps = step(ts, tts, x)
        got = tpar.gather_taps(sh_taps, mesh, "cpu")
        torch.testing.assert_close(got.iq_pre_fir, ref.iq_pre_fir, rtol=0,
                                   atol=1e-5)
        torch.testing.assert_close(got.audio, ref.audio, rtol=0, atol=3e-3)
        torch.testing.assert_close(got.smeter_dbm, ref.smeter_dbm, rtol=0,
                                   atol=0.1)
    # the DDC carries equal the single-device ones
    whole = tpar.gather_rx_state(ts, mesh, "cpu")
    assert torch.equal(whole.ddc.phi1, ss.ddc.phi1)
    assert torch.equal(whole.ddc.x_tail, ss.ddc.x_tail)
    torch.testing.assert_close(whole.ddc.y_tail, ss.ddc.y_tail, rtol=0,
                               atol=1e-5)


def _random_state(tp, seed):
    """An RxState whose every element is distinct (so that a permuted
    channel shows)."""
    gen = torch.Generator().manual_seed(seed)

    def fill(x):
        if x.dtype == torch.bool:
            return torch.rand(x.shape, generator=gen) > 0.5
        if x.dtype in (torch.int32, torch.int64):
            return torch.randint(0, 1 << 30, x.shape, generator=gen,
                                 dtype=x.dtype)
        if x.is_complex():
            return torch.complex(torch.randn(x.shape, generator=gen),
                                 torch.randn(x.shape, generator=gen))
        return torch.randn(x.shape, generator=gen, dtype=x.dtype)
    return sharded_rx._map_fields(trx.init_state(tp, "cpu"), fill)


@pytest.mark.parametrize("t_sz,k_sz", MESHES)
def test_shard_and_gather_state_round_trip(t_sz, k_sz):
    _, tp = _params()
    mesh = _cpu_mesh(t_sz, k_sz)
    s = _random_state(tp, 3)
    back = tpar.gather_rx_state(tpar.shard_rx_state(s, mesh, tp), mesh,
                                "cpu")
    for a, b in zip(_leaves(s), _leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # ownership: device (t, k) holds channel group k*T + t
    sh = tpar.shard_rx_state(s, mesh, tp)
    c_local = C // (t_sz * k_sz)
    for t in range(t_sz):
        for k in range(k_sz):
            g = k * t_sz + t
            assert torch.equal(sh.back[t][k].smeter,
                               s.smeter[g * c_local:(g + 1) * c_local])


def _leaves(state):
    out = []
    sharded_rx._map_fields(state, lambda x: out.append(x) or x)
    return out


def test_tuning_shards_own_their_groups():
    jp, tp = _params()
    _, tt = _tunings(jp)
    mesh = _cpu_mesh(2, 2)
    tts = tpar.shard_rx_tuning(tt, mesh)
    for t in range(2):
        for k in range(2):
            g, sh = k * 2 + t, tts.shards[t][k]
            assert torch.equal(sh.bank, tt.bank[:, k * 4:(k + 1) * 4])
            assert torch.equal(sh.dphi1, tt.dphi1[k * 4:(k + 1) * 4])
            assert torch.equal(sh.mode, tt.mode[g * 2:(g + 1) * 2])
            assert torch.equal(sh.pb_coef, tt.pb_coef[:, g * 2:(g + 1) * 2])
            assert sh.any_lms is False and float(sh.fm_deviation) == 2500.0
    # after a SET the re-sharded tuning carries the change to every time
    # row of its channel shard, and the gates to its group's shard only
    tt.mode[5] = demod.MODE_SAL
    tt.bank[:, 5] = 0
    tt = trx.with_gates(tt)
    tts = tpar.shard_rx_tuning(tt, mesh)
    assert tts.shards[0][1].any_sideband and not tts.shards[1][1].any_sideband
    assert int(tts.shards[0][1].mode[1]) == demod.MODE_SAL
    for t in range(2):
        assert not tts.shards[t][1].bank[:, 1].any()


def test_mesh_objects_and_errors(monkeypatch):
    mesh = _cpu_mesh(2, 4)
    assert tpar.mesh_shape(mesh) == (2, 4)
    assert mesh.shape == {"time": 2, "chan": 4} and mesh.size == 8
    assert mesh.device(1, 3) == torch.device("cpu")
    assert tpar.mesh_shape(tpar.make_mesh(2, devices=["cpu"] * 8)) == (2, 4)
    with pytest.raises(ValueError) as want:
        jpar.make_mesh(time=3, chan=3)
    with pytest.raises(ValueError) as got:
        tpar.make_mesh(3, 3, devices=["cpu"] * 8)
    assert str(got.value) == str(want.value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"devices=\['cpu'\] \* n"):
        tpar.make_mesh(1, 1)


@pytest.mark.parametrize("kw,t_sz,k_sz", [
    (dict(num_channels=12), 2, 4), (dict(audio_block=130), 4, 2),
    (dict(audio_block=64), 4, 2)])
def test_step_requirements_raise_the_reference_messages(kw, t_sz, k_sz):
    kw = dict(dict(num_channels=C, audio_block=BLOCK), **kw)
    with pytest.raises(ValueError) as want:
        jpar.make_sharded_rx_step(jrx.RxParams(**kw),
                                  jpar.make_mesh(time=t_sz, chan=k_sz))
    with pytest.raises(ValueError) as got:
        tpar.make_sharded_rx_step(trx.RxParams(**kw),
                                  _cpu_mesh(t_sz, k_sz))
    assert str(got.value) == str(want.value)


def test_distributed_glue_single_process():
    """The multi-process helpers collapse to one process and compose
    with the sharded receiver."""
    assert tdist.init_distributed() == 1
    mesh = tdist.make_global_mesh(time=2, chan=4, devices=["cpu"] * 8)
    assert mesh.shape == {"time": 2, "chan": 4}
    assert mesh.num_processes == 1 and mesh.local_rows == [0, 1]
    params = trx.RxParams(num_channels=8, audio_block=128)
    step = tpar.make_sharded_rx_step(params, mesh)
    state = tpar.shard_rx_state(trx.init_state(params, "cpu"), mesh, params)
    tuning = tpar.shard_rx_tuning(trx.default_tuning(params, "cpu"), mesh)
    x = tdist.host_shard_block(
        mesh, np.zeros(params.ddc.adc_block, np.float32))
    holder = {"s": state}

    def fn(t, xx):
        holder["s"], taps = step(holder["s"], t, xx)
        return taps
    rep = tdist.scaling_report(mesh, fn, (tuning, x), iters=2)
    assert rep["devices"] == 8 and rep["step_seconds"] > 0


def test_global_mesh_keeps_the_chan_axis_in_a_process(monkeypatch):
    """Two processes of two devices: time=2 gives each process a row;
    time=1 would carry the chan axis across processes and is refused."""
    monkeypatch.setattr(tdist, "process_count", lambda: 2)
    monkeypatch.setattr(tdist, "process_index", lambda: 1)
    mesh = tdist.make_global_mesh(devices=["cpu"] * 2)
    assert mesh.shape == {"time": 2, "chan": 2}
    assert mesh.row_process == (0, 1) and mesh.local_rows == [1]
    with pytest.raises(ValueError, match="chan axis would cross"):
        tdist.make_global_mesh(time=1, chan=4, devices=["cpu"] * 2)


# -- two processes over gloo ---------------------------------------------------

def test_two_processes_match_the_single_process_mesh(tmp_path):
    """time=2 across two gloo processes (a file store, no TCP port),
    chan=2 CPU devices in each: the taps equal the one-process (2, 2)
    mesh's bit for bit, and the carries reach process 0."""
    _, tp = _params()
    blocks = list(scene(tp)[:2])
    ctx = multiprocessing.get_context("spawn")
    init = f"file://{tmp_path / 'store'}"
    out_path = str(tmp_path / "taps")
    procs = [ctx.Process(target=run_two_process_worker,
                         args=(r, init, out_path, blocks))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
        assert p.exitcode == 0
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mesh = _cpu_mesh(2, 2)
        _, tt = (None, port_tunings(tp, lms=True))
        step = tpar.make_sharded_rx_step(tp, mesh)
        st = tpar.shard_rx_state(trx.init_state(tp, "cpu"), mesh, tp)
        tts = tpar.shard_rx_tuning(tt, mesh)
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
        carries = got[-1]
        assert np.array_equal(carries["phi1"], whole.ddc.phi1.numpy())
        if rank == 0:
            assert np.array_equal(carries["x_tail"],
                                  whole.ddc.x_tail.numpy())
            assert np.array_equal(carries["y_tail"],
                                  whole.ddc.y_tail.numpy())
