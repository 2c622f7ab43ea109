"""The compiled block step (``use_graphs``) on the CPU: the static-buffer
step that a card captures in CUDA graphs, run here without capture.

- Against the port's eager engine (``use_graphs=False``): equal to the
  bit, taps, served results and state, through SETs that open and close
  every host gate (SAM sidebands, the LMS pair, spectral NR, NB_WILD),
  ``retune_all``, ``load_state``, ``reset_streaming_state`` and a bucket
  change of the serving path.
- Against the reference's jitted ``StreamEngine`` (its default
  ``use_jit=True``): the bounds of `test_torch_stream.py`, audio of the
  listened lanes within 2e-4*max|audio| + 5e-5 from the block on where
  the passband FIR has filled, through a retune.
- No state or tuning buffer is rebound by the control plane: each
  tensor's ``data_ptr`` stays the same.
- The launch counters' capture record (``_build.recording``): a capture
  counts nothing itself, each replay credits what it recorded.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from flydog_sdr_gps_tpu.models import rx_channel as jrx
from flydog_sdr_gps_tpu.runtime import source as jsource
from flydog_sdr_gps_tpu.runtime import stream as jstream
from flydog_sdr_gps_tpu_torch import _build
from flydog_sdr_gps_tpu_torch.models import rx_channel as trx
from flydog_sdr_gps_tpu_torch.ops import demod, kernels
from flydog_sdr_gps_tpu_torch.runtime import source as tsource
from flydog_sdr_gps_tpu_torch.runtime import stream as tstream
from flydog_sdr_gps_tpu_torch.runtime.stream import _state_leaves

TONES = ((14.201e6, 0.5), (21.0015e6, 0.5), (7.1007e6, 0.3))
C, BLOCK = 8, 128


def _engine(use_graphs, stage2="fused"):
    eng = tstream.StreamEngine(
        trx.RxParams(num_channels=C, audio_block=BLOCK, stage2=stage2),
        tsource.SyntheticSource(TONES, 0.001, seed=4), device="cpu",
        use_graphs=use_graphs)
    eng.set_channel(0, freq_hz=14.200e6, mode=demod.MODE_USB, in_use=True)
    eng.set_channel(1, freq_hz=21.003e6, mode=demod.MODE_LSB, in_use=True)
    eng.set_channel(2, freq_hz=7.100e6, mode=demod.MODE_AM, in_use=True)
    return eng


def _tuning_leaves(t):
    return [getattr(t, f.name) for f in dataclasses.fields(t)
            if isinstance(getattr(t, f.name), torch.Tensor)]


# (block, what happens before it): every gate opens, then closes again
def _events(tmp_path):
    ckpt = str(tmp_path / "eager.pkl")
    return {
        2: ("set", 3, dict(freq_hz=7.1005e6, mode=demod.MODE_SAS)),
        3: ("set", 4, dict(freq_hz=14.2005e6, nr_notch_on=True,
                           nr_den_on=True)),
        4: ("set", 5, dict(freq_hz=21.0005e6, nr_on=True)),
        5: ("set", 6, dict(nb_on=True, nb_wild=True, deemph_on=True,
                           squelch=3.0, agc_on=False, manual_gain_db=30.0)),
        6: ("retune_all", 1 + 4e-7),
        7: ("gather", np.array([0, 1, 2, 5], np.int32)),
        8: ("gather", np.array([5, 2, 1, 0, 3, 4, 6, 7], np.int32)),
        9: ("save_load", ckpt),
        10: ("set", 3, dict(mode=demod.MODE_USB)),
        11: ("set", 4, dict(nr_notch_on=False, nr_den_on=False)),
        12: ("set", 5, dict(nr_on=False)),
        13: ("set", 6, dict(nb_wild=False)),
        14: ("reset", None),
        15: ("gather", np.array([0, 1, 2, 5], np.int32)),
    }


def _apply(eng, event, eager):
    kind, a, *rest = event
    if kind == "set":
        eng.set_channel(a, **rest[0])
    elif kind == "retune_all":
        eng.retune_all(eng.params.adc_clock * a)
    elif kind == "save_load":
        if eng is eager:
            eng.save_state(a)
        eng.load_state(a)
    elif kind == "reset":
        eng.reset_streaming_state()


@pytest.fixture
def one_thread():
    """One CPU thread for a comparison to the bit: with several, a
    parallel reduction's team (OpenMP, MKL) may shrink under load and sum
    in another order, in either engine, whatever the code under test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("stage2", ["fused", "unfused"])
def test_static_step_equals_eager_engine_to_the_bit(tmp_path, stage2,
                                                    one_thread):
    eager, static = _engine(False, stage2), _engine(True, stage2)
    assert eager.compiled is None and static.compiled is not None
    events = _events(tmp_path)
    seen_gates = set()
    for blk in range(17):
        event = events.get(blk)
        if event is not None and event[0] != "gather":
            for eng in (eager, static):
                _apply(eng, event, eager)
        assert trx.gates(static.tuning) == trx.gates(eager.tuning)
        seen_gates.add(trx.gates(static.tuning))
        if event is not None and event[0] == "gather":
            want = eager.fetch(eager.run_block_gather(event[1]))
            got = static.fetch(static.run_block_gather(event[1]))
            np.testing.assert_array_equal(got, want, err_msg=f"block {blk}")
        else:
            want, got = eager.run_block(), static.run_block()
            for f in dataclasses.fields(want):
                np.testing.assert_array_equal(
                    getattr(got, f.name).numpy(), getattr(want, f.name).numpy(),
                    err_msg=f"block {blk}: {f.name}")
        for i, (g, w) in enumerate(zip(_state_leaves(static.state),
                                       _state_leaves(eager.state))):
            np.testing.assert_array_equal(g.numpy(), w.numpy(),
                                          err_msg=f"block {blk}: leaf {i}")
        for g, w in zip(_tuning_leaves(static.tuning),
                        _tuning_leaves(eager.tuning)):
            np.testing.assert_array_equal(g.numpy(), w.numpy())
    # every gate was open at some block, and closed again at the end
    for k in range(4):
        assert any(g[k] for g in seen_gates), f"gate {k} never opened"
    assert trx.gates(static.tuning) == (False, False, False, False)
    assert static.seq == eager.seq and static.resets == eager.resets == 1
    assert static.block_ticks == eager.block_ticks


def test_no_state_or_tuning_buffer_is_rebound(tmp_path):
    eng = _engine(True)
    step = eng.compiled

    def ptrs():
        return ([t.data_ptr() for t in _state_leaves(eng.state)],
                [t.data_ptr() for t in _tuning_leaves(eng.tuning)],
                step.x.data_ptr(),
                [t.data_ptr() for t in _state_leaves(step.taps)])
    before = ptrs()
    eng.run_block()
    eng.set_channel(3, freq_hz=7.1005e6, mode=demod.MODE_SAU, nr_on=True,
                    nr_notch_on=True, nb_on=True, nb_wild=True)
    assert all(trx.gates(eng.tuning))
    eng.retune_all(eng.params.adc_clock * (1 + 1e-6))
    eng.run_block_gather(np.array([0, 3], np.int32))
    prog = eng._gstep_for(2)
    packed_ptr = prog.packed.data_ptr()
    eng.prewarm_gather(4)                   # nothing to capture here
    eng.run_block_gather(np.array([0, 3, 1, 2], np.int32))
    eng.save_state(str(tmp_path / "s.pkl"))
    eng.load_state(str(tmp_path / "s.pkl"))
    eng.reset_streaming_state()
    eng.tuning = trx.with_gates(dataclasses.replace(
        eng.tuning, nr_on=torch.zeros(C, dtype=torch.bool)))
    assert not eng.tuning.any_spectral_nr
    eng.run_block()
    assert eng.run_block_gather(np.array([1, 2], np.int32)) is prog.packed
    assert prog.packed.data_ptr() == packed_ptr
    assert ptrs() == before
    assert eng.state is step.state and eng.tuning is step.tuning
    assert step.graphs == {}                # the CPU captures nothing


def test_assigning_a_buffer_of_another_shape_raises():
    eng = _engine(True)
    bad = dataclasses.replace(eng.tuning, mode=torch.zeros(C + 1,
                                                           dtype=torch.int32))
    with pytest.raises(ValueError, match="buffer"):
        eng.tuning = bad
    bad = dataclasses.replace(eng.tuning,
                              mode=eng.tuning.mode.to(torch.int64))
    with pytest.raises(ValueError, match="buffer"):
        eng.tuning = bad


def test_static_step_matches_jitted_reference():
    """The reference's engine with its default use_jit=True (one jitted
    program a block) against the port's static-buffer step, through a
    retune at block 10 (the bounds of test_torch_stream.py's retune
    test; unfused branch, C=2)."""
    kw = dict(num_channels=2, audio_block=BLOCK)
    tones = TONES[:2]
    ref = jstream.StreamEngine(jrx.RxParams(stage2="poly", **kw),
                               jsource.SyntheticSource(tones, 0.001))
    port = tstream.StreamEngine(trx.RxParams(stage2="unfused", **kw),
                                tsource.SyntheticSource(tones, 0.001),
                                device="cpu", use_graphs=True)
    for eng in (ref, port):
        eng.set_channel(0, freq_hz=14.200e6, mode=demod.MODE_USB,
                        in_use=True)
        eng.set_channel(1, freq_hz=21.003e6, mode=demod.MODE_LSB,
                        in_use=True)
    filled, retune = 8, 10
    for blk in range(14):
        if blk == retune:
            for eng in (ref, port):
                eng.set_channel(0, freq_hz=21.000e6)
        r = np.asarray(ref.run_block().audio)
        g = port.run_block().audio.numpy()
        if blk >= filled:
            tol = 2e-4 * max(np.abs(r).max(), 1e-6) + 5e-5
            np.testing.assert_allclose(g, r, rtol=0, atol=tol,
                                       err_msg=f"block {blk}")
    assert port.seq == ref.seq and port.block_ticks == ref.block_ticks


def test_capture_record_redirects_this_threads_counts():
    fn = kernels.stage2
    start = fn.launches
    with _build.recording() as rec:
        _build.count_launch(fn)
        _build.count_launch(fn)
        # another thread launching meanwhile counts as usual
        t = threading.Thread(target=_build.count_launch, args=(fn,))
        t.start()
        t.join()
        with pytest.raises(RuntimeError, match="already recording"):
            with _build.recording():
                pass
    assert rec == {fn: 2}
    assert fn.launches == start + 1
    _build.credit(rec)                      # one replay
    _build.credit(rec)                      # another
    assert fn.launches == start + 5
    _build.count_launch(fn)                 # recording over: counts again
    assert fn.launches == start + 6


def test_launch_counts_lose_no_update_across_threads():
    """Replays credit counters on the block loop while another thread
    warms or counts: no increment may be lost."""
    import sys
    fn = kernels.stage2
    start = fn.launches
    rec = {fn: 3}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for _ in range(2000):
                if k % 2:
                    _build.count_launch(fn)
                else:
                    _build.credit(rec)
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert fn.launches == start + 8 * 2000 * (1 + 3)
