"""The port's ``ShardedStreamEngine`` against the reference's and against
the port's unfused single-device ``StreamEngine``, on the CPU: the same
audio through the control plane (SET retunes, an LSB retune, the GPS
clock's ``retune_all``), checkpoints across the two engines, the scaling
report, and the server over a mesh engine (the reference's
``tests/test_sharded_engine.py``, with in-process sockets instead of a
fixed TCP port).

Bounds: the reference's engine test's (audio 3e-3, S-meter 0.2 dB)
between the port's mesh engine and the reference's; the reference's
mesh-against-single bounds (iq 1e-5, audio 3e-3, S-meter 0.1 dB) between
the port's mesh engine and its unfused engine; a checkpoint reloaded
into the same kind of engine gives the uninterrupted engine's next block
exactly.
"""

import asyncio
import time

import numpy as np
import pytest
import torch

from flydog_sdr_gps_tpu import parallel as jpar
from flydog_sdr_gps_tpu.models import rx_channel as jrx
from flydog_sdr_gps_tpu.runtime import ShardedStreamEngine as JSharded
from flydog_sdr_gps_tpu.runtime import SyntheticSource as JSource
from flydog_sdr_gps_tpu_torch import convert
from flydog_sdr_gps_tpu_torch import parallel as tpar
from flydog_sdr_gps_tpu_torch.models import rx_channel as trx
from flydog_sdr_gps_tpu_torch.ops import demod
from flydog_sdr_gps_tpu_torch.runtime import (ShardedStreamEngine,
                                              StreamEngine, SyntheticSource)
from flydog_sdr_gps_tpu_torch.runtime import stream as tstream
from flydog_sdr_gps_tpu_torch.server import kiwi_server as tks

C, BLOCK = 8, 128
TONES = ((7.100e6, 0.3), (14.2018e6, 0.2))


def _source(mod=SyntheticSource):
    return mod(tones=TONES, noise_rms=1e-3, seed=11)


def _params(**kw):
    return trx.RxParams(num_channels=C, audio_block=BLOCK, **kw)


def _mesh(t_sz, k_sz):
    return tpar.make_mesh(t_sz, k_sz, devices=["cpu"] * (t_sz * k_sz))


def _unfused():
    return StreamEngine(_params(stage2="unfused"), _source(), device="cpu")


def _close(got, want, audio=3e-3, smeter=0.1, iq=None, msg=""):
    a = got.audio.numpy() if isinstance(got.audio, torch.Tensor) \
        else np.asarray(got.audio)
    b = want.audio.numpy() if isinstance(want.audio, torch.Tensor) \
        else np.asarray(want.audio)
    np.testing.assert_allclose(a, b, rtol=0, atol=audio, err_msg=msg)
    np.testing.assert_allclose(np.asarray(got.smeter_dbm),
                               np.asarray(want.smeter_dbm), rtol=0,
                               atol=smeter, err_msg=msg)
    if iq is not None:
        torch.testing.assert_close(got.iq_pre_fir, want.iq_pre_fir, rtol=0,
                                   atol=iq, msg=msg)


def test_sharded_engine_matches_reference_and_unfused_engine():
    ref = JSharded(jrx.RxParams(num_channels=C, audio_block=BLOCK),
                   _source(JSource), mesh=jpar.make_mesh(time=2, chan=4))
    eng = ShardedStreamEngine(_params(), _source(), mesh=_mesh(2, 4))
    single = _unfused()
    # served through the base's contract: its unfused gather, no prepare
    assert (ShardedStreamEngine.run_block_gather
            is StreamEngine.run_block_gather)
    assert eng.compiled is None
    assert eng.device == torch.device("cpu")
    engines = (ref, eng, single)
    for e in engines:
        e.set_channel(0, freq_hz=7.100e6, mode=demod.MODE_AM)
        e.set_channel(1, freq_hz=14.2e6, mode=demod.MODE_USB)

    def blocks(n, what):
        for i in range(n):
            r, got, s = (e.run_block() for e in engines)
            _close(got, r, smeter=0.2, msg=f"{what}, block {i}: reference")
            _close(got, s, iq=1e-5, msg=f"{what}, block {i}: unfused")
        return got
    blocks(3, "start")
    # control plane mid-stream: one channel to LSB on another frequency
    for e in engines:
        e.set_channel(1, freq_hz=14.1e6, mode=demod.MODE_LSB,
                      passband=(-2700.0, -300.0))
    sh = eng.sharded_tuning.shards
    assert int(sh[1][0].mode[0]) == demod.MODE_LSB   # group 1 = (1, 0)
    blocks(2, "after SET")
    # clock-discipline feedback (GPS retunes every NCO)
    for e in engines:
        e.retune_all(e.params.adc_clock * (1 + 0.4e-6))
    taps = blocks(1, "after retune_all")
    assert taps.audio.shape == (BLOCK, C)
    assert eng._last_x.shape == (eng.params.ddc.adc_block,)
    assert eng.seq == 6


def _set_all(eng):
    for ch in range(C):
        eng.set_channel(ch, freq_hz=3.0e6 + 3.1e6 * ch, in_use=True,
                        mode=demod.MODE_USB if ch % 2 else demod.MODE_AM)


def _run(eng, n):
    for _ in range(n):
        taps = eng.run_block()
    return taps


def test_sharded_engine_checkpoint_round_trip(tmp_path):
    """Save after two blocks; a new mesh engine that loads the file gives
    the uninterrupted engine's third block exactly; an unfused
    single-device engine loads the same file, and its own checkpoint
    loads into a mesh engine."""
    mesh = _mesh(1, 8)
    eng = ShardedStreamEngine(_params(), _source(), mesh=mesh)
    _set_all(eng)
    _run(eng, 2)
    path = str(tmp_path / "mesh.pkl")
    eng.save_state(path)
    want = eng.run_block()

    def resumed(e):
        e.source.next_block(2 * e.params.ddc.adc_block)  # same position
        e.load_state(path)
        assert e.seq == 2 and e.ctl[2].freq_hz == pytest.approx(9.2e6)
        return e
    again = resumed(ShardedStreamEngine(_params(), _source(), mesh=mesh))
    got = again.run_block()
    for name in ("audio", "audio2", "iq_pre_fir", "iq_post_agc",
                 "smeter_dbm"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    single = resumed(_unfused())
    _close(single.run_block(), want, iq=1e-5)
    # the other way round: the single-device engine's checkpoint
    path2 = str(tmp_path / "single.pkl")
    single.save_state(path2)
    want2 = single.run_block()
    other = ShardedStreamEngine(_params(), _source(), mesh=_mesh(2, 2))
    other.source.next_block(3 * other.params.ddc.adc_block)
    other.load_state(path2)
    _close(other.run_block(), want2, iq=1e-5)


def test_load_ctl_retunes_the_mesh():
    """``convert.load_ctl`` assigns the engine's whole tuning: the mesh
    runs on the loaded tuning (channel 1 moves from AM on 7.1 MHz to USB
    under the 14.2018 MHz tone), in step with an unfused engine given the
    same history."""
    ctl = StreamEngine(_params(), _source(), device="cpu")
    ctl.set_channel(0, freq_hz=7.100e6, mode=demod.MODE_AM)
    ctl.set_channel(1, freq_hz=14.2e6, mode=demod.MODE_USB)
    engines = (ShardedStreamEngine(_params(), _source(), mesh=_mesh(2, 2)),
               _unfused())
    for e in engines:
        e.set_channel(1, freq_hz=7.100e6, mode=demod.MODE_AM)
    before = [_run(e, 2) for e in engines][0].audio[:, 1].clone()
    for e in engines:
        convert.load_ctl(e, ctl.ctl)
    eng = engines[0]
    assert int(eng.sharded_tuning.shards[0][0].mode[1]) == demod.MODE_USB
    for i in range(8):
        got, want = (e.run_block() for e in engines)
        _close(got, want, iq=1e-5, msg=f"block {i} after load_ctl")
    assert not torch.allclose(got.audio[:, 1], before, atol=1e-3)
    hz = np.fft.rfftfreq(BLOCK, 1 / eng.params.fs_out)
    spec = np.abs(np.fft.rfft(got.audio[:, 1].numpy()))
    assert abs(hz[spec.argmax()] - 1800.0) <= eng.params.fs_out / BLOCK


def test_sharded_engine_reset_and_scaling_report():
    eng = ShardedStreamEngine(_params(), _source(),
                              mesh=_mesh(2, 2))
    _set_all(eng)
    taps = eng.run_block()
    assert torch.isfinite(taps.audio).all()
    rep = eng.scaling_report(iters=2)
    assert rep["devices"] == 4 and rep["step_seconds"] > 0
    assert (rep["time_shards"], rep["chan_shards"], rep["channels"]) == \
        (2, 2, C)
    eng.reset_streaming_state()
    assert eng.resets == 1
    whole = tpar.gather_rx_state(eng.state, eng.mesh, "cpu")
    assert not whole.ddc.x_tail.any() and not whole.smeter.any()


# -- the server over the mesh -------------------------------------------------

class _Sock:
    def __init__(self):
        self.sent: list[bytes] = []
        self.closed = False

    async def send_bytes(self, data):
        self.sent.append(bytes(data))

    async def close(self):
        self.closed = True


def _snd_audio(sock) -> np.ndarray:
    """The s16 audio of every SND packet (compression off, big-endian)."""
    rows = [np.frombuffer(p[10:], ">i2") for p in sock.sent
            if p[:3] == b"SND"]
    return np.concatenate(rows).astype(np.float64) / 32768.0


async def _hear(engine, packets=20) -> np.ndarray:
    server = tks.KiwiServer(engine, realtime=False, port=0)
    server.start_tasks()
    try:
        sock = _Sock()
        conn = await server.open_stream("42", "SND", sock, "127.0.0.1")
        for cmd in ("SET auth t=kiwi p=", "SET compression=0",
                    "SET mod=usb low_cut=300 high_cut=2700 freq=14200.00"):
            await conn.handle_set(cmd, "SND")
        t0 = time.monotonic()
        while sum(p[:3] == b"SND" for p in sock.sent) < packets:
            await asyncio.sleep(0.01)
            assert time.monotonic() - t0 < 120, "no audio"
        assert 1 in server._warm_buckets        # the one listener's bucket
        return _snd_audio(sock)
    finally:
        await server.stop()


def _tone_hz(a):
    a = a[1024:]
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
    return np.fft.rfftfreq(len(a), 1 / 12000.0)[np.argmax(spec)]


def test_server_over_mesh_serves_matching_audio():
    """The ``run_server --mesh`` gate: a listener hears the same tone
    through the mesh engine as through the single-device one."""
    a_single = asyncio.run(_hear(_unfused()))
    a_mesh = asyncio.run(_hear(ShardedStreamEngine(_params(), _source(),
                                                   mesh=_mesh(2, 4))))
    # both hear the 14.2018 MHz tone at ~1.8 kHz audio
    assert abs(_tone_hz(a_single) - 1800.0) < 40
    assert abs(_tone_hz(a_mesh) - 1800.0) < 40
    # the same seeded source: the same waveform up to where the capture
    # started; align by cross-correlation, compare the settled tails
    s, m = a_single, a_mesh
    n = min(len(s), len(m)) // 3
    d = int(np.argmax(np.correlate(m[:3 * n], s[n:2 * n], "valid"))) - n
    i0, i1 = max(0, -d), min(len(s), len(m) - d)
    assert i1 - i0 > n, f"no overlap after alignment (d={d})"
    k0 = i0 + (i1 - i0) // 2
    ma, sa = m[k0 + d:i1 + d], s[k0:i1]
    rho = float(np.dot(ma, sa) /
                (np.linalg.norm(ma) * np.linalg.norm(sa) + 1e-12))
    assert rho > 0.98, f"aligned tail correlation {rho:.4f}"


def test_server_packs_the_mesh_engine_like_the_fused_path():
    """The server's step on a mesh engine packs its taps' columns in the
    layout the single engine's ``run_block_gather`` returns: a mesh
    engine's packed block equals an unfused engine's pack within the
    mesh bounds, same length."""
    eng = ShardedStreamEngine(_params(), _source(), mesh=_mesh(2, 4))
    single = _unfused()
    server = tks.KiwiServer(eng, realtime=False, port=0)
    idx = np.array([1, 0, 5, 0], np.int32)
    got = server._step_and_fetch(idx).result()
    want = single.fetch(single.run_block_gather(idx))
    assert got.shape == want.shape == (eng.packed_len(4),)
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-3)
    assert got[-1] == pytest.approx(float(np.abs(
        eng._last_x.numpy()).max()))


def _frozen(eng) -> list[torch.Tensor]:
    """Copies of what a block reads and moves: the whole state, the
    shard buffers of the tuning, ``seq`` and ``block_ticks``."""
    leaves = tstream._state_leaves(tpar.gather_rx_state(eng.state, eng.mesh,
                                                        "cpu"))
    for row in eng.sharded_tuning.shards:
        leaves += [t for sh in row if sh is not None
                   for t in (sh.bank, sh.dphi1, sh.mode, sh.pb_coef)]
    return [t.clone() for t in leaves] + [
        torch.tensor([eng.seq, eng.block_ticks])]


def test_mesh_gather_packs_run_blocks_columns():
    """Two mesh engines from one state, through a SET and a
    ``retune_all`` between blocks: the served block
    (``run_block_gather``) is the twin's ``run_block`` taps packed with
    ``pack_columns``, to the bit, and ``prewarm_gather`` moves nothing."""
    served, twin = (ShardedStreamEngine(_params(), _source(), mesh=_mesh(2, 2))
                    for _ in range(2))
    idx = np.array([1, 0, 5, 0], np.int32)
    changes = (
        lambda e: e.set_channel(1, freq_hz=14.2e6, mode=demod.MODE_USB),
        lambda e: e.retune_all(e.params.adc_clock * (1 + 0.4e-6)),
        lambda e: None)
    for i, change in enumerate(changes):
        before = _frozen(served)
        served.prewarm_gather(4)
        assert all(torch.equal(a, b)
                   for a, b in zip(before, _frozen(served))), i
        got = served.run_block_gather(idx)
        want = tstream.pack_columns(twin.run_block(), twin._last_x, idx)
        assert got.shape == (served.packed_len(4),)
        assert torch.equal(got, want), f"block {i}"
        for e in (served, twin):
            change(e)
    assert served.seq == twin.seq == 3
