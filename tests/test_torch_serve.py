"""Port parity: the serving half of the engine (``run_block_gather``, the
packed host fetch, ``prewarm_gather``, checkpointing, ``gps_timestamp``)
and the capture, threaded and FSK sources, against the JAX reference on
the CPU.

Tolerances:
- the packed array against the reference engine's: the tap rows within
  2e-4*max|audio| + 5e-5 (the ``rx_block`` bound of `test_torch_rx.py`,
  from the block on where the passband FIR has filled), the S-meter
  section within 1e-3 dB on the listened lanes, the peak exact;
- the packed columns against the port's own ``run_block`` taps: exact;
- the checkpoint round trip: exact;
- ``FileSource``/``Int24FileSource``: exact; the FSK scene within 1e-6 of
  its float64 truth and 2e-6 of the reference source (float32 cos of the
  same exact phase).
"""

import inspect
import threading

import numpy as np
import pytest
import torch

from flydog_sdr_gps_tpu.models import rx_channel as jrx
from flydog_sdr_gps_tpu.numerology import ADC_CLOCK_NOM, RX_DECIM_12K
from flydog_sdr_gps_tpu.ops import demod
from flydog_sdr_gps_tpu.ops import nco as jnco
from flydog_sdr_gps_tpu.runtime import source as jsource
from flydog_sdr_gps_tpu.runtime import stream as jstream
from flydog_sdr_gps_tpu_torch.models import rx_channel as trx
from flydog_sdr_gps_tpu_torch.runtime import source as tsource
from flydog_sdr_gps_tpu_torch.runtime import stream as tstream

TONES = ((14.201e6, 0.5), (21.0015e6, 0.5), (7.1007e6, 0.3))
C, BLOCK = 64, 128
LISTENED = {0: (14.200e6, demod.MODE_USB), 1: (21.003e6, demod.MODE_LSB),
            5: (7.100e6, demod.MODE_CW), 9: (14.1995e6, demod.MODE_USB)}
BUCKETS = {1: [0], 4: [0, 1, 5, 9], 8: [9, 5, 1, 0, 0, 0, 0, 0]}
FILLED = 8


def _port_engine(seed=0, channels=C, noise=0.001):
    eng = tstream.StreamEngine(
        trx.RxParams(num_channels=channels, audio_block=BLOCK,
                     stage2="unfused"),
        tsource.SyntheticSource(TONES, noise, seed=seed), device="cpu")
    for ch, (f, m) in LISTENED.items():
        if ch < channels:
            eng.set_channel(ch, freq_hz=f, mode=m, in_use=True)
    return eng


def _unpack(packed, bucket, channels=C, block=BLOCK):
    """The layout rule of the reference server's unpack."""
    assert packed.ndim == 1 and packed.dtype == np.float32
    assert (len(packed) - channels - 1) // (4 * block) == bucket
    nb = bucket * block
    rows = [packed[k * nb:(k + 1) * nb].reshape(bucket, block)
            for k in range(4)]
    return rows, packed[4 * nb:4 * nb + channels], packed[-1]


@pytest.fixture(scope="module")
def gathered():
    """Both engines through the FIR fill, then one gathered block a
    bucket: {bucket: (reference packed, port packed)}."""
    ref = jstream.StreamEngine(
        jrx.RxParams(num_channels=C, audio_block=BLOCK, stage2="poly"),
        jsource.SyntheticSource(TONES, 0.001))
    port = _port_engine()
    for ch, (f, m) in LISTENED.items():
        ref.set_channel(ch, freq_hz=f, mode=m, in_use=True)
    for _ in range(FILLED):
        ref.run_block()
        port.run_block()
    out = {}
    for bucket, idx in BUCKETS.items():
        idx = np.asarray(idx, np.int32)
        r = np.asarray(ref.run_block_gather(idx))
        g = port.fetch(port.run_block_gather(idx))
        out[bucket] = (r, g)
    assert port.seq == ref.seq == FILLED + len(BUCKETS)
    assert port.block_ticks == ref.block_ticks
    return out


@pytest.mark.parametrize("bucket", sorted(BUCKETS))
def test_gather_packed_layout_matches_reference(gathered, bucket):
    ref, got = gathered[bucket]
    assert got.shape == ref.shape == (4 * bucket * BLOCK + C + 1,)
    assert got.dtype == np.float32
    (r_rows, r_sm, r_peak), (g_rows, g_sm, g_peak) = \
        _unpack(ref, bucket), _unpack(got, bucket)
    tol = 2e-4 * max(np.abs(r_rows[0]).max(), 1e-6) + 5e-5
    for name, g, r in zip(("audio", "audio2", "iq_re", "iq_im"),
                          g_rows, r_rows):
        assert np.abs(r).max() > 0.05, name
        np.testing.assert_allclose(g, r, rtol=0, atol=tol, err_msg=name)
    lanes = sorted(LISTENED)
    np.testing.assert_allclose(g_sm[lanes], r_sm[lanes], rtol=0, atol=1e-3)
    assert g_peak == r_peak > 0.5


@pytest.mark.parametrize("bucket", sorted(BUCKETS))
def test_gather_equals_own_run_block_columns(bucket):
    """Two port engines from the same seed: the packed rows are exactly
    the subscribed columns of ``run_block``'s taps."""
    a, b = _port_engine(seed=3, channels=16), _port_engine(seed=3,
                                                           channels=16)
    idx = np.asarray(BUCKETS[bucket], np.int32)
    for _ in range(3):
        taps = a.run_block()
        packed = b.run_block_gather(idx)
        assert isinstance(packed, torch.Tensor) and packed.dim() == 1
        assert packed.numel() == b.packed_len(bucket)
        rows, smeter, peak = _unpack(b.fetch(packed), bucket, channels=16)
        want = (taps.audio, taps.audio2, taps.iq_post_agc.real,
                taps.iq_post_agc.imag)
        for g, w in zip(rows, want):
            np.testing.assert_array_equal(g, w.numpy()[:, idx].T)
        np.testing.assert_array_equal(smeter, taps.smeter_dbm.numpy())
        assert peak == float(a._last_x.abs().max())
        assert torch.equal(a._last_x, b._last_x)
    assert a.seq == b.seq == 3 and a.block_ticks == b.block_ticks


def test_gather_runs_no_health_check_and_no_fanout():
    eng = _port_engine(channels=4)
    calls = []
    eng.subscribers.append(lambda e, taps: calls.append(e.seq))
    eng.run_block()
    eng.run_block_gather(np.array([0], np.int32))
    assert calls == [1] and eng.seq == 2


def test_fetch_buffers_take_turns_and_prewarm_leaves_state_alone():
    eng = _port_engine(channels=4)
    idx = np.array([0, 1], np.int32)
    state, tuning, seq = eng.state, eng.tuning, eng.seq
    worker = threading.Thread(target=eng.prewarm_gather, args=(8,))
    worker.start()
    first = eng.run_block_gather(idx)
    worker.join()
    assert eng.seq == seq + 1 and eng.tuning is tuning
    assert state is not eng.state                  # only the block moved it
    # the host buffers were made with the engine, at the largest bucket
    assert [b.numel() for b in eng._fetch_bufs] == [eng.packed_len(4)] * 2
    with pytest.raises(ValueError, match="largest bucket"):
        eng.start_fetch(torch.zeros(eng.packed_len(8)))
    # two fetches in flight keep their own host buffers
    second = eng.run_block_gather(idx)
    h1, h2 = eng.start_fetch(first), eng.start_fetch(second)
    got1, got2 = h1.result(), h2.result()
    np.testing.assert_array_equal(got1, first.numpy())
    np.testing.assert_array_equal(got2, second.numpy())
    assert not np.array_equal(got1, got2)
    got1[:] = 0.0                                  # a copy: the ring is safe
    np.testing.assert_array_equal(eng.fetch(second), second.numpy())


def test_checkpoint_round_trip_is_exact(tmp_path):
    def make():
        eng = _port_engine(channels=4, noise=0.0)
        eng.set_channel(2, freq_hz=7.1007e6, mode=demod.MODE_SAM,
                        nr_notch_on=True, nr_den_on=True, in_use=True)
        eng.set_channel(3, freq_hz=21.0e6, mode=demod.MODE_AM, nr_on=True,
                        passband=(-3000.0, 3000.0), agc_on=False,
                        manual_gain_db=40.0, squelch=0.25, nb_on=True)
        return eng

    eng = make()
    for _ in range(3):
        eng.run_block()
    path = str(tmp_path / "state.pkl")
    eng.save_state(path)
    want = [eng.run_block() for _ in range(2)]

    eng2 = make()
    eng2.set_channel(0, freq_hz=3.3e6)             # the snapshot wins
    eng2.load_state(path)
    assert eng2.seq == 3
    assert eng2.block_ticks == 2 * eng.params.ddc.adc_block
    assert eng2.gps_timestamp() == (eng2.block_ticks,
                                    eng2.block_ticks / ADC_CLOCK_NOM)
    assert eng2.ctl[0].freq_hz == 14.200e6 and eng2.ctl[3].squelch == 0.25
    assert eng2.tuning.any_lms and eng2.tuning.any_spectral_nr
    for name in ("bank", "dphi1", "pb_coef", "mode", "squelch_thresh",
                 "nb_on", "nr_on", "nr_notch_on", "nr_den_on"):
        assert torch.equal(getattr(eng2.tuning, name),
                           getattr(eng.tuning, name)), name
    assert torch.equal(torch.isnan(eng2.tuning.manual_gain_db),
                       torch.isnan(eng.tuning.manual_gain_db))
    # drive the fresh source to the same tick position
    eng2.source.ticks = eng.source.ticks - 2 * eng.params.ddc.adc_block
    for blk, w in enumerate(want):
        got = eng2.run_block()
        for name in ("audio", "audio2", "iq_post_agc", "smeter_dbm"):
            assert torch.equal(getattr(got, name), getattr(w, name)), \
                f"block {blk}: {name}"


def test_checkpoint_keeps_the_reference_mirror_fields(tmp_path):
    """As in the reference, nb_wild, deemph_on and mute_over_dbm come
    back at their defaults, and the snapshot holds numpy leaves."""
    import pickle
    eng = _port_engine(channels=2)
    eng.set_channel(1, nb_on=True, nb_wild=True, deemph_on=True,
                    mute_over_dbm=-10.0)
    eng.run_block()
    path = str(tmp_path / "s.pkl")
    eng.save_state(path)
    with open(path, "rb") as f:
        snap = pickle.load(f)
    assert set(snap) == {"leaves", "seq", "block_ticks", "ctl"}
    assert all(isinstance(a, np.ndarray) for a in snap["leaves"])
    assert len(snap["leaves"]) == len(tstream._state_leaves(eng.state)) > 25
    assert snap["seq"] == 1 and snap["ctl"][1].nb_wild
    eng2 = _port_engine(channels=2)
    eng2.load_state(path)
    c = eng2.ctl[1]
    assert c.nb_on and not c.nb_wild and not c.deemph_on
    assert c.mute_over_dbm == 20.0
    assert not bool(eng2.tuning.nb_wild.any())
    assert not eng2.tuning.any_nb_wild


# ---------------------------------------------------------------------------
# sources
# ---------------------------------------------------------------------------

def test_file_source_matches_reference(tmp_path):
    rng = np.random.default_rng(0)
    i16 = rng.integers(-32768, 32767, 1000).astype(np.int16)
    f32 = rng.standard_normal(777).astype(np.float32)
    (tmp_path / "a.i16").write_bytes(i16.tobytes())
    (tmp_path / "b.f32").write_bytes(f32.tobytes())
    for name, dtype in (("a.i16", "int16"), ("b.f32", "float32")):
        for loop in (True, False):
            a = jsource.FileSource(str(tmp_path / name), dtype, loop=loop)
            b = tsource.FileSource(str(tmp_path / name), dtype, loop=loop)
            for n in (300, 900, 450):
                got = b.next_block(n)
                np.testing.assert_array_equal(got, a.next_block(n))
                assert got.dtype == np.float32
            assert a.ticks == b.ticks == 1650
    (tmp_path / "empty").write_bytes(b"")
    with pytest.raises(ValueError, match="empty capture"):
        tsource.FileSource(str(tmp_path / "empty"))


def test_int24_file_source_matches_reference(tmp_path):
    vals = np.array([1 << 22, -(1 << 22), 12345, -1, (1 << 23) - 1,
                     -(1 << 23)], np.int64)
    raw = b"".join(int(v & 0xFFFFFF).to_bytes(3, "little") for v in vals)
    path = tmp_path / "cap.s24"
    path.write_bytes(raw + b"\x01")                # a ragged last byte
    for swap in (False, True):
        a = jsource.Int24FileSource(str(path), iq_swap=swap)
        b = tsource.Int24FileSource(str(path), iq_swap=swap)
        got = b.next_block(9)
        np.testing.assert_array_equal(got, a.next_block(9))
        want = vals.astype(np.float32) * 2.0 ** -23
        if swap:
            want = want.reshape(-1, 2)[:, ::-1].reshape(-1)
        np.testing.assert_array_equal(got[:6], want)
        np.testing.assert_array_equal(got[6:], want[:3])        # looped


def test_block_ring_drops_the_new_block_and_counts():
    r = tsource.BlockRing(8, nblocks=4)
    dropped = [r.push(np.full(8, i, np.float32)) for i in range(6)]
    assert dropped == [False] * 4 + [True] * 2
    assert r.overruns == 2 and r.fill == 4
    assert [r.pop()[0] for _ in range(4)] == [0.0, 1.0, 2.0, 3.0]
    assert r.pop() is None
    with pytest.raises(ValueError):
        r.push(np.zeros(7, np.float32))


def test_threaded_source_keeps_order():
    class Counter(tsource.SampleSource):
        def _produce(self, n):
            return np.full(n, self.ticks // n, np.float32)

    src = tsource.ThreadedSource(Counter(), block=64, nblocks=8)
    try:
        got = [src.next_block(64) for _ in range(20)]
        assert [int(b[0]) for b in got] == list(range(20))
        assert all(b.shape == (64,) and b.dtype == np.float32 for b in got)
        assert src.overruns == 0 and src.ticks == 20 * 64
        with pytest.raises(ValueError):
            src.next_block(32)
    finally:
        src.close()
    assert not src._thread.is_alive()


FSK = ("fsk", 20, 1.4648, [0, 3, 1], 5)         # 2.5 blocks a symbol
FSK_BLOCK = 8 * RX_DECIM_12K


def _fsk_truth(f0, amp, nblocks, fsk=FSK, block=FSK_BLOCK):
    """The FSK tone in float64 from per-sample exact phase words."""
    _, baud, df, syms, cycle = fsk
    sym_ticks = baud * RX_DECIM_12K
    m = max(syms) + 1
    fcws = np.array([jnco.freq_to_fcw(f0 + (s - (m - 1) / 2.0) * df,
                                      ADC_CLOCK_NOM) for s in range(m)],
                    np.uint64)
    tick = np.arange(nblocks * block)
    slot = (tick // sym_ticks) % cycle
    on = slot < len(syms)
    sym = np.where(on, np.asarray(syms + [0] * cycle)[slot], 0)
    step = fcws[sym]
    words = np.concatenate([[np.uint64(0)], np.cumsum(step[:-1])])
    cyc = (words & np.uint64((1 << 48) - 1)).astype(np.float64) / 2.0 ** 48
    return np.where(on, amp, 0.0) * np.cos(2 * np.pi * cyc)


def test_fsk_scene_matches_truth_and_reference():
    tones = [(10.1387e6, 0.25, FSK), (7.1e6, 0.3, ("am", 1000.0, 0.6))]
    ref = jsource.DeviceSceneSource(tones=tones, block=FSK_BLOCK)
    got = tsource.DeviceSceneSource(tones=tones, block=FSK_BLOCK,
                                    device="cpu")
    nblocks = 14                                    # past one whole cycle
    k = np.arange(nblocks * FSK_BLOCK, dtype=np.uint64)

    def cycles(f):
        w = np.uint64(jnco.freq_to_fcw(f, ADC_CLOCK_NOM))
        return ((k * w) & np.uint64((1 << 48) - 1)).astype(np.float64) \
            / 2.0 ** 48
    truth = _fsk_truth(10.1387e6, 0.25, nblocks) + 0.3 * np.cos(
        2 * np.pi * cycles(7.1e6)) * (1 + 0.6 * np.sin(
            2 * np.pi * cycles(1000.0)))
    seen_idle = seen_break = False
    for blk in range(nblocks):
        assert got.fsk_cycle_pos_s() == ref.fsk_cycle_pos_s()
        r = np.asarray(ref.next_block())
        g = got.next_block().numpy()
        t = truth[blk * FSK_BLOCK:(blk + 1) * FSK_BLOCK]
        np.testing.assert_allclose(g, t, rtol=0, atol=1e-6,
                                   err_msg=f"port, block {blk}")
        np.testing.assert_allclose(g, r, rtol=0, atol=2e-6,
                                   err_msg=f"block {blk}")
        assert got._fsk[0]["phi"] == ref._fsk[0]["phi"]
        start = blk * FSK_BLOCK
        sym_ticks = FSK[1] * RX_DECIM_12K
        seen_break |= start // sym_ticks != (start + FSK_BLOCK - 1) // sym_ticks
        seen_idle |= (start // sym_ticks) % FSK[4] >= len(FSK[3])
    assert seen_idle and seen_break
    assert got.ticks == ref.ticks == nblocks * FSK_BLOCK
    pos, cyc = got.fsk_cycle_pos_s()
    assert cyc == 5 * 20 * RX_DECIM_12K / ADC_CLOCK_NOM and 0 <= pos < cyc


def test_fsk_scene_with_many_symbols_a_block_matches_truth():
    """Symbols shorter than a block (a NAVTEX emitter: 120 output samples
    a symbol, 17 boundaries in a 2048-sample block): every boundary lands
    at its exact sample, the phase carried across each.  Here 3 samples a
    symbol in blocks of 8, 2-3 boundaries a block, with idle slots."""
    fsk = ("fsk", 3, 170.0, [1, 0, 1, 1, 0, 0, 1, 0, 1, 1], 13)
    src = tsource.DeviceSceneSource(tones=[(518.0e3 + 1000.0, 0.05, fsk)],
                                    block=FSK_BLOCK, device="cpu")
    nblocks = 12                                    # past two cycles
    truth = _fsk_truth(518.0e3 + 1000.0, 0.05, nblocks, fsk, FSK_BLOCK)
    got = np.concatenate([src.next_block().numpy() for _ in range(nblocks)])
    np.testing.assert_allclose(got, truth, rtol=0, atol=1e-7)
    sym_ticks = 3 * RX_DECIM_12K
    assert FSK_BLOCK // sym_ticks >= 2 and (nblocks * FSK_BLOCK) // (
        sym_ticks * 13) >= 2


def test_serving_entry_points_exist_with_the_reference_names():
    for name in ("run_block_gather", "prewarm_gather", "save_state",
                 "load_state", "gps_timestamp", "reset_streaming_state"):
        port_sig = inspect.signature(getattr(tstream.StreamEngine, name))
        ref_sig = inspect.signature(getattr(jstream.StreamEngine, name))
        assert list(port_sig.parameters) == list(ref_sig.parameters), name
