"""A clock correction's retune, and a SET's, reach the step in one piece.

- The bank built on the device (``channelizer.build_filterbank_device``), on
  the CPU device, against the host's ``build_filterbank``: ``dphi1``
  equal, every bank entry within one float32 ulp; a column against the
  benchmark's plain reference's column of the same clock;
  ``nco.freqs_to_fcws`` against ``freq_to_fcw``.
- A stand-in step replaying on one thread while ``retune_all`` (or
  ``set_channel``) runs on another: every replay reads an old or a new
  ``(bank, dphi1)`` pair whole, on the single engine and from the shard
  buffers of the multi-device engine.
- The GPS part of the benchmark (``benchmark/parts/gps.py``): its numbers
  from a stub receiver, and its IF replay, which never wraps.
"""

import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import design as dz
from flydog_sdr_gps_tpu_torch.models import rx_channel as trx
from flydog_sdr_gps_tpu_torch.ops import channelizer as chz
from flydog_sdr_gps_tpu_torch.ops import nco
from flydog_sdr_gps_tpu_torch.runtime import stream as tstream

CLOCK = 125e6


def ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in float32 ulps of the larger magnitude."""
    big = np.maximum(np.abs(a), np.abs(b)).astype(np.float32)
    return np.abs(a.astype(np.float64) - b) / np.spacing(big)


def freqs(n: int, seed: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    edge = [0.0, 10e6, 7.1e6, 62.5e6, -1.0, 1000.3e3, 30e6 - 0.5]
    return np.concatenate([edge, rng.uniform(-62.5e6, 62.5e6, n - len(edge))])


def test_freqs_to_fcws_equals_freq_to_fcw():
    f = freqs(500)
    for clock in (CLOCK, CLOCK * (1 + 4e-7), CLOCK * (1 - 3.3e-5)):
        got = nco.freqs_to_fcws(f, clock)
        assert got.dtype == np.int64
        assert [int(w) for w in got] == [nco.freq_to_fcw(x, clock)
                                         for x in f]


@pytest.mark.parametrize("snd_rate", [12_000, 20_250])
def test_device_bank_equals_host_build(snd_rate):
    plan = chz.make_ddc_plan(snd_rate=snd_rate, audio_block=64)
    words = nco.freqs_to_fcws(freqs(48), CLOCK * (1 + 4e-7))
    bank, dphi = chz.build_filterbank(plan, [int(w) for w in words])
    got, got_dphi = chz.build_filterbank_device(plan, words, "cpu")
    assert got.dtype == torch.complex64 and got.shape == bank.shape
    np.testing.assert_array_equal(got_dphi.numpy(), dphi)
    g = got.numpy()
    for plane in (np.real, np.imag):
        assert ulps(plane(g), plane(bank)).max() <= 1.0
    # words past 2**48 (and negative ones) are taken mod 2**48
    off, off_dphi = chz.build_filterbank_device(
        plan, words[:4] + (3 << 48), "cpu")
    np.testing.assert_array_equal(off.numpy(), g[:, :4])
    np.testing.assert_array_equal(off_dphi.numpy(), dphi[:4])


def test_device_bank_column_equals_the_references():
    from benchmark.reference import judge
    cfg = dict(harness.load_json("benchmark/configs/kiwi12k_c4096.json"),
               channels=4, audio_block=64)
    cfg.pop("adc_block")
    p = dz.plan(cfg)
    plan = chz.make_ddc_plan(audio_block=64)
    assert plan.l1 == p.l1 and plan.d1 == p.d1
    clock = p.adc_clock * (1 + 4e-7)
    for f in (7.1e6, 14.2018e6, 1000.3e3):
        w = nco.freq_to_fcw(f, clock)
        assert w == dz.fcw(f, clock)
        col, dp = chz.build_filterbank_device(plan, [w], "cpu")
        want = dz.bank_column(p, w)
        gap = np.abs(col.numpy()[:, 0].astype(np.complex128) - want).max()
        assert gap <= 1e-7 * np.abs(want).max()
        assert gap < judge.BANK_GAP * np.abs(want).max()
        assert int(dp[0]) == (w * p.d1) & dz.MASK48


# ---------------------------------------------------------------------------
# one piece: a stand-in step replaying beside the control plane
# ---------------------------------------------------------------------------

class Zeros:
    """A sample source of zero blocks."""

    def next_block(self, n):
        return np.zeros(n, np.float32)


def stand_in_engine(c: int = 8):
    params = trx.RxParams(num_channels=c, audio_block=64)
    eng = tstream.StreamEngine(params, Zeros(), device="cpu",
                               use_graphs=True)
    for ch in range(c):
        eng.set_channel(ch, freq_hz=1e6 + 3.3e6 * ch)
    seen = []

    def replay(program, fn):
        # reads the bank, then (a torn read's window) the words
        t = eng.compiled.tuning
        bank = t.bank.clone()
        time.sleep(0.001)
        seen.append((bank, t.dphi1.clone()))
    eng.compiled.run = replay
    return eng, seen


def replay_beside(eng, change, n: int = 150):
    """``n`` served blocks on a thread while ``change(i)`` runs in turns
    on this one."""
    done = threading.Event()
    err = []

    def blocks():
        try:
            for _ in range(n):
                eng.run_block_gather(np.arange(4))
        except Exception as e:          # noqa: BLE001 — asserted below
            err.append(e)
        finally:
            done.set()
    th = threading.Thread(target=blocks)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)         # more interleavings
    try:
        th.start()
        i = 0
        while not done.is_set():
            change(i)
            i += 1
        th.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not th.is_alive() and not err, err
    return i


def whole(seen, pairs):
    """The index of the pair each replay read, -1 for a mixed read."""
    out = []
    for bank, dphi in seen:
        k = next((k for k, (b, d) in enumerate(pairs)
                  if torch.equal(d, dphi)), None)
        out.append(k if k is not None and torch.equal(pairs[k][0], bank)
                   else -1)
    return out


CLOCKS = (CLOCK * (1 + 4e-7), CLOCK * (1 - 2e-6))


def retune_pairs(eng):
    """The engine's ``(bank, dphi1)`` now, then the pair ``retune_all``
    builds for each of ``CLOCKS``.  The process's first bank build on
    the CPU can differ from later builds of the same words by an ulp in
    one part of the bank, so one build is made and dropped first: the
    engine's builds are later ones too."""
    t = eng.tuning
    words = [nco.freqs_to_fcws([c.freq_hz for c in eng.ctl], clk)
             for clk in CLOCKS]
    chz.build_filterbank_device(eng.params.ddc, words[0], "cpu")
    return [(t.bank.clone(), t.dphi1.clone())] + [
        chz.build_filterbank_device(eng.params.ddc, w, "cpu") for w in words]


def test_retune_all_is_read_whole_by_each_replay():
    eng, seen = stand_in_engine()
    pairs = retune_pairs(eng)
    retunes = replay_beside(eng, lambda i: eng.retune_all(CLOCKS[i % 2]))
    got = whole(seen, pairs)
    assert -1 not in got, got
    assert retunes >= 4 and {1, 2} <= set(got), (retunes, set(got))


def test_retune_all_is_read_whole_by_each_mesh_replay():
    """The multi-device engine's step reads its shard buffers under the
    dispatch lock: each block reads the bank columns and words of every
    shard from one retune."""
    from flydog_sdr_gps_tpu_torch import parallel as tpar
    from flydog_sdr_gps_tpu_torch.runtime import ShardedStreamEngine
    c = 8
    eng = ShardedStreamEngine(trx.RxParams(num_channels=c, audio_block=64),
                              Zeros(),
                              mesh=tpar.make_mesh(2, 2, devices=["cpu"] * 4))
    for ch in range(c):
        eng.set_channel(ch, freq_hz=1e6 + 3.3e6 * ch)
    prog, seen = eng.program, []

    def replay():
        # the shards' bank columns, then (a torn read's window) their
        # words, in channel order
        row = prog.tuning.shards[0]
        bank = torch.cat([sh.bank for sh in row], dim=1)
        time.sleep(0.001)
        seen.append((bank, torch.cat([sh.dphi1 for sh in row])))
    prog._body = replay
    pairs = retune_pairs(eng)
    retunes = replay_beside(eng, lambda i: eng.retune_all(CLOCKS[i % 2]),
                            n=60)
    got = whole(seen, pairs)
    assert -1 not in got, got
    assert retunes >= 4 and {1, 2} <= set(got), (retunes, set(got))


def test_set_channel_is_read_whole_by_each_replay():
    eng, seen = stand_in_engine()
    ch, fs = 3, (7.1e6, 14.2018e6)
    t = eng.tuning
    pairs = [(t.bank.clone(), t.dphi1.clone())]
    for f in fs:
        col, dp = chz.build_filterbank_column(
            eng.params.ddc, nco.freq_to_fcw(f, eng.params.adc_clock))
        bank, dphi = pairs[0][0].clone(), pairs[0][1].clone()
        bank[:, ch] = torch.as_tensor(col)
        dphi[ch] = dp
        pairs.append((bank, dphi))
    sets = replay_beside(eng, lambda i: eng.set_channel(ch,
                                                        freq_hz=fs[i % 2]))
    got = whole(seen, pairs)
    assert -1 not in got, got
    assert sets >= 4 and {1, 2} <= set(got), (sets, set(got))


def test_retune_spans():
    from flydog_sdr_gps_tpu_torch.utils.trace import get_trace
    eng, _seen = stand_in_engine(4)
    eng.run_block_gather(np.arange(4))
    n0 = len(get_trace().span_records())
    eng.retune_all(CLOCK * (1 + 4e-7))
    eng.set_channel(2, freq_hz=5e6)
    new = get_trace().span_records()[n0:]
    names = [(s.name, s.block, s.detail) for s in new]
    assert ("engine.retune_apply", 1, None) in names
    assert ("engine.retune", 1, None) in names
    assert ("engine.retune_apply", 1, "set_channel") in names
    (outer,) = [s for s in new if s.name == "engine.retune"]
    (inner,) = [s for s in new if s.name == "engine.retune_apply"
                and s.detail is None]
    assert outer.t0 <= inner.t0 <= inner.t1 <= outer.t1


# ---------------------------------------------------------------------------
# the benchmark's GPS part
# ---------------------------------------------------------------------------

def gps_part():
    return harness.part("gps")


def stub_ctx(fix_off=(3.0, 4.0, 0.0), retunes=(), errors=0):
    truth = np.array([4.3e6, 6.5e5, 4.67e6])
    sols = {} if fix_off is None else {
        "all": dict(pos=truth + fix_off), "gps": dict(pos=truth)}
    rec = types.SimpleNamespace(
        errors=errors, chunks=100, mgr=types.SimpleNamespace(
            last_solutions=sols, fixes=9,
            last_fix=None if fix_off is None else truth + 4e4))
    return dict(gps=dict(receiver=rec, truth=truth),
                probes=types.SimpleNamespace(retunes=list(retunes)),
                blocks=(40, 200), window=(1000.0, 1030.0))


def test_gps_part_numbers_from_a_stub_receiver():
    part = gps_part()
    assert part.NUMBERS == ("gps_errors", "fix_error_m",
                            "no_retune_in_window")
    inside = [(CLOCK, 30, 31, 995.0, 995.1), (CLOCK, 120, 120, 1015.0,
                                                1015.01)]
    got = part.numbers(stub_ctx(retunes=inside))
    assert got == {"gps_errors": 0.0, "fix_error_m": 5.0,
                   "no_retune_in_window": 0.0}
    # corrections only before the window, or one across its first block
    got = part.numbers(stub_ctx(retunes=inside[:1] + [
        (CLOCK, 39, 41, 1000.0, 1000.1)], errors=2))
    assert got["no_retune_in_window"] == 1.0 and got["gps_errors"] == 2.0
    # no fix: no reading, so the run reads not correct
    assert "fix_error_m" not in part.numbers(stub_ctx(fix_off=None))


class Ramp:
    """A sky whose samples count up."""
    fs = 1000.0
    adc_clock = 1000.0

    def __init__(self):
        self.ticks = 0

    def next_block(self, n):
        out = np.arange(self.ticks, self.ticks + n, dtype=np.float32)
        self.ticks += n
        return out


def test_gps_if_replay_serves_the_sky_in_order_and_never_wraps():
    part = gps_part()
    replay = part.IfReplay(Ramp(), 1.0, 300, "cpu")
    assert replay.buf.numel() == 1200           # whole chunks, >= 1 s
    got = [replay.next_block(300) for _ in range(4)]
    np.testing.assert_array_equal(torch.cat(got).numpy(),
                                  np.arange(1200, dtype=np.float32))
    assert replay.ticks == 1200
    with pytest.raises(EOFError):
        replay.next_block(300)
