"""The judge follows clock corrections: a retune of every channel
(``StreamEngine.retune_all``) planted mid-run reads correct, and reads
not correct with one word of it off by one LSB or with the probes' record
of it withheld; with no retune the arithmetic is the parent's to the bit;
the ADC's own clock (``adc_ppm``); the reference's model of the fused
carry after a retune.  On the CPU at ``tiny.py``'s size."""

from __future__ import annotations

import copy
import os
import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark import probes as prb
from benchmark.generator import AdcRing
from benchmark.reference import design as dz
from benchmark.reference import judge
from benchmark.reference import receiver as rxr
from benchmark.tests.tiny import tiny_cell

PPM = 4e-7
SEED = 31               # its three sampled blocks lie at 15, 64, 82 %
PARTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "parts")

LANES = [dict(chan=0, freq_hz=7.1e6, mode="am", passband=(-4000.0, 4000.0)),
         dict(chan=1, freq_hz=14.2018e6, mode="usb",
              passband=(300.0, 2700.0))]


def tiny_plan():
    return dz.plan(tiny_cell().cfg)


def blocks(p, n, seed=5):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(p.adc_block, generator=gen) for _ in range(n)]


# ---------------------------------------------------------------------------
# no retune: the parent's arithmetic, to the bit
# ---------------------------------------------------------------------------

def parent_stream_carries(lanes, block_of, n, device):
    """``stream_carries`` as it was before clock corrections were
    followed: every block from zero under the one set of words."""
    p = lanes.p
    fir_blocks = -(-(p.ntaps - 1) // p.hop)
    m0 = max(0, n - fir_blocks - 1)
    st = rxr.init_state(p, len(lanes.dphi))
    if m0 > 0:
        st["ddc.x_tail"] = np.asarray(block_of(m0 - 1)[-p.tail1:],
                                      np.float64)
    st["ddc.phi1"] = np.array([(m0 * p.k1 * int(d)) & dz.MASK48
                               for d in lanes.dphi], np.int64)
    fir = st["fir_tail"]
    for m in range(m0, n):
        iq, new = rxr.ddc(lanes, st, torch.as_tensor(block_of(m)), "ref")
        st.update(new)
        fir = np.concatenate([fir, iq])[p.hop:]
    return {"ddc.x_tail": st["ddc.x_tail"], "ddc.y_tail": st["ddc.y_tail"],
            "ddc.phi1": st["ddc.phi1"], "fir_tail": fir}


def test_no_retune_is_the_parents_arithmetic():
    p = tiny_plan()
    lanes = rxr.Lanes(p, LANES)
    words = [dz.fcw(ln["freq_hz"], p.adc_clock) for ln in LANES]
    assert np.array_equal(lanes.dphi, [(w * p.d1) & dz.MASK48
                                       for w in words])
    assert np.array_equal(lanes.bank, np.stack(
        [dz.bank_column(p, w) for w in words], -1))
    assert lanes.at(p.adc_clock) is lanes
    xs = blocks(p, 9)
    for n in (1, 2, 8):
        got = rxr.stream_carries(lanes, lambda m: xs[m].numpy(), n, "cpu")
        want = parent_stream_carries(lanes, lambda m: xs[m].numpy(), n,
                                     "cpu")
        for k in want:
            assert np.array_equal(got[k], want[k]), (n, k)
    # an empty record places every block under the nominal clock
    phases = {8: (want["ddc.phi1"], None)}
    clocks, off = judge.placements(lanes, [], phases)
    assert off == 0 and clocks[8].switches == []
    assert clocks[8].of(8) == p.adc_clock


def test_phase_sums_each_blocks_own_increment():
    p = tiny_plan()
    lanes = rxr.Lanes(p, LANES)
    new = p.adc_clock * (1 + PPM)
    cl = rxr.Clocks(p.adc_clock, [(3, new)])
    assert cl.runs(5) == [(3, p.adc_clock), (2, new)]
    assert cl.of(2) == p.adc_clock and cl.of(3) == new
    want = [(3 * p.k1 * int(a) + 2 * p.k1 * int(b)) & dz.MASK48
            for a, b in zip(lanes.dphi, lanes.at(new).dphi)]
    assert rxr.phase_entering(lanes, cl, 5).tolist() == want
    assert not np.array_equal(lanes.at(new).dphi, lanes.dphi)


# ---------------------------------------------------------------------------
# the judge places a retune by the words the blocks advanced by
# ---------------------------------------------------------------------------

def test_placements_take_the_retune_where_the_words_changed():
    """A retune entered at block 4 and returned at 5 first took effect
    at block 5: its placements [4, 6] are held to the words after it,
    and only 5 reads none off.  A lane with neither clock's words, or a
    block whose lanes split between the two clocks, reads off under
    every placement."""
    p = tiny_plan()
    lanes = rxr.Lanes(p, LANES)
    new = p.adc_clock * (1 + PPM)
    truth = rxr.Clocks(p.adc_clock, [(5, new)])
    mark = rxr.phase_entering(lanes, truth, 6)
    clocks, off = judge.placements(lanes, [(new, 4, 5)], {6: (mark, None)})
    assert off == 0 and clocks[6].switches == [(5, new)]
    bad = mark.copy()
    bad[1] = (bad[1] + p.k1 * p.d1) & dz.MASK48
    _, off = judge.placements(lanes, [(new, 4, 5)], {6: (bad, None)})
    assert off == 1
    # block 5 read the new words on lane 0 and the old on lane 1: a
    # tuning half written when the step read it
    early = rxr.phase_entering(lanes, rxr.Clocks(p.adc_clock, [(6, new)]),
                               6)
    split = np.array([mark[0], early[1]], np.int64)
    _, off = judge.placements(lanes, [(new, 4, 5)], {6: (split, None)})
    assert off == 1


def test_bank_off_holds_each_column_to_its_clock():
    """The program's stage-1 column against the reference's: 4.1e-8 -
    5.1e-8 of its largest tap under the clock it was built for, 1.0e-5 -
    2.9e-4 under the other clock of a 0.4 ppm correction (0.5 - 14.2
    MHz), on either side of ``BANK_GAP``.  A lane counts off only when
    no copy (before the step, after it) is its clock's."""
    from flydog_sdr_gps_tpu_torch.models import rx_channel as rx
    from flydog_sdr_gps_tpu_torch.ops import channelizer as chz
    from flydog_sdr_gps_tpu_torch.ops import nco
    p = dz.plan(harness.load_json(os.path.join(
        os.path.dirname(PARTS), "..", "configs", "kiwi12k_c4096.json")))
    params = rx.RxParams(num_channels=4, snd_rate=12000,
                         audio_block=p.audio_block)
    lanes = rxr.Lanes(p, LANES + [dict(chan=2, freq_hz=0.5e6, mode="usb",
                                       passband=(300.0, 2700.0))])
    new = p.adc_clock * (1 + PPM)
    cols = {c: np.stack([chz.build_filterbank_column(
        params.ddc, nco.freq_to_fcw(f, c))[0] for f in lanes.freqs], -1)
        for c in (p.adc_clock, new)}
    for c, other in ((p.adc_clock, new), (new, p.adc_clock)):
        want = lanes.at(c).bank
        scale = np.abs(want).max(axis=0)
        same = np.abs(cols[c] - want).max(axis=0) / scale
        cross = np.abs(cols[other] - want).max(axis=0) / scale
        assert same.max() < 1e-7 and cross.min() > 1e-5, (same, cross)
        assert judge.bank_off(lanes.at(c), [cols[c]]) == 0
        assert judge.bank_off(lanes.at(c), [cols[other]]) == 3
        assert judge.bank_off(lanes.at(c), [cols[other], cols[c]]) == 0
    mixed = cols[p.adc_clock].copy()
    mixed[:, 1] = cols[new][:, 1]
    assert judge.bank_off(lanes, [mixed]) == 1
    assert judge.bank_off(lanes, [mixed, cols[new]]) == 1


def test_clock_error_ppm():
    true = 125e6 * (1 + PPM)
    assert judge.clock_error_ppm(true, 125e6, []) == pytest.approx(0.4)
    assert judge.clock_error_ppm(true, 125e6, [true]) == 0.0
    # a correction of the wrong sign, and the worst of several
    assert judge.clock_error_ppm(true, 125e6, [125e6 * (1 - PPM)]) == \
        pytest.approx(0.8)
    assert judge.clock_error_ppm(true, 125e6, [true, 125e6]) == \
        pytest.approx(0.4)


# ---------------------------------------------------------------------------
# a retune planted mid-run
# ---------------------------------------------------------------------------

def listened(server):
    return min(c.rx_chan for c in server.conns.values()
               if c.rx_chan is not None)


def one_lsb_off(eng, server, clock):
    """After the program's retune, one listened channel's word is one
    LSB above the new clock's."""
    from flydog_sdr_gps_tpu_torch.ops import channelizer as chz
    from flydog_sdr_gps_tpu_torch.ops import nco
    ch = listened(server)
    fcw = nco.freq_to_fcw(eng.ctl[ch].freq_hz, clock) + 1
    col, dphi = chz.build_filterbank_column(eng.params.ddc, fcw)
    t = eng.tuning
    t.bank[:, ch] = torch.as_tensor(col)
    t.dphi1[ch] = dphi


def stale_bank(eng, server, clock):
    """After the program's retune, one listened channel's stage-1 bank
    column is still the nominal clock's; its word is the new clock's."""
    from flydog_sdr_gps_tpu_torch.ops import channelizer as chz
    from flydog_sdr_gps_tpu_torch.ops import nco
    ch = listened(server)
    fcw = nco.freq_to_fcw(eng.ctl[ch].freq_hz, eng.params.adc_clock)
    col, _ = chz.build_filterbank_column(eng.params.ddc, fcw)
    eng.tuning.bank[:, ch] = torch.as_tensor(col)


def planted(fault=None):
    """An ``install`` in which ``fault(eng, server, clock)`` runs inside
    the program's retune, after it.  The retune itself is planted by the
    test part ``retune_once`` (``tests/parts/``)."""
    def install(eng, server):
        if fault is not None:
            orig = eng.retune_all

            def retune(clock):
                orig(clock)
                fault(eng, server, clock)
            eng.retune_all = retune
    return install


def planted_run(cell, seed, seconds, device, fault=None):
    """A run of ``cell`` with one ``retune_all(clock * (1 + 4e-7))``
    planted after the window's first sampled block."""
    cell.cfg.update(parts=["retune_once"], retune_ppm=PPM * 1e6,
                    adc_ppm=PPM * 1e6)
    old = harness.PARTS
    harness.PARTS = PARTS
    try:
        return harness.run(cell, seed, seconds, False, time.monotonic(),
                           device=device, install=planted(fault))
    finally:
        harness.PARTS = old


def withhold(self, orig, clock, *a, **k):
    return orig(clock, *a, **k)


FAULTS = {"sound": None, "one_lsb_off": one_lsb_off,
          "stale_bank": stale_bank, "withheld": None}


@pytest.mark.parametrize("case", list(FAULTS))
def test_planted_retune(case, monkeypatch):
    cell = tiny_cell(listeners=6, zooms=(0,))
    cell.mix["sample_blocks"] = 3
    if case == "withheld":
        monkeypatch.setattr(prb.Probes, "_retune", withhold)
    out = planted_run(cell, SEED, 3.0, "cpu", FAULTS[case])
    lim = judge.limits(cell.name)
    ok, rows = judge.verdict(out["numbers"], lim)
    nums = out["numbers"]
    retunes = out["timing"].get("retunes", [])
    assert "clock_error_ppm" in out["required"]
    if case == "withheld":
        assert retunes == []
        assert not ok, rows
        assert nums["phase"] + nums["carry"] > 0, rows
        # no correction seen: the nominal clock, 0.4 ppm off the ADC's
        assert nums["clock_error_ppm"] == pytest.approx(PPM * 1e6)
        return
    assert len(retunes) == 1, retunes
    r = retunes[0]
    assert r["clock"] == dz.plan(cell.cfg).adc_clock * (1 + PPM)
    # a block of the window was sampled before the retune and after it
    assert nums["sampled_before"] >= 1 and nums["sampled_after"] >= 1, nums
    assert nums["clock_error_ppm"] < 1e-6
    if case == "sound":
        assert ok, rows
        assert nums["phase"] == 0 and nums["carry"] == 0
    elif case == "one_lsb_off":
        assert not ok, rows
        assert nums["phase"] + nums["carry"] > 0, rows
    else:
        # the words are right and the stale column moves the channel's
        # filter by the correction's few Hz: every other number passes,
        # and only the bank check in ``carry`` sees it
        assert not ok, rows
        assert nums["phase"] == 0 and nums["carry"] >= 1, rows
        assert all(v <= limit for k, v, limit in rows if k != "carry"), rows


# ---------------------------------------------------------------------------
# the fused carry after a retune
# ---------------------------------------------------------------------------

class Blocks:
    """A sample source that hands out given blocks in turn."""

    def __init__(self, xs):
        self.xs = [x.numpy() for x in xs]
        self.n = 0

    def next_block(self, n):
        x = self.xs[self.n]
        self.n += 1
        return x


def test_the_fused_carry_is_rotated_by_the_new_word():
    """After a retune, the stage-1 rows carried from the block before
    are rotated by the new word (both packages' fused stage 2).  The
    reference models that: the plain arithmetic, which rotates each
    carried row by the word it was made under, differs from it in the
    first stage-2 span (the outputs that read carried rows) and nowhere
    else, and the program's CPU engine follows the reference there."""
    from flydog_sdr_gps_tpu_torch.models import rx_channel as rx
    from flydog_sdr_gps_tpu_torch.ops import demod
    from flydog_sdr_gps_tpu_torch.runtime import StreamEngine
    p = tiny_plan()
    new = p.adc_clock * (1 + 1e-5)
    lanes = rxr.Lanes(p, LANES[1:])
    xs = blocks(p, 2, seed=9)
    st = rxr.init_state(p, 1)
    _, carry = rxr.ddc(lanes, st, xs[0], "ref")
    st.update(carry)
    model, _ = rxr.ddc(lanes.at(new), st, xs[0 + 1], "ref")
    # the plain arithmetic: the carried rows under the old word's phases
    m = np.arange(p.tail2) - p.tail2
    old_w = (int(st["ddc.phi1"][0]) + m * int(lanes.dphi[0])) % 2 ** 48
    new_w = (int(st["ddc.phi1"][0]) + m * int(lanes.at(new).dphi[0])) \
        % 2 ** 48
    turn = np.exp(-2j * np.pi * ((old_w - new_w) % 2 ** 48) / 2.0 ** 48)
    plain_st = dict(st, **{"ddc.y_tail": st["ddc.y_tail"] * turn[:, None]})
    plain, _ = rxr.ddc(lanes.at(new), plain_st, xs[1], "ref")
    span = -(-p.tail2 // p.d2)
    scale = np.abs(model).max()
    assert np.abs(plain[:span] - model[:span]).max() > 1e-2 * scale
    assert np.abs(plain[span:] - model[span:]).max() <= 1e-12 * scale

    params = rx.RxParams(num_channels=4, snd_rate=12000,
                         audio_block=p.audio_block)
    eng = StreamEngine(params, Blocks(xs), device="cpu")
    eng.set_channel(0, freq_hz=LANES[1]["freq_hz"], mode=demod.MODE_USB)
    eng.run_block()
    eng.retune_all(new)
    got = eng.run_block().iq_pre_fir[:, 0].numpy()
    assert np.abs(got[:span] - model[:span, 0]).max() < 1e-3 * scale
    assert np.abs(got[:span] - plain[:span, 0]).max() > 1e-2 * scale


# ---------------------------------------------------------------------------
# the ADC's own clock
# ---------------------------------------------------------------------------

def parent_ring(cfg, adc_block, seed):
    """The ring's samples as the generator made them before ``adc_ppm``."""
    clock = float(cfg["adc_clock_hz"])
    n = int(cfg["ring_blocks"]) * adc_block
    gen = torch.Generator().manual_seed(int(seed) % (1 << 63))
    cycles_per_ring = n / clock
    t = torch.arange(n, dtype=torch.float64)
    x = torch.zeros(n, dtype=torch.float64)
    for tone in cfg["scene"]["tones"]:
        f = round(tone["hz"] * cycles_per_ring)
        ph0 = float(torch.rand((), generator=gen, dtype=torch.float64))
        carrier = torch.cos(2 * np.pi * torch.remainder(t * (f / n) + ph0,
                                                        1.0))
        am = tone.get("am")
        if am:
            fm = round(am["hz"] * cycles_per_ring)
            carrier = carrier * (1.0 + am["depth"] * torch.sin(
                2 * np.pi * torch.remainder(t * (fm / n), 1.0)))
        x += tone["amplitude"] * carrier
    x += cfg["scene"]["noise_rms"] * torch.randn(n, generator=gen,
                                                 dtype=torch.float64)
    return x.float().numpy()


def test_adc_ppm():
    cfg = dict(tiny_cell().cfg, ring_blocks=1)
    p = dz.plan(cfg)
    ring = AdcRing(cfg, p.adc_block, 2 ** 31 + 3, "cpu", False)
    assert np.array_equal(ring.block_of(0),
                          parent_ring(cfg, p.adc_block, 2 ** 31 + 3))
    assert ring.period == p.adc_block / p.adc_clock
    ppm = 100.0
    cfg_ppm = copy.deepcopy(dict(cfg, adc_ppm=ppm))
    moved = AdcRing(cfg_ppm, p.adc_block, 2 ** 31 + 3, "cpu", False)
    assert moved.period == p.adc_block / (p.adc_clock * (1 + ppm * 1e-6))
    n = p.adc_block
    hz = 14201800.0
    want = hz * n / p.adc_clock
    for r, shift in ((ring, 0.0), (moved, -hz * ppm * 1e-6 * n
                                   / p.adc_clock)):
        spec = np.abs(np.fft.rfft(r.block_of(0).astype(np.float64)))
        lo = int(want) - 40
        peak = lo + int(np.argmax(spec[lo:lo + 80]))
        assert abs(peak - (want + shift)) <= 1.0, (peak, want, shift)


@pytest.mark.cuda
def test_planted_retune_on_the_card(card):
    """The compiled step (CUDA graphs) across a retune: the tuning's copy
    is ordered against the replays on the card's stream, and the run
    reads correct."""
    cell = tiny_cell(channels=64, block=256)
    cell.mix["sample_blocks"] = 3
    out = planted_run(cell, SEED, 4.0, "cuda")
    ok, rows = judge.verdict(out["numbers"], judge.limits(cell.name))
    nums = out["numbers"]
    assert ok, rows
    assert nums["phase"] == 0 and nums["carry"] == 0, rows
    r = out["timing"]["retunes"]
    assert len(r) == 1 and nums["sampled_after"] >= 1, (nums, r)
