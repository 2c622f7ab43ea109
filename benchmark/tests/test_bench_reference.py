"""The plain reference against what the program's CPU path delivers to
the in-process sockets, at a size the CPU holds; and the control (the
reference in TF32, in the program's place) fails the check."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from benchmark import control, harness
from benchmark.reference import design as dz
from benchmark.reference import judge
from benchmark.reference import receiver as rxr
from benchmark.tests.tiny import tiny_cell


CELL = "kiwi12k_c4096.serve32_wf4"


@pytest.fixture(scope="module")
def served():
    """One run judged twice, as ``control.py`` judges a seed: the program
    and the control against the cell's limits."""
    return control.readings(tiny_cell(), 2 ** 31 + 77, 3.0, device="cpu")


def test_program_is_correct_at_a_tiny_size(served):
    assert served["program_correct"], served["program_checks"]
    assert served["program"]["missing"] == 0
    assert served["program"]["carry"] == 0
    assert served["failed"] == 0 and served["attempted"] > 0


def test_control_fails(served):
    """The reference in TF32 in the program's place reads not correct by
    the cell's own limits: at this size its state reads many times the
    program's, and its waterfall rows are off by more than the limit
    allows."""
    assert not served["control_correct"], served["control_checks"]
    assert served["control"]["state"] > 3 * served["program"]["state"]
    assert served["control"]["wf"] > judge.limits(CELL)["wf"]


def test_carries_are_the_streams_own():
    """The carries the reference works out from the stream alone are
    where its own step over the blocks before leaves them."""
    cell = tiny_cell()
    p = dz.plan(cell.cfg)
    lanes = rxr.Lanes(p, [dict(chan=0, freq_hz=7.1e6, mode="am",
                               passband=(-4000.0, 4000.0)),
                          dict(chan=1, freq_hz=14.2e6, mode="usb",
                               passband=(300.0, 2700.0))])
    gen = torch.Generator().manual_seed(5)
    xs = [torch.randn(p.adc_block, generator=gen) for _ in range(12)]
    st = rxr.init_state(p, 2)
    for x in xs[:11]:
        _, st = rxr.step(lanes, st, x)
    held = rxr.stream_carries(lanes, lambda m: xs[m].numpy(), 11, "cpu")
    gap, off = judge.carry_numbers(st, held)
    assert off == 0 and gap < 1e-12
    held["ddc.phi1"] = held["ddc.phi1"] + 1
    assert judge.carry_numbers(st, held)[1] == 2


def test_wide_mix_is_correct_on_the_20k_plan():
    cell = tiny_cell("wide32_wf3", "kiwi20k_c4096", listeners=6, zooms=(0,))
    out = harness.run(cell, 91, 3.0, False, time.monotonic(), device="cpu")
    ok, rows = judge.verdict(out["numbers"], judge.limits(cell.name))
    assert ok, rows


def test_reference_step_is_exact_on_its_own_state():
    """Two steps from one state agree with one another to the bit: the
    reference is deterministic, so the gaps it reports are the
    program's."""
    cell = tiny_cell()
    p = dz.plan(cell.cfg)
    lanes = rxr.Lanes(p, [dict(chan=0, freq_hz=7.1e6, mode="am",
                               passband=(-4000.0, 4000.0))])
    st = rxr.init_state(p, 1)
    x = torch.randn(p.adc_block, generator=torch.Generator().manual_seed(3))
    a, sa = rxr.step(lanes, st, x)
    b, sb = rxr.step(lanes, st, x)
    assert np.array_equal(a["audio"], b["audio"])
    assert judge.state_number(sa, sb) == (0.0, 0)


def test_tf32_rounds_to_ten_bits():
    t = torch.tensor([1.0 + 2 ** -12, 1.0 + 3 * 2 ** -11])
    assert rxr.tf32_round(t).tolist() == [1.0, 1.0 + 2 * 2 ** -10]
