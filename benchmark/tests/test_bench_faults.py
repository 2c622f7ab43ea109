"""A run with the timed path broken underneath reads ``correct`` false:
a step that returns its state unchanged, half of the listened channels
left out, one answer altered where it is produced.  (A one-card cell has
no exchange between chips to leave out.)  The runs skip the look for a
card and drive the rest of a run on the CPU."""

from __future__ import annotations

import time

import pytest

from benchmark import harness
from benchmark.reference import judge
from benchmark.tests.tiny import tiny_cell


def stale_state(eng, server):
    orig = eng.run_block_gather

    def step(idx):
        before = eng.state
        out = orig(idx)
        if eng.seq > 4:
            eng.state = before
        return out
    eng.run_block_gather = step


def half_left_out(eng, server):
    orig = eng.run_block_gather
    block = eng.params.audio_block

    def step(idx):
        out = orig(idx).clone()
        bucket = len(idx)
        for k in range(4):                      # audio, audio2, iq re, im
            base = k * bucket * block
            out[base + (bucket // 2) * block:base + bucket * block] = 0.0
        return out
    eng.run_block_gather = step


def answer_altered(eng, server):
    orig = eng.run_block_gather
    block = eng.params.audio_block

    def step(idx):
        out = orig(idx).clone()
        out[1 * block + 5] += 0.5            # lane 1 (AM, s16), one sample
        return out
    eng.run_block_gather = step


@pytest.mark.parametrize("fault", [stale_state, half_left_out,
                                   answer_altered])
def test_fault_reads_not_correct(fault):
    cell = tiny_cell(listeners=6, zooms=(0,))
    out = harness.run(cell, 4242, 2.5, False, time.monotonic(),
                      device="cpu", install=fault)
    ok, rows = judge.verdict(out["numbers"], judge.limits(cell.name))
    assert not ok, rows
