"""On the card: the compiled path (CUDA graphs, the kernels) served to
the sockets at a tiny size is held to the reference and reads correct,
and the control does not."""

from __future__ import annotations

import time

import pytest

from benchmark import harness
from benchmark.reference import judge
from benchmark.tests.tiny import tiny_cell


@pytest.mark.cuda
def test_compiled_path_is_correct_and_control_fails(card):
    cell = tiny_cell(channels=64, block=256)
    out = harness.run(cell, 2 ** 31 + 9, 4.0, False, time.monotonic(),
                      device="cuda", control=True)
    ok, rows = judge.verdict(out["numbers"], judge.limits(cell.name))
    assert ok, rows
    ok, rows = judge.verdict(out["control"], judge.limits(cell.name))
    assert not ok, rows
