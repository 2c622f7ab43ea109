"""A part (``parts/<name>.py``) is found by name; its keyword arguments
reach ``KiwiServer``, its snapshot sees the sampled blocks, and its
numbers stand in the checks beside their limits: one over its limit, one
never read and one without a limit each read not correct.  The run is on
the CPU at ``tiny.py``'s size; the part is ``tests/parts/wf_cap.py``."""

from __future__ import annotations

import json
import os
import time

import pytest

from benchmark import harness
from benchmark.reference import judge
from benchmark.tests.tiny import tiny_cell

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def run():
    cell = tiny_cell(listeners=4, zooms=(0,))
    cell.cfg.update(parts=["wf_cap"], wf_cap=3)
    old = harness.PARTS
    harness.PARTS = os.path.join(HERE, "parts")
    try:
        out = harness.run(cell, 2 ** 31 + 11, 2.5, False, time.monotonic(),
                          device="cpu")
    finally:
        harness.PARTS = old
    return cell, out


def test_a_part_is_found_by_name():
    harness.PARTS, old = os.path.join(HERE, "parts"), harness.PARTS
    try:
        mod = harness.part("wf_cap")
    finally:
        harness.PARTS = old
    assert mod.NUMBERS == ("wf_cap_seen", "wf_cap_samples")
    with pytest.raises(SystemExit):
        harness.part("wf_cap")          # not among the benchmark's parts


def test_a_parts_numbers_decide_correct(run, tmp_path):
    cell, out = run
    nums, required = out["numbers"], out["required"]
    assert required == ["wf_cap_seen", "wf_cap_samples"]
    assert nums["wf_cap_seen"] == 3.0           # the server took it
    assert nums["wf_cap_samples"] == cell.mix["sample_blocks"] + 1
    lim = dict(judge.limits(cell.name), wf_cap_seen=3, wf_cap_samples=10)
    ok, rows = judge.verdict(nums, lim, required)
    assert ok, rows
    assert ("wf_cap_seen", 3.0, 3) in rows
    assert ("wf_cap_samples", 3.0, 10) in rows
    # over its limit
    ok, rows = judge.verdict(nums, dict(lim, wf_cap_seen=2), required)
    assert not ok and ("wf_cap_seen", 3.0, 2) in rows
    # never read
    less = {k: v for k, v in nums.items() if k != "wf_cap_samples"}
    ok, rows = judge.verdict(less, lim, required)
    assert not ok and ("wf_cap_samples", None, 10) in rows
    # no limit
    (tmp_path / (cell.name + ".json")).write_text(json.dumps(
        {"limits": dict(judge.limits(cell.name), wf_cap_seen=3)}))
    old = judge.LIMITS
    judge.LIMITS = str(tmp_path)
    try:
        ok, rows = judge.verdict(nums, judge.limits(cell.name), required)
    finally:
        judge.LIMITS = old
    assert not ok and ("wf_cap_samples", 3.0, None) in rows
    # the numbers the cells have now keep their rule: one without a
    # reading is left out
    ok, rows = judge.verdict({}, {"audio": 0.9})
    assert ok and rows == []
