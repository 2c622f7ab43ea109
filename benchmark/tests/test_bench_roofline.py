"""Work counts come from the configuration files alone."""

from __future__ import annotations

import json
import os

import pytest

from benchmark import roofline
from benchmark.reference import design

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def plan_of(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return design.plan(json.load(f))


@pytest.mark.parametrize("name, tflop, block_ms", [
    ("kiwi12k_c4096", 2.097, 170.656), ("kiwi20k_c4096", 1.657, 101.122)])
def test_stage1_flops_a_block(name, tflop, block_ms):
    p = plan_of(name)
    assert roofline.stage1_flops(p) / 1e12 == pytest.approx(tflop, abs=5e-4)
    assert p.block_s * 1e3 == pytest.approx(block_ms, abs=5e-4)


def test_stage1_flops_formula():
    p = plan_of("kiwi12k_c4096")
    assert (p.k1, p.l1, p.channels) == (63488, 2016, 4096)
    assert roofline.stage1_flops(p) == 2 * 63488 * 2016 * 2 * 4096


def test_stage2_bytes_counted_once():
    p = plan_of("kiwi12k_c4096")
    want = (63488 + 744 - 31) * 4096 * 8 + 744 * 4 + 2048 * 4096 * 8 \
        + 2 * 4096 * 8
    assert roofline.stage2_bytes(p) == want
    assert roofline.stage2_bytes(p) / roofline.PEAK_BYTES_PER_S * 1e3 == \
        pytest.approx(0.648, abs=1e-3)


def test_share_cannot_pass_100_when_at_the_bound():
    assert roofline.share(1.0, 1.0) == 100.0
    assert roofline.share(1.0, 2.0) == 50.0


def test_the_design_rules_give_the_files_lengths():
    p = plan_of("kiwi20k_c4096")
    assert (p.l1, p.l2, p.adc_block) == (12344, 100, 12640256)
