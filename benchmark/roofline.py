"""Work counts of the configuration's numerology, and the card's peaks.

Peaks: NVIDIA's data sheet for the H100 SXM (80 GB HBM3), dense rates at
its 700 W power limit: 67 TFLOP/s of float32 outside the tensor cores,
3.35 TB/s of HBM bandwidth.  A card set below 700 W runs slower under
load; the run reports ``nvidia-smi``'s power limit beside its numbers.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def stage1_flops(plan) -> float:
    """The stage-1 filter-bank product of one block: (k1, L1) frames
    times the (L1, 2C) bank, two operations a multiply-add."""
    return 2.0 * plan.k1 * plan.l1 * 2 * plan.channels


def stage2_bytes(plan) -> float:
    """Kernel 1 (rotator and stage 2) of one block, each byte once: the
    complex64 stage-1 rows with their carry in, the float32 taps, the
    complex64 audio out, and two int64 phase words a channel."""
    c = plan.channels
    return ((plan.k1 + plan.tail2) * c * 8 + plan.l2 * 4
            + plan.audio_block * c * 8 + 2 * c * 8)


def share(least_s: float, took_s: float) -> float:
    """Percent of the roofline: the least time over the time taken."""
    return 100.0 * least_s / took_s
