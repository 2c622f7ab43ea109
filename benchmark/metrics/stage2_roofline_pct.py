"""Kernel 1 (``csrc/stage2.cu`` ``stage2_rot_c64``): its share of the
roofline, the configuration's bytes over the HBM peak, divided by the
device time a block of the kernels named under
``kernels/stage2_roofline_pct/``."""

from __future__ import annotations

from _device import engine_stream, matches


def read(ctx, name):
    got = engine_stream(ctx)
    if got is None:
        return None
    _sid, evs, blocks = got
    names = ctx["kernel_names"]("stage2_roofline_pct")
    us = sum(e["dur"] for e in evs if matches(e["name"], names))
    if not us:
        return None
    rf = ctx["roofline"]
    least = rf.stage2_bytes(ctx["plan"]) / rf.PEAK_BYTES_PER_S
    return rf.share(least, us * 1e-6 / blocks)
