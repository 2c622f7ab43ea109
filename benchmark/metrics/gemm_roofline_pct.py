"""DDC stage 1: the filter-bank product's share of its roofline, the
configuration's operations over the float32 peak, divided by the
device time a block of the kernels named under
``kernels/gemm_roofline_pct/`` on the engine's stream."""

from __future__ import annotations

from _device import engine_stream, matches


def read(ctx, name):
    got = engine_stream(ctx)
    if got is None:
        return None
    _sid, evs, blocks = got
    names = ctx["kernel_names"]("gemm_roofline_pct")
    us = sum(e["dur"] for e in evs if matches(e["name"], names))
    if not us:
        return None
    rf = ctx["roofline"]
    least = rf.stage1_flops(ctx["plan"]) / rf.PEAK_F32_FLOPS
    return rf.share(least, us * 1e-6 / blocks)
