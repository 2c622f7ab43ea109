"""The result line of a run."""

from __future__ import annotations

import math

from . import harness
from . import roofline
from .reference import judge


def per_layer(cell, out: dict) -> dict:
    """Each per-layer metric of the cell that its reader finds something
    to read for; a reader that finds nothing returns None and the metric
    is left out."""
    ctx = dict(cell=cell, cfg=cell.cfg, plan=out["plan"],
               paced=cell.mix.get("pacing") == "paced", spans=out["spans"],
               trace=out["trace"], window=out["window"], due=out["due"],
               roofline=roofline, kernel_names=harness.kernel_names)
    got = {}
    for m in cell.per_layer:
        v = harness.reader(m["name"])(ctx, m["name"])
        if v is not None:
            got[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return got


def result_line(cell, out: dict, trace: bool, power: str) -> dict:
    import torch
    ok, rows = judge.verdict(out["numbers"], judge.limits(cell.name),
                             out.get("required", ()))
    if trace:
        metrics = per_layer(cell, out)
    else:
        metrics = {}
        for m in cell.end_to_end:
            v = out.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": int(out["peak"]),
              "power": power}
    line = {"correct": ok, "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": metrics,
            "device": device}
    t = out["trace"]
    if trace and t is not None:
        busy = t.covered_s(t.union(t.kernels + t.copies))
        device.update(busy_s=busy, window_s=t.window_s)
        line["breakdown"] = {"device_ops": t.top_ops(10),
                             "idle_gaps": t.idle_gaps(out["spans"], 10)}
    line["timing"] = out.get("timing")
    line["checks"] = {k: {"value": finite(v), "limit": lim}
                      for k, v, lim in rows}
    return line


def finite(v: float | None) -> float | None:
    """A number JSON can carry: an infinite reading (a field of another
    shape, a block that never came) is written as 1e308; a part's number
    that was not read stays None."""
    return v if v is None or math.isfinite(v) else 1e308
