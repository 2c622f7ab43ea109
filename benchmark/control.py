"""Readings for the limits of ``correct``: the program's numbers and the
control's, on many seeds, in one process.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 \
        --seconds 8 [--out readings.jsonl]

Each seed is one run of the cell as ``run.py`` makes it (at the cell's
own size and load), whose sampled blocks are held to the reference
twice: once as served by the program (its readings, the lower ones),
and once with the control in the program's place, the reference
computed in TF32, the step below the configuration's float32 (the upper
ones).  Both are judged against the cell's limits
(``reference/limits/<cell>.json``) as a run judges the program: a line
a seed gives each side's ``correct`` with its numbers beside their
limits.  Exits 1 if the control of any seed reads correct or the
program of any seed does not.  The benchmark's own runs never compute
the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, seed: int, seconds: float, device: str = "cuda",
             detail: list | None = None) -> dict:
    """One run of ``cell`` with the control beside it: each side's
    numbers, and whether the cell's limits pass each."""
    from benchmark import harness
    from benchmark.reference import judge
    out = harness.run(cell, seed, seconds, False, time.monotonic(),
                      device=device, control=True, detail=detail)
    lim = judge.limits(cell.name)
    line = dict(workload=cell.name, seed=seed)
    for side, nums in (("program", out["numbers"]),
                       ("control", out["control"])):
        ok, rows = judge.verdict(nums, lim, out["required"])
        line[side] = nums
        line[side + "_correct"] = ok
        line[side + "_checks"] = {k: [v, limit] for k, v, limit in rows}
    line.update(attempted=out["attempted"], failed=out["failed"],
                judge_s=out["judge_s"], setup_s=out["setup_s"])
    return line


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out")
    ap.add_argument("--detail", action="store_true",
                    help="print what each lane and state field read")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import harness
    from benchmark.run import caches_in_checkout
    caches_in_checkout()
    import torch
    if not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.find_cell(ROOT, args.workload)
    bad = []
    for seed in args.seeds:
        detail: list | None = [] if args.detail else None
        line = readings(cell, seed, args.seconds, detail=detail)
        for d in detail or []:
            print("detail", json.dumps(d), file=sys.stderr)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        if line["control_correct"]:
            bad.append(f"seed {seed}: the control reads correct")
        if not line["program_correct"]:
            bad.append(f"seed {seed}: the program reads not correct")
    for b in bad:
        print(f"control.py: {cell.name}: {b}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
