"""One run of one cell: the served receiver as its listeners see it.

Set-up builds what ``run_server.py --file`` wires, at the cell's
configuration: the benchmark's ADC ring (:mod:`.generator`) feeds the
program's ``ThreadedSource``, a ``StreamEngine`` on the compiled step
advances it, and a ``KiwiServer`` (``realtime=False``) serves it from
``start_tasks()``: the block loop, the fan-out, the policy loop and the
waterfall.  The mix's listeners are in-process sockets, opened and tuned
with the protocol's own SET commands before the first block, and send
keepalives as a client does.  Set-up ends once the first blocks have
run, every program they use is captured (paced: before the ADC's clock
starts) and every slot of the source's ring has held a block; the
window follows for ``seconds``.  Then every sampled delivery is awaited, the
peak memory is read, the program is stopped and freed, and the sampled
blocks are held to the plain reference (:mod:`.reference`).

A configuration may name ``parts``: what its deployment runs beside the
receiver, each found by name as ``parts/<name>.py`` (see
``parts/__init__.py``).  A part adds keyword arguments to the server,
may look at each sampled block, and gives numbers that join the run's,
each held to the cell's limit of that name.  A configuration without
parts builds and runs the receiver alone.
"""

from __future__ import annotations

import asyncio
import dataclasses
import functools
import gc
import glob
import importlib.util
import json
import os
import sys
import time

import numpy as np

from . import listeners as lsn
from . import probes as prb
from .generator import AdcRing
from .reference import design as dz
from .reference import judge
from .reference import receiver as rxr
from .reference import waterfall as wfr

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "flydog_sdr_gps_tpu")
WARM_BLOCKS = 6          # blocks before the window, at least
RING_BLOCKS = 32         # the source's ring (run_server.py's, the default)
WAIT_AFTER_S = 60.0      # for deliveries due in the window
SAMPLE_BLOCKS = 3        # blocks of the window held to the reference
WF_ROWS = 1              # rows a W/F socket held to the reference
TRACE_BLOCKS = 16        # blocks the profiler covers in a traced run


@dataclasses.dataclass
class Cell:
    name: str
    cfg: dict
    mix: dict
    end_to_end: list
    per_layer: list
    chips: int


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_mix(name: str) -> dict:
    """The traffic mix ``traffic/<name>.json``.  A mix that names a
    ``base`` mix is that mix with the keys it gives in place of the
    base's (``about``, ``source`` and ``assumed`` are its own)."""
    mix = load_json(os.path.join(HERE, "traffic", name + ".json"))
    base = mix.pop("base", None)
    if base is None:
        return mix
    out = {k: v for k, v in load_mix(base).items()
           if k not in ("about", "source", "assumed")}
    out.update(mix)
    return out


def find_cell(root: str, name: str) -> Cell:
    """A cell of ``BENCHMARK.json`` with its configuration and mix files,
    each found by its name."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = load_json(os.path.join(root, conf["file"]))
    mix = load_mix(cell["traffic"])

    def mine(m):
        return m.get("workloads") is None or name in m["workloads"]
    return Cell(name, cfg, mix, [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)],
                int(cell["chips"]))


PARTS = os.path.join(HERE, "parts")


def module_at(path: str, name: str):
    """The module of the file ``path``, loaded under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The per-layer metric's reader, ``metrics/<name up to its first
    dot>.py`` (its function ``read``)."""
    base = metric.split(".")[0]
    folder = os.path.join(HERE, "metrics")
    if folder not in sys.path:
        sys.path.insert(0, folder)          # the readers' shared helpers
    return module_at(os.path.join(folder, base + ".py"),
                     f"bench_metric_{base}").read


def part(name: str):
    """The part ``<PARTS>/<name>.py``."""
    path = os.path.join(PARTS, name + ".py")
    if not os.path.isfile(path):
        raise SystemExit(f"no part {name!r}: {path} is not there")
    return module_at(path, f"bench_part_{name}")


def kernel_names(metric: str) -> list[str]:
    """The kernel-name patterns a roofline metric times: one per file
    under ``kernels/<metric name up to its first dot>/``."""
    base = metric.split(".")[0]
    out = []
    for path in sorted(glob.glob(os.path.join(HERE, "kernels", base,
                                              "*.txt"))):
        with open(path) as f:
            out += [ln.strip() for ln in f if ln.strip()
                    and not ln.startswith("#")]
    return out


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def run(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", install=None, control: bool = False,
        detail: list | None = None) -> dict:
    """One run; returns the result line's fields.  ``install(eng,
    server)`` is called once the program is built (tests plant faults
    there).  ``control`` also computes the control's numbers (see
    :func:`check`)."""
    import torch
    from flydog_sdr_gps_tpu_torch.models import rx_channel as rx
    from flydog_sdr_gps_tpu_torch.runtime import StreamEngine, ThreadedSource
    from flydog_sdr_gps_tpu_torch.server import KiwiServer

    cfg, mix = cell.cfg, cell.mix
    plan = dz.plan(cfg)
    paced = mix.get("pacing") == "paced"
    snd_specs, wf_specs = lsn.expand(mix)
    lanes = [lsn.tuning_of(s["cmds"]) for s in snd_specs]
    rng = np.random.default_rng(seed % (1 << 63))
    n_sample = int(mix.get("sample_blocks", SAMPLE_BLOCKS))
    fractions = sorted(rng.uniform(0.1, 0.9, n_sample).tolist())

    ring = AdcRing(cfg, plan.adc_block, seed, device, paced,
                   warm=WARM_BLOCKS + 1)
    params = rx.RxParams(num_channels=plan.channels, snd_rate=cfg["snd_rate"],
                         audio_block=plan.audio_block)
    if params.ddc.adc_block != plan.adc_block or \
            params.ddc.decims != (plan.d1, plan.d2):
        raise SystemExit("the program's plan is not the configuration's: "
                         f"{params.ddc.decims} x {params.ddc.adc_block}")
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    src = ThreadedSource(ring, block=plan.adc_block, nblocks=RING_BLOCKS)
    eng = StreamEngine(params, src, device=device)
    parts = [part(name) for name in cfg.get("parts", [])]
    ctx = dict(cell=cell, cfg=cfg, mix=mix, seed=seed, device=device,
               plan=plan, engine=eng)
    extra: dict = {}
    for mod in parts:
        for k, v in mod.build(ctx).items():
            if k in extra:
                raise SystemExit(f"two parts give the server's {k!r}")
            extra[k] = v
    server = KiwiServer(eng, realtime=False, port=0, **extra)
    ctx["server"] = server
    hooks = [functools.partial(mod.snapshot, ctx) for mod in parts
             if hasattr(mod, "snapshot")]
    if install is not None:
        install(eng, server)
    rec: dict = dict(snd={}, wf={}, chans=[], n_sample=n_sample)

    async def drive():
        for i, spec in enumerate(snd_specs):
            sock = lsn.Sock()
            conn = await server.open_stream(f"c{i}", "SND", sock,
                                            "127.0.0.1")
            if conn is None or conn.rx_chan is None:
                raise SystemExit(f"listener {i} was refused")
            for cmd in spec["cmds"]:
                await conn.handle_set(cmd, "SND")
            rec["snd"][i] = sock
            rec["chans"].append(conn.rx_chan)
        for i, spec in enumerate(wf_specs):
            sock = lsn.Sock()
            conn = await server.open_stream(f"c{i}", "W/F", sock,
                                            "127.0.0.1")
            for cmd in spec["cmds"]:
                await conn.handle_set(cmd, "W/F")
            rec["wf"][i] = (sock, conn.wf_slot.key)
        conns = [server.conns[f"c{i}"] for i in range(len(snd_specs))]

        async def keepalive():
            # what a KiwiSDR client sends every few seconds; without it
            # the server's policy loop drops a listener after 60 s
            while True:
                await asyncio.sleep(5.0)
                for conn in conns:
                    await conn.handle_set("SET keepalive", "SND")
        alive = asyncio.create_task(keepalive())
        probes = prb.Probes(eng, server, src, rec["chans"], spans=trace)
        probes.hooks = hooks
        rec["probes"] = probes
        ctx.update(probes=probes, loop=asyncio.get_running_loop())
        if eng.seq != 0:
            raise SystemExit("a block ran before the listeners were tuned")
        prof = None
        if trace:
            from .trace import Profiler
            prof = Profiler(torch)
            prof.prime()
        server.start_tasks()

        def graphs():
            n = len(server.wf.graphs)
            if eng.compiled is not None:
                n += len(eng.compiled.graphs)
            return n
        # the first blocks run free: the eager runs, the captures; paced,
        # the ADC's clock starts once they have all been dispatched
        seen = []
        while True:
            await asyncio.sleep(0.005)
            f = probes.fanned
            if not seen or seen[-1][0] != f:
                seen.append((f, graphs()))
            if f >= WARM_BLOCKS - 1 and len(seen) >= 3 and \
                    seen[-3][1] == seen[-1][1] and \
                    seen[-1][0] - seen[-3][0] >= 2:
                break
        if paced:
            while eng.seq < ring.warm:
                await asyncio.sleep(0.002)
            ring.start(time.monotonic())
        # until every slot of the source's ring has held a block once: a
        # slot's first use touches fresh pages (85 MB at 12 kHz), and
        # paced, the first pass is one block a period
        f0 = probes.fanned
        while eng.seq + src.ring.fill <= RING_BLOCKS or \
                probes.fanned < f0 + 3:
            await asyncio.sleep(0.002)
        t_w0 = time.monotonic()
        t_w1 = t_w0 + seconds
        probes.targets = [t_w0 + f * seconds for f in fractions]
        rec.update(t_w0=t_w0, t_w1=t_w1, setup_s=t_w0 - t_start,
                   drops0=sum(c.send_drops for c in server.conns.values()),
                   over0=src.overruns, seq0=eng.seq)
        if prof is not None:
            # the profiler records from here to the window's close; the
            # trace is read over TRACE_BLOCKS blocks inside it
            prof.start()
            await asyncio.sleep(seconds * 0.1)
            f0 = probes.fanned
            t_a = time.monotonic()
            while probes.fanned < f0 + TRACE_BLOCKS and \
                    time.monotonic() < t_w1:
                await asyncio.sleep(0.005)
            prof.window = (t_a, time.monotonic())
            rec["profiler"] = prof
        await asyncio.sleep(max(0.0, t_w1 - time.monotonic()))
        if prof is not None:
            prof.stop()
        rec.update(drops1=sum(c.send_drops for c in server.conns.values()),
                   over1=src.overruns, seq1=eng.seq)
        # every delivery due in the window, and every sampled one
        want = max(list(probes.snaps) + (
            [b for b, d in ring.due.items() if d <= t_w1] if paced else []))
        deadline = time.monotonic() + WAIT_AFTER_S
        while time.monotonic() < deadline and min(
                len(s.of(b"SND")) for s in rec["snd"].values()) <= want:
            await asyncio.sleep(0.01)
        rec["t_waited"] = time.monotonic()
        if device == "cuda":
            torch.cuda.synchronize()
            rec["peak"] = torch.cuda.max_memory_allocated()
        alive.cancel()
        await server.stop()
        await asyncio.sleep(0.05)

    asyncio.run(drive())
    ctx.update(blocks=(rec["seq0"], rec["seq1"]),
               window=(rec["t_w0"], rec["t_w1"]))
    part_numbers: dict = {}
    for mod in parts:
        part_numbers.update(mod.numbers(ctx))
        if hasattr(mod, "close"):
            mod.close(ctx)
    src.close()
    ring.close()
    found = forbidden_modules()
    if found:
        print("the run loaded " + ", ".join(found), file=sys.stderr)
        raise SystemExit(3)
    probes = rec["probes"]
    # the program's part is over: copy out what the judge reads, free it
    snaps = {n: {k: {f: t.cpu().numpy() for f, t in s[k].items()}
                 for k in s} for n, s in probes.snaps.items()}
    dev_trace = rec["profiler"].read() if trace else None
    spans = list(probes.spans)
    wf_slots = {key: list(v) for key, v in probes.wf_rows.items()}
    codec_states = dict(probes.codec)
    rec["retunes"] = list(probes.retunes)
    rec["marks"] = {n: t.cpu().numpy() for n, t in probes.marks.items()}
    rec["banks"] = {n: [t.cpu().numpy() for t in v]
                    for n, v in probes.banks.items()}
    del probes, server, eng, src
    rec.pop("probes")
    ctx.clear()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    out = end_to_end(cell, rec, ring, plan, paced)
    out["spans"] = spans
    out["trace"] = dev_trace
    t_judge = time.monotonic()
    numbers = check(cfg, plan, ring, rec, lanes, snd_specs, wf_specs, snaps,
                    codec_states, wf_slots, device, control, detail)
    out["control"] = numbers.pop("control", None)
    out["judge_s"] = time.monotonic() - t_judge
    # a part's numbers stand as they read, the control's beside its own
    required = [k for mod in parts for k in mod.NUMBERS]
    if "adc_ppm" in cfg:
        part_numbers["clock_error_ppm"] = judge.clock_error_ppm(
            ring.true_clock, plan.adc_clock, [r[0] for r in rec["retunes"]])
        required.append("clock_error_ppm")
    numbers.update(part_numbers)
    if out["control"] is not None:
        out["control"].update(part_numbers)
    out["numbers"] = numbers
    out["required"] = required
    if rec["retunes"]:
        out["timing"]["retunes"] = [
            dict(clock=c, block_in=a, block_out=b, host_ms=(t1 - t0) * 1e3)
            for c, a, b, t0, t1 in rec["retunes"]]
    out["peak"] = rec.get("peak", 0)
    out["window"] = (rec["t_w0"], rec["t_w1"])
    out["setup_s"] = rec["setup_s"]
    out["plan"] = plan
    out["due"] = dict(ring.due)
    return out


# ---------------------------------------------------------------------------
# end-to-end metrics, at the listeners' sockets
# ---------------------------------------------------------------------------

def arrivals(rec: dict) -> dict[int, dict[int, float]]:
    """{listener: {block: arrival}}; a listener's SND sequence number is
    the block's, as every listener was there before the first block."""
    from .reference import codec
    out = {}
    for i, sock in rec["snd"].items():
        out[i] = {codec.parse_snd(p)["seq"]: t for t, p in sock.of(b"SND")}
    return out


def end_to_end(cell: Cell, rec: dict, ring: AdcRing, plan: dz.Plan,
               paced: bool) -> dict:
    t_w0, t_w1 = rec["t_w0"], rec["t_w1"]
    arr = arrivals(rec)
    nl = len(arr)
    over = (rec["over1"] - rec["over0"]) * nl
    out = {}
    if paced:
        blocks = [b for b, d in ring.due.items() if t_w0 <= d <= t_w1]
        lat = []
        missing = 0
        for b in blocks:
            for i in arr:
                t = arr[i].get(b)
                if t is None:
                    # never came: late by at least as long as it was
                    # waited for
                    missing += 1
                    t = rec["t_waited"]
                lat.append((t - ring.due[b]) * 1e3)
        out["snd_latency_p95_ms"] = float(np.percentile(
            lat, 95, method="higher")) if lat else None
        per_block = [max(lat[i * len(arr):(i + 1) * len(arr)])
                     for i in range(len(blocks))]
        out["timing"] = dict(
            latency_median_ms=float(np.median(lat)) if lat else None,
            latency_max_ms=max(lat, default=None), deliveries=len(lat),
            blocks_over_two_periods=int(sum(
                v > 2e3 * plan.block_s for v in per_block)),
            block_max_ms=[round(v, 1) for v in per_block])
    else:
        done = {}
        for b in set().union(*[set(a) for a in arr.values()]):
            ts = [arr[i].get(b) for i in arr]
            done[b] = None if None in ts else max(ts)
        complete = [b for b, t in done.items()
                    if t is not None and t_w0 <= t <= t_w1]
        touched = sorted({b for i in arr for b, t in arr[i].items()
                          if t_w0 <= t <= t_w1})
        blocks = list(range(touched[0], touched[-1] + 1)) if touched else []
        missing = sum(1 for b in blocks for i in arr if b not in arr[i])
        out["rt_factor"] = len(complete) * plan.block_s / (t_w1 - t_w0)
        gaps = np.diff(sorted(done[b] for b in complete)) * 1e3
        out["timing"] = dict(
            blocks_complete=len(complete),
            block_gap_median_ms=float(np.median(gaps)) if len(gaps) else None,
            block_gap_max_ms=float(gaps.max()) if len(gaps) else None)
    out["attempted"] = len(blocks) * nl + over
    out["failed"] = missing + over
    out["send_drops"] = rec["drops1"] - rec["drops0"]
    return out


# ---------------------------------------------------------------------------
# correctness
# ---------------------------------------------------------------------------

def check(cfg, plan, ring, rec, lanes, snd_specs, wf_specs, snaps,
          codec_states, wf_slots, device, control: bool = False,
          detail: list | None = None) -> dict:
    """The numbers of the sampled blocks and rows (see
    :mod:`.reference.judge`); with ``control``, also the numbers of the
    control (the reference in TF32, in the program's place) under
    ``"control"``.  The stream's first block is the start: the state
    entering it is held to where a stream starts (``init``); the steps
    held to the reference are the window's.  Each starts from the DDC's
    and the passband FIR's carries as the reference works them out from
    the stream (the program's are held to them: ``carry``, ``state``)
    and from the program's state for the recurrences, which no block
    forgets.  Each block runs under the words of the clock it ran under
    in the program (:func:`.reference.judge.placements`)."""
    import torch
    from .reference import codec
    chans = rec["chans"]
    ref_lanes = rxr.Lanes(plan, [dict(ln, chan=c)
                                 for ln, c in zip(lanes, chans)])
    # the clock each block ran under: the configuration's, and each
    # clock correction's from the block that first read its words
    phases = {n: (m, None) for n, m in rec["marks"].items()}
    phases.update({n: (s["in"]["ddc.phi1"], s["out"].get("ddc.phi1"))
                   for n, s in snaps.items()
                   if n > 0 and "ddc.phi1" in s["in"]})
    clocks, off = judge.placements(
        ref_lanes, [r[:3] for r in rec["retunes"]], phases)
    if rec["retunes"]:
        off += sum(judge.bank_off(ref_lanes.at(clocks[n].of(n)), cols)
                   for n, cols in rec["banks"].items() if n in clocks)
    nums = {"missing": 0.0, "carry": float(off),
            "init": judge.init_number(plan, snaps[0]["in"])}
    ctl: dict = {}
    pkts = {i: {codec.parse_snd(p)["seq"]: codec.parse_snd(p)
                for _t, p in sock.of(b"SND")}
            for i, sock in rec["snd"].items()}
    dev = torch.device(device)
    sam = ref_lanes.mode_id == dz.MODES["sam"]
    sampled = [n for n in snaps if n > 0]
    nums["missing"] += max(0, rec["n_sample"] - len(sampled))
    for n, s in sorted(snaps.items()):
        if n == 0:
            continue
        x = torch.as_tensor(ring.block_of(n), device=dev)
        # the carries the reference works out from the stream itself take
        # the place of the program's; the rest of the state is followed
        held = rxr.stream_carries(ref_lanes, ring.block_of, n, dev,
                                  clocks[n])
        gap_in, carry = judge.carry_numbers(s["in"], held)
        st_in = dict(s["in"], **held)
        lanes_n = ref_lanes.at(clocks[n].of(n))
        taps, st_out = rxr.step(lanes_n, st_in, x, "ref")
        gap, phase = judge.state_number(s["out"], st_out, sam)
        judge.worst(nums, {"state": max(gap, gap_in), "phase": float(phase),
                           "carry": float(carry)})
        if detail is not None:
            for k, g in judge.state_gaps(s["out"], st_out, sam).items():
                detail += [("state", n, k, int(j), float(v))
                           for j, v in enumerate(g) if v > 1e-4]
        if control:
            c_taps, c_out = rxr.step(lanes_n, st_in, x, "tf32")
            gap, phase = judge.state_number(c_out, st_out, sam)
            judge.worst(ctl, {"state": gap, "phase": float(phase)})
        for j, ln in enumerate(lanes):
            st = codec_states.get(n, {}).get(chans[j], (0, 0))
            if control:
                judge.worst(ctl, judge.lane_numbers(
                    judge.control_lane(ln["kind"], c_taps, j, st), taps, j))
            pkt = pkts[j].get(n)
            if pkt is None:
                nums["missing"] += 1
                continue
            got = judge.served_lane(ln["kind"], pkt, st)
            one = judge.lane_numbers(got, taps, j)
            judge.worst(nums, one)
            if detail is not None and any(one.values()):
                detail.append(("lane", n, j, ln["kind"], ln["mode"], one))
    rows = wf_sample(wf_specs, rec, wf_slots, snaps, plan)
    for spec, b_last, pkt in rows:
        if pkt is None:
            nums["missing"] += 1
            continue
        # the program's W/F chains keep the nominal clock's words: the
        # server builds WfSubsystem with it, and a clock correction
        # retunes the receiver's channels alone
        wp = dz.wf_plan(spec["zoom"], plan.adc_clock)
        first = max(0, b_last + 1 - wfr.blocks_needed(wp, plan.adc_block))
        first -= first % wp.ingest_blocks(plan.adc_block)
        blocks = [torch.as_tensor(ring.block_of(b), device=dev)
                  for b in range(first, b_last + 1)]
        want = wfr.row_u8(wfr.row_db(wp, spec["centre_hz"], blocks))
        judge.worst(nums, {"wf": judge.wf_number(pkt, want)})
        if detail is not None:
            detail.append(("wf", spec["zoom"], b_last,
                           judge.wf_number(pkt, want)))
        if control:
            got = wfr.row_u8(wfr.row_db(wp, spec["centre_hz"], blocks,
                                        "tf32"))
            judge.worst(ctl, {"wf": judge.wf_number(
                judge.control_wf(spec["zoom"], want, got), want)})
        del blocks
    if control:
        nums["control"] = ctl
    return nums


def wf_sample(wf_specs, rec, wf_slots, snaps, plan):
    """For each W/F socket, the first row made after each sampled block:
    (spec, its last ingested block, its packet)."""
    from .reference import codec
    out = []
    targets = sorted(n for n in snaps if n > 0)[:WF_ROWS] or [0]
    for i, spec in enumerate(wf_specs):
        sock, key = rec["wf"][i]
        pkts = [codec.parse_wf(p) for _t, p in sock.of(b"W/F ")]
        made = wf_slots.get(key, [])
        for tgt in targets:
            k = next((k for k, b in enumerate(made)
                      if b is not None and b >= tgt), None)
            if k is None:
                out.append((spec, tgt, None))
                continue
            out.append((spec, made[k], pkts[k] if k < len(pkts) else None))
    return out
