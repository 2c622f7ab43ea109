"""Run a live KiwiSDR-protocol server with a synthetic RF scene.

Usage: python -m flydog_sdr_gps_tpu_torch.run_server [--port 8073]
       [--cpu] [--channels N]

The counterpart of the reference's ``run_server.py``, with the same
flags and the same scene: AM broadcast at 7.100 MHz (1 kHz music-ish
tone), USB at 14.201 MHz, carrier at 10.000 MHz — enough to explore
with the web UI.  The engine, the scene and the waterfall run on the
card; without ``--cpu`` a missing card is an error, not a reason to run
on the CPU.  ``--mesh``, ``--gps`` and ``--autorun`` are the flags of
parts that are not ported yet and end with an error that says so.
"""
from __future__ import annotations

import argparse
import asyncio
import os
import sys


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m flydog_sdr_gps_tpu_torch.run_server")
    p.add_argument("--port", type=int, default=8073)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--channels", type=int, default=4)
    p.add_argument("--gps", action="store_true",
                   help="run the GPS subsystem on a synthetic sky scene "
                        "(not ported yet)")
    p.add_argument("--gps-ppm", type=float, default=0.4,
                   help="simulated oscillator error the GPS loop recovers")
    p.add_argument("--no-realtime", dest="realtime",
                   action="store_false", default=True)
    p.add_argument("--cfg", default=None,
                   help="kiwi.json-style config file (passwords, policy)")
    p.add_argument("--password", default=None,
                   help="user password (overrides cfg)")
    p.add_argument("--admin-password", default=None,
                   help="admin password (overrides cfg)")
    p.add_argument("--dx", default=None,
                   help="dx.json label database path")
    p.add_argument("--inactivity-min", type=float, default=0,
                   help="kick idle listeners after N minutes (0=off)")
    p.add_argument("--tlimit-min", type=float, default=0,
                   help="per-connection time limit in minutes (0=off)")
    p.add_argument("--max-per-ip", type=int, default=0,
                   help="max rx channels one IP may hold (0=unlimited)")
    p.add_argument("--autorun", action="append", default=[],
                   help="background decoder on an idle channel, e.g. "
                        "--autorun wspr:7038.6 (not ported yet)")
    p.add_argument("--mesh", default=None,
                   help="run the engine over several devices, e.g. "
                        "--mesh time=2,chan=4 (not ported yet)")
    p.add_argument("--max-listeners", type=int, default=16,
                   help="mark the subscriber buckets up to this count "
                        "warm at boot; a bucket beyond it is prepared "
                        "off the serving path on first use")
    p.add_argument("--block", type=int, default=None,
                   help="audio samples per block (default: 2048 on the "
                        "card, 128 on the CPU for low latency)")
    p.add_argument("--host-scene", action="store_true",
                   help="generate the RF scene on the host (numpy) "
                        "instead of on the device; every block then "
                        "crosses the host link, only useful for "
                        "debugging")
    p.add_argument("--file", default=None,
                   help="replay a raw int16 capture instead of the "
                        "synthetic scene (host-side, double-buffered "
                        "through the native ring)")
    args = p.parse_args(argv)
    if args.mesh:
        p.error("--mesh waits for the port of the multi-device engine "
                "(runtime/sharded_stream.py)")
    if args.gps:
        p.error("--gps waits for the port of the GPS subsystem "
                "(models/gps, runtime/gps_service.py)")
    if args.autorun:
        p.error("--autorun waits for the port of the extensions and "
                "server/autorun.py")
    return args


def build(args):
    """(server, cfg, engine) for the parsed flags."""
    import numpy as np
    import torch
    from .models import rx_channel as rx
    from .runtime import (DeviceSceneSource, FileSource, StreamEngine,
                          SyntheticSource, ThreadedSource)
    from .server import KiwiServer

    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda")
    else:
        sys.exit("run_server: no CUDA device found; the server runs on "
                 "the card (pass --cpu to run it on the CPU)")

    def am_mod(t):
        return 1.0 + 0.6 * np.sin(2 * np.pi * 1000.0 * t) \
            * np.sin(2 * np.pi * 2.1 * t)

    nchan = args.channels
    block = args.block or (128 if args.cpu else 2048)
    params = rx.RxParams(num_channels=nchan, audio_block=block)
    if args.file:
        # raw capture replay, host-side but double-buffered off the
        # dispatch path through the native SPSC ring (data_pump split)
        src = ThreadedSource(FileSource(args.file),
                             block=params.ddc.adc_block)
    elif args.host_scene:
        src = SyntheticSource(
            tones=[(7.100e6, 0.30, am_mod),
                   (14.2018e6, 0.15),      # USB voice-ish tone @ 14.201
                   (10.000e6, 0.20)],
            noise_rms=3e-4)
    else:
        # the default: the scene is generated on the device, so no
        # sample data crosses the host link
        src = DeviceSceneSource(
            tones=[(7.100e6, 0.30, ("am", 1000.0, 0.6)),
                   (14.2018e6, 0.15),
                   (10.000e6, 0.20)],
            noise_rms=3e-4, block=params.ddc.adc_block, device=device)
    eng = StreamEngine(params, src, device=device)

    cfg = None
    if args.cfg or args.password or args.admin_password:
        from .utils.cfg import Config
        cfg = Config(args.cfg)
        if args.password is not None:
            cfg.set("user_password", args.password)
        if args.admin_password is not None:
            cfg.set("admin_password", args.admin_password)

    server = KiwiServer(eng, cfg=cfg, port=args.port,
                        realtime=args.realtime, dx_path=args.dx)
    if args.inactivity_min:
        server.inactivity_min = args.inactivity_min
    if args.tlimit_min:
        server.tlimit_min = args.tlimit_min
    if args.max_per_ip:
        server.max_conns_per_ip = args.max_per_ip
    if not server.dx.labels:
        # built-in EiBi shortwave schedule (the reference ships
        # pkgs/EiBi merged by init/dx.cpp:768) + synthetic-scene labels
        from .utils import eibi
        from .utils.dx import DxLabel
        n = eibi.load_builtin(server.dx)
        print(f"dx: {n} EiBi labels loaded", flush=True)
        server.dx.upsert(DxLabel(7100.0, "am", "AM test", "synthetic"))
        server.dx.upsert(DxLabel(14201.0, "usb", "USB test", "synthetic"))
        server.dx.upsert(DxLabel(10000.0, "am", "carrier", "synthetic"))
    return server, cfg, eng


async def prewarm(server, eng, max_listeners: int) -> None:
    """Prepare the serving path for every subscriber bucket up to
    ``max_listeners`` in the background and mark it warm, so that
    neither the FIRST listener nor listener #9/#17/... waits.  On this
    engine ``prewarm_gather`` has nothing to compile and returns at
    once; buckets beyond the set are prepared off the serving path
    (`KiwiServer._serve_bucket`)."""
    loop = asyncio.get_running_loop()
    nchan = eng.params.num_channels
    top = 1
    while top < min(max(max_listeners, 1), nchan):
        top *= 2
    bucket = 1
    while bucket <= top:
        server.compiles_in_flight += 1
        try:
            await loop.run_in_executor(None, eng.prewarm_gather, bucket)
        except Exception as e:          # noqa: BLE001 — best effort
            print(f"prewarm bucket {bucket}: {e}", flush=True)
            return
        finally:
            server.compiles_in_flight -= 1
        server._warm_buckets.add(bucket)
        print(f"prewarmed bucket {bucket}", flush=True)
        bucket *= 2


async def serve(server, cfg, eng, max_listeners: int) -> None:
    await server.start()
    # background services: SNR self-measurement + (egress-gated)
    # registry/DDNS/update tasks (`net/services.cpp` services_start)
    from .server.services import default_services
    sched = default_services(server, cfg=cfg,
                             egress_allowed=bool(
                                 cfg and cfg.bool("egress", False)))
    sched.start()
    server.services = sched
    print(f"ready on http://127.0.0.1:{server.port}/", flush=True)
    asyncio.create_task(prewarm(server, eng, max_listeners))
    # offline restart: admin "SET restart" re-execs this process
    # (reference: `ui/admin.cpp` restart op → kiwi_restart())
    await server.wait_restart()
    await sched.stop()
    await server.stop()


def main(argv=None) -> None:
    args = parse_args(argv)
    server, cfg, eng = build(args)
    asyncio.run(serve(server, cfg, eng, args.max_listeners))
    if server.restart_requested:
        print("admin restart requested; re-exec", flush=True)
        os.execv(sys.executable, [sys.executable] + sys.argv)


if __name__ == "__main__":
    main()
