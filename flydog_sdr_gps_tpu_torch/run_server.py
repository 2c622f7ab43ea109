"""Run a live KiwiSDR-protocol server with a synthetic RF scene.

Usage: python -m flydog_sdr_gps_tpu_torch.run_server [--port 8073]
       [--cpu] [--channels N] [--gps [--gps-ppm P]]

The counterpart of the reference's ``run_server.py``, with the same
flags and the same scene: AM broadcast at 7.100 MHz (1 kHz music-ish
tone), USB at 14.201 MHz, carrier at 10.000 MHz — enough to explore
with the web UI.  The engine, the scene and the waterfall run on the
card; without ``--cpu`` a missing card is an error, not a reason to run
on the CPU.  ``--gps`` adds the GPS/Galileo receiver on a synthetic sky
(8 GPS satellites, 3 decoy PRNs, 4 Galileo E1B satellites, the
oscillator off by ``--gps-ppm``): on the card the sky is synthesized
there in 0.4 s chunks, with ``--cpu`` on the host in 0.1 s chunks, paced
at real time; its fixes discipline the clock that tunes every channel.
``--autorun wspr:7038.6 --autorun FT8:14074`` (repeatable) runs
background decoders on idle channels, which yield to listeners; it takes
every extension name the reference registers (``NAVTEX:518`` too), and a
spec naming an unknown extension ends with an error.
``--mesh time=T,chan=K`` runs the multi-device engine
(``runtime.ShardedStreamEngine``) over a (T, K) mesh on the host scene,
the channel count rounded up to a multiple of T*K: with ``--cpu`` over
T*K CPU devices, on the card over the cards, whose count must be T*K.
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
                   help="run the GPS subsystem on a synthetic sky scene")
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
                        "--autorun wspr:7038.6 --autorun FT8:14074 "
                        "(repeatable)")
    p.add_argument("--mesh", default=None,
                   help="run the multi-device engine over a device "
                        "mesh, e.g. --mesh time=2,chan=4 (the card count "
                        "must equal time*chan; with --cpu a mesh of that "
                        "many CPU devices)")
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
    args.mesh_spec = None
    if args.mesh:
        try:
            spec = dict(kv.split("=") for kv in args.mesh.split(","))
            args.mesh_spec = {k: int(v) for k, v in spec.items()}
        except ValueError:
            p.error(f"--mesh {args.mesh}: expected time=T,chan=K")
        if not set(args.mesh_spec) <= {"time", "chan"} or \
                min(args.mesh_spec.values()) < 1:
            p.error(f"--mesh {args.mesh}: expected time=T,chan=K")
    if args.autorun:
        from .server.autorun import parse_spec
        for spec in args.autorun:
            try:
                parse_spec(spec)
            except ValueError as e:
                p.error(str(e))
    return args


def build(args):
    """(server, cfg, engine) for the parsed flags."""
    import numpy as np
    import torch
    from .models import rx_channel as rx
    from .runtime import (DeviceSceneSource, FileSource, GpsReceiver,
                          ShardedStreamEngine, StreamEngine,
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
    mesh = None
    if args.mesh_spec:
        from . import parallel
        t_sz = args.mesh_spec.get("time", 1)
        k_sz = args.mesh_spec.get("chan", 1)
        n_dev = t_sz * k_sz
        if args.cpu:
            mesh = parallel.make_mesh(t_sz, k_sz, devices=["cpu"] * n_dev)
        else:
            cards = torch.cuda.device_count()
            if cards != n_dev:
                sys.exit(f"run_server: --mesh time={t_sz},chan={k_sz} needs "
                         f"{n_dev} cards; this host has {cards}")
            mesh = parallel.make_mesh(t_sz, k_sz)
        # the sharded step needs channels divisible by time*chan shards
        if nchan % n_dev:
            nchan = ((nchan + n_dev - 1) // n_dev) * n_dev
            print(f"rounding channels {args.channels} -> {nchan} "
                  f"(multiple of {n_dev} mesh devices)", flush=True)
    block = args.block or (128 if args.cpu else 2048)
    params = rx.RxParams(num_channels=nchan, audio_block=block)
    if args.file:
        # raw capture replay, host-side but double-buffered off the
        # dispatch path through the native SPSC ring (data_pump split)
        src = ThreadedSource(FileSource(args.file),
                             block=params.ddc.adc_block)
    elif args.host_scene or mesh is not None:
        # the mesh engine splits each block over its time rows from the
        # host, as the reference's does
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
    if mesh is not None:
        eng = ShardedStreamEngine(params, src, mesh=mesh)
        print(f"multi-device engine on mesh {mesh.shape}", flush=True)
    else:
        eng = StreamEngine(params, src, device=device)

    gps = None
    if args.gps:
        from .models.gps import manager as gps_manager
        from .models.gps import scene as gps_scene
        rx_pos = gps_scene.ecef_from_lla(47.37, 8.54, 450.0)
        t0 = 345600.0 + 3.0
        ephs = gps_scene.visible_constellation(rx_pos, t0, n_sats=8)
        gal_ephs = gps_scene.visible_galileo(rx_pos, t0, n_sats=4)
        sky = gps_scene.GpsScene(rx_pos, ephs, t0, duration=3600.0,
                                 clock_ppm=args.gps_ppm, noise=0.9,
                                 amplitude=0.5,
                                 galileo_ephemerides=gal_ephs,
                                 device="host" if args.cpu else device)
        mgr = gps_manager.GpsManager(
            prns=tuple(ephs) + (3, 7, 30),      # scene PRNs + decoys
            galileo_prns=tuple(gal_ephs), device=device)
        gps = GpsReceiver(sky, mgr, engine=eng,
                          chunk_seconds=0.1 if args.cpu else 0.4,
                          realtime=True)

    cfg = None
    if args.cfg or args.password or args.admin_password:
        from .utils.cfg import Config
        cfg = Config(args.cfg)
        if args.password is not None:
            cfg.set("user_password", args.password)
        if args.admin_password is not None:
            cfg.set("admin_password", args.admin_password)

    server = KiwiServer(eng, cfg=cfg, port=args.port,
                        realtime=args.realtime, gps=gps, dx_path=args.dx,
                        autorun=args.autorun or None)
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
    neither the FIRST listener nor listener #9/#17/... waits.  On the
    card ``prewarm_gather`` captures each bucket's serve program (the
    first after a warm-up on scratch buffers); on the CPU and on a mesh
    it has nothing to do.  Buckets beyond the set are prepared off the serving
    path (`KiwiServer._serve_bucket`)."""
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
