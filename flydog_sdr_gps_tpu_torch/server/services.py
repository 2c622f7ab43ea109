"""Background network services — registry, DDNS, update checks.

Reference: `net/services.cpp:1-956` (`services_start()`): public
registry check-in (kiwisdr.com / proxy), DDNS/public-IP discovery,
UPnP port mapping, timezone lookup, plus the auto-update task
(`net/update.cpp:107-270`).

All of these need internet egress; deployments without it (including
this build environment) run with every service individually disabled.
The scheduler and service lifecycle are real — each service is an
async task with an interval, failure backoff, and a status row for the
admin UI — and the egress calls are isolated in ``_fetch`` so a
deployment can supply its own transport.
"""

from __future__ import annotations

import asyncio
import time
from typing import Callable


class Service:
    def __init__(self, name: str, interval_s: float, fn: Callable,
                 enabled: bool = True):
        self.name = name
        self.interval_s = interval_s
        self.fn = fn
        self.enabled = enabled
        self.last_run = 0.0
        self.last_ok: bool | None = None
        self.last_error = ""
        self.runs = 0

    async def run_once(self) -> None:
        self.last_run = time.time()
        self.runs += 1
        try:
            r = self.fn()
            if asyncio.iscoroutine(r):
                await r
            self.last_ok = True
            self.last_error = ""
        except Exception as e:      # noqa: BLE001 — service isolation
            self.last_ok = False
            self.last_error = str(e)


class ServiceScheduler:
    """`services_start()` analogue: periodic tasks with status rows."""

    def __init__(self):
        self.services: dict[str, Service] = {}
        self._task = None
        self._stop = asyncio.Event()

    def register(self, name: str, interval_s: float, fn: Callable,
                 enabled: bool = True) -> Service:
        svc = Service(name, interval_s, fn, enabled)
        self.services[name] = svc
        return svc

    async def _loop(self):
        while not self._stop.is_set():
            now = time.time()
            for svc in self.services.values():
                if not svc.enabled:
                    continue
                backoff = 4.0 if svc.last_ok is False else 1.0
                if now - svc.last_run >= svc.interval_s * backoff:
                    await svc.run_once()
            try:
                await asyncio.wait_for(self._stop.wait(), timeout=1.0)
            except asyncio.TimeoutError:
                pass

    def start(self) -> None:
        self._stop.clear()
        self._task = asyncio.create_task(self._loop())

    async def stop(self) -> None:
        self._stop.set()
        if self._task:
            # a service wedged on device work (e.g. the SNR
            # measurement) must not hang shutdown/restart
            try:
                await asyncio.wait_for(self._task, timeout=10.0)
            except asyncio.TimeoutError:
                self._task.cancel()

    def status(self) -> list[dict]:
        return [dict(name=s.name, enabled=s.enabled, runs=s.runs,
                     ok=s.last_ok, error=s.last_error,
                     age_s=(round(time.time() - s.last_run, 1)
                            if s.last_run else None))
                for s in self.services.values()]


def default_services(server, cfg=None,
                     egress_allowed: bool = False) -> ServiceScheduler:
    """Wire the standard service set; egress-dependent ones start
    disabled unless the deployment opts in."""
    sched = ServiceScheduler()

    def snr_task():
        # periodic band SNR self-measurement (rx/rx_util.cpp:986-)
        import numpy as np
        from ..models import waterfall as wf_model
        eng = server.engine
        if getattr(eng, "_last_x", None) is None:
            return
        import torch
        x = eng._last_x
        params = wf_model.WfParams(zoom=0)
        bank, dphi = wf_model.tune(params, server.ui_srate / 2)
        st = wf_model.init_state(params, x.device)
        st = wf_model.wf_ingest(
            params, st, x, torch.as_tensor(bank, device=x.device),
            torch.tensor(dphi, dtype=torch.int64, device=x.device))
        row = wf_model.wf_frame(params, st).cpu().numpy()
        server.snr_measure(row)

    sched.register("snr_measure", 3600.0, snr_task, enabled=True)

    # real protocol bodies (server/netproto.py, server/update.py);
    # egress is gated ONLY at the transport: without the opt-in these
    # services stay disabled, but their logic is the production code
    # exercised by the mock-endpoint tests (tests/test_netproto.py)
    from . import netproto
    from .update import UpdateManager

    async def _fetch(url, data=None, headers=None):
        import aiohttp
        async with aiohttp.ClientSession() as s:
            meth = s.post if data is not None else s.get
            kw = dict(headers=headers or {})
            if data is not None:
                kw["data"] = data
            async with meth(url, **kw) as r:
                return r.status, await r.read()

    registry_base = (cfg.string("registry_url", "")
                     if cfg else "") or \
        "https://kiwisdr.com/php/update.php"

    async def registry_task():
        ok = await netproto.registry_checkin(_fetch, registry_base,
                                             server)
        if not ok:
            raise RuntimeError("registry check-in refused")

    async def ddns_task():
        info = await netproto.public_ip_lookup(_fetch)
        if info is None:
            raise RuntimeError("no public-ip API reachable")
        server.public_ip = info["ip"]
        host = cfg.string("ddns_hostname", "") if cfg else ""
        if host:
            word = await netproto.ddns_update(
                _fetch, cfg.string("ddns_url", ""), host, info["ip"],
                auth=cfg.string("ddns_auth", "") or None)
            if word not in ("good", "nochg"):
                raise RuntimeError(f"ddns: {word}")

    upd = UpdateManager(
        runner=None if not egress_allowed else _shell_runner,
        install_enabled=bool(cfg and cfg.bool("update_install",
                                              False)))
    server.update_mgr = upd

    async def update_task():
        # upd.check runs subprocesses (pings, git, possibly a full
        # build) — keep it off the event loop or every stream stalls
        st = await asyncio.get_running_loop().run_in_executor(
            None, upd.check)
        if upd.restart_requested:
            server.restart_requested = True
            server._restart_event.set()
        if st["f"]:
            raise RuntimeError(f"update fail reason {st['f']}")

    async def nat_task():
        # auto-NAT (the reference's UPnP_port_open_task): NAT-PMP to
        # the default gateway, UPnP IGD fallback — real UDP/HTTP
        # transports, enabled only with egress
        import socket

        async def udp_roundtrip(payload, addr, timeout=3.0):
            loop = asyncio.get_running_loop()

            def xfer():
                s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                try:
                    s.settimeout(timeout)
                    if addr[0].startswith("239."):   # SSDP multicast
                        s.setsockopt(socket.IPPROTO_IP,
                                     socket.IP_MULTICAST_TTL, 2)
                    s.sendto(payload, addr)
                    return s.recv(2048)
                except OSError:
                    return None
                finally:
                    s.close()
            return await loop.run_in_executor(None, xfer)

        gw = (cfg.string("gateway_ip", "") if cfg else "") or \
            "192.168.1.1"
        local_ip = getattr(server, "local_ip", "") or "127.0.0.1"
        out = await netproto.auto_nat_open(
            _fetch, udp_roundtrip, gw, server.port, local_ip,
            server.port)
        server.nat_status = out
        if not out.get("ok"):
            raise RuntimeError(f"auto-NAT failed: "
                               f"{out.get('error', out)}")

    sched.register("nat_open", 3600.0, nat_task,
                   enabled=egress_allowed)
    sched.register("registry_checkin", 900.0, registry_task,
                   enabled=egress_allowed)
    sched.register("ddns_update", 3600.0, ddns_task,
                   enabled=egress_allowed)
    sched.register("update_check", 86400.0, update_task,
                   enabled=egress_allowed)
    return sched


def _shell_runner(cmd: str):
    """Subprocess step runner for UpdateManager (real deployments)."""
    import subprocess
    r = subprocess.run(cmd, shell=True, capture_output=True,
                       text=True, timeout=600)
    return r.returncode, r.stdout + r.stderr
