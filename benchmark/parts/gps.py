"""The GPS/Galileo receiver of a public KiwiSDR with its GPS antenna on,
beside the DDC bank, correcting the ADC's clock (the admin default).

Built as ``run_server.py --gps`` builds it, from the configuration's
``gps`` group: a sky of ``gps_sats`` GPS and ``galileo_sats`` Galileo
satellites over the receiver's position, the decoy PRNs searched too,
the IF sampler on the ADC's oscillator (the sky's ``clock_ppm`` is the
configuration's ``adc_ppm``), and ``GpsReceiver`` on the engine: 0.4 s
chunks at real time on the receiver's own CUDA stream, a solve every
2 s, a search every 20 s while a searched PRN is untracked, each settled
clock estimate retuning every channel (``StreamEngine.retune_all``).
It starts cold: each satellite's ephemeris is decoded from its nav bits
before the first fix.

The sky stands in for the GPS front end, as ``generator.py`` stands in
for the ADC: its IF for ``if_seconds`` (set-up, the window, the wait
after it, with room to spare) is synthesised on the card before the
server is built, in the sky's own sample format (float32, 1 bit), and
served to the receiver chunk by chunk (:class:`IfReplay`), so the run's
timed work is the receiver's alone.  The IF never wraps: a chunk past its
end raises in the receiver, which counts it in ``errors``.

Numbers, each held to the cell's limit:

- ``gps_errors``: chunks the receiver's loop caught an exception on;
- ``fix_error_m``: the last single-point fix's distance from the sky's
  true position (the least-squares position of the last solve over
  every tracked satellite; no reading without one).  The receiver's
  filtered fix (``mgr.last_fix``) is not held: as the reference's, it
  leaves the truth by tens of km once Galileo satellites join the GPS
  ones, while the single-point fixes stay within metres;
- ``no_retune_in_window``: 1 if no clock correction was applied between
  the window's first and last block, else 0.

Standard error gets one line of when each correction was applied, in
seconds from the window's start.
"""

from __future__ import annotations

import math
import sys

NUMBERS = ("gps_errors", "fix_error_m", "no_retune_in_window")


class IfReplay:
    """The sky's IF, ``seconds`` of it made up front in chunks of
    ``chunk`` samples, served in turn (a sample source for
    ``GpsReceiver``: ``next_block``, ``ticks``, ``adc_clock``)."""

    def __init__(self, sky, seconds: float, chunk: int, device):
        import torch
        n = int(math.ceil(seconds * sky.fs / chunk))
        self.adc_clock = sky.adc_clock
        self.buf = torch.empty(n * chunk, dtype=torch.float32,
                               device=device)
        for i in range(n):
            self.buf[i * chunk:(i + 1) * chunk].copy_(
                torch.as_tensor(sky.next_block(chunk)))
        self.ticks = 0

    def next_block(self, n: int):
        if self.ticks + n > self.buf.numel():
            raise EOFError(f"the sky's {self.buf.numel()} IF samples ran "
                           f"out at {self.ticks}")
        x = self.buf[self.ticks:self.ticks + n]
        self.ticks += n
        return x


def build(ctx):
    import torch
    from flydog_sdr_gps_tpu_torch.models.gps import manager as gman
    from flydog_sdr_gps_tpu_torch.models.gps import scene as gsc
    from flydog_sdr_gps_tpu_torch.runtime import GpsReceiver
    g = ctx["cfg"]["gps"]
    dev = torch.device(ctx["device"])
    pos = gsc.ecef_from_lla(g["lat_deg"], g["lon_deg"], g["alt_m"])
    t0 = g["t0_gps_s"]
    ephs = gsc.visible_constellation(pos, t0, n_sats=g["gps_sats"])
    gal = gsc.visible_galileo(pos, t0, n_sats=g["galileo_sats"])
    sky = gsc.GpsScene(pos, ephs, t0, duration=g["if_seconds"],
                       clock_ppm=ctx["cfg"].get("adc_ppm", 0.0),
                       noise=g["noise"], amplitude=g["amplitude"],
                       galileo_ephemerides=gal,
                       seed=int(ctx["seed"]) % (1 << 63), device=dev)
    chunk = int(round(g["chunk_s"] * sky.fs))
    replay = IfReplay(sky, g["if_seconds"], chunk, dev)
    del sky
    mgr = gman.GpsManager(prns=tuple(ephs) + tuple(g["decoy_prns"]),
                          galileo_prns=tuple(gal), device=dev)
    rec = GpsReceiver(replay, mgr, engine=ctx["engine"],
                      chunk_seconds=g["chunk_s"],
                      solve_interval=g["solve_interval_s"],
                      search_interval=g["search_interval_s"],
                      min_clock_change_ppm=g["min_clock_change_ppm"],
                      realtime=True)
    ctx["gps"] = dict(receiver=rec, truth=pos)
    return {"gps": rec}


def applied(ctx) -> list[tuple[float, int, int]]:
    """Each applied correction: (host start, block count entered,
    returned), from the probes' record of ``retune_all``."""
    return [(t0, a, b) for _c, a, b, t0, _t1 in ctx["probes"].retunes]


def numbers(ctx):
    import numpy as np
    rec, truth = ctx["gps"]["receiver"], ctx["gps"]["truth"]

    def off(pos) -> float:
        return float(np.linalg.norm(np.asarray(pos, np.float64)
                                    - np.asarray(truth, np.float64)))
    first, last = ctx["blocks"]
    got = applied(ctx)
    inside = [a for _t, a, b in got if first <= a and b <= last]
    out = {"gps_errors": float(rec.errors),
           "no_retune_in_window": 0.0 if inside else 1.0}
    fix = rec.mgr.last_solutions.get("all")
    if fix is not None:
        out["fix_error_m"] = off(fix["pos"])
    filtered = rec.mgr.last_fix
    w0, w1 = ctx["window"]
    print("gps: corrections at "
          + ", ".join(f"{t - w0:.2f}" for t, _a, _b in got)
          + f" s of the window (0 to {w1 - w0:.2f} s); "
          f"{rec.mgr.fixes} fixes, the filtered fix "
          + ("none" if filtered is None else f"{off(filtered):.1f} m off"),
          file=sys.stderr)
    return out
