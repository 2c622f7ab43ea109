"""Kernel 6 (``csrc/gps_track.cu``, the GPS tracking bank): its share of
its roofline, the operations of its launches over the float32 peak,
divided by their device time.

Operations: 19 a sample and row (:func:`track_flops`; the carrier
wipe-off, three code replicas and their six sums).  Each launch tracks
one chunk of IF (``gps.chunk_s`` at 16.368 Msps) over the rows of its
grid, a cluster of ``CLUSTER`` blocks a row; a trace without the grid
counts ``ROWS``, the bank's rows.  A launch cut by the traced window's
edge is left out (its operations are not all inside)."""

from __future__ import annotations

from _device import matches

GPS_FS = 16.368e6       # the IF sample rate (gps/gps.h)
CLUSTER = 8             # blocks a row (kCluster in csrc/gps_track.cu)
ROWS = 12               # the bank's rows (GPS_MAX_CHANS)


def track_flops(rows: int, samples: float) -> float:
    """Operations of one launch over ``rows`` rows and ``samples`` IF
    samples."""
    return 19.0 * rows * samples


def rows_of(event) -> int:
    grid = event.get("args", {}).get("grid")
    if not grid:
        return ROWS
    n = 1
    for g in grid:
        n *= int(g)
    return n // CLUSTER


def read(ctx, name):
    t = ctx["trace"]
    gps = ctx["cfg"].get("gps")
    if t is None or gps is None:
        return None
    names = ctx["kernel_names"](name)
    evs = [e for e in t.kernels if matches(e["name"], names)
           and t.t_lo < e["ts"] and e["ts"] + e["dur"] < t.t_hi]
    us = sum(e["dur"] for e in evs)
    if not us:
        return None
    samples = round(gps["chunk_s"] * GPS_FS)
    rf = ctx["roofline"]
    least = sum(track_flops(rows_of(e), samples) for e in evs) \
        / rf.PEAK_F32_FLOPS
    return rf.share(least, us * 1e-6)
