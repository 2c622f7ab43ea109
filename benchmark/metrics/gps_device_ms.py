"""GPS: device ms of the kernels on the GPS receiver's stream, per chunk
of IF (the configuration's ``gps.chunk_s``; the receiver runs at real
time, so the traced window holds its length over that many chunks).
The receiver's stream is the one that runs kernel 6, the tracking bank
(``kernels/gps_track_roofline_pct/``), as ``_device.engine_stream``
finds the engine's by kernel 1."""

from __future__ import annotations

from _device import matches


def receiver_stream(ctx):
    """(stream id, its kernels) of the stream running kernel 6, or
    None."""
    t = ctx["trace"]
    if t is None or not t.kernels:
        return None
    names = ctx["kernel_names"]("gps_track_roofline_pct")
    for sid, evs in t.streams().items():
        if any(matches(e["name"], names) for e in evs):
            return sid, evs
    return None


def read(ctx, name):
    got = receiver_stream(ctx)
    gps = ctx["cfg"].get("gps")
    if got is None or gps is None:
        return None
    _sid, evs = got
    chunks = ctx["trace"].window_s / gps["chunk_s"]
    return sum(e["dur"] for e in evs) * 1e-3 / chunks
