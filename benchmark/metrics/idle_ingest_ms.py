"""Ingest: device-idle ms a traced block (no kernel on the card) that
falls inside the program's ingest spans, ``source.wait``, ``source.pop``
and ``engine.h2d``."""

from __future__ import annotations

from _program import idle_inside


def read(ctx, name):
    return idle_inside(ctx, {"source.wait", "source.pop", "engine.h2d"})
