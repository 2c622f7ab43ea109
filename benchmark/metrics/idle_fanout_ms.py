"""Server: device-idle ms a traced block (no kernel on the card) that
falls inside the program's fan-out, the span ``server.fanout`` (its
children, ``fanout.*``, lie inside it)."""

from __future__ import annotations

from _program import idle_inside


def read(ctx, name):
    return idle_inside(ctx, {"server.fanout"})
