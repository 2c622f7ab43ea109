"""Server: ``KiwiServer._process_fetched``, host ms a block (the wait
for the block's host copy, the encode, framing and queueing, the wait
for each W/F row, the extensions), over the window."""

from __future__ import annotations

import numpy as np


def read(ctx, name):
    t0, t1 = ctx["window"]
    ms = [(e - a) * 1e3 for s, _b, a, e in ctx["spans"]
          if s == "server.fanout" and t0 <= a <= t1]
    return float(np.mean(ms)) if ms else None
