"""Capture buffers for the decoder extensions' device front ends.

An extension that decodes a whole transmission (WSPR: 114 s, FT8: 13.5
s, FT4: 6.5 s) collects one channel's audio block by block.  The
reference appends each block's column and concatenates at the end; in
torch a column of a device tap is a *view* that keeps the whole (block,
C) tap alive (33.5 MB at C=4096), so a 114 s capture would hold ~670
of them.  :class:`Capture` instead copies each block's column into one
buffer of the capture's length, made when a capture starts: a torch
buffer on the tap's device for the engine's device taps, a numpy buffer
for the server's ``HostTaps`` (whose columns are host rows).  The full
capture goes to the device once, by :func:`on_device`.

The front ends run on a CUDA stream of the extension's own
(:class:`SideStream`).  In the server an extension is fed after the next
block's step is enqueued on the default stream; on that stream its
work, and the copy of its results to the host, would wait for the whole
block (tens of ms).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def engine_device(engine, col=None) -> torch.device:
    """Where an extension's device work runs: the engine's device; for
    a stub engine without one, the tap's device; else the card."""
    dev = getattr(engine, "device", None)
    if dev is not None:
        return torch.device(dev)
    if isinstance(col, torch.Tensor):
        return col.device
    return torch.device("cuda")


class Capture:
    """One channel's audio copied block by block into a buffer of ``n``
    samples.  :meth:`add` returns the full buffer when a block brings
    the count to ``n`` or over (the samples past ``n`` are dropped, as
    the reference drops them) and starts the next capture empty."""

    def __init__(self):
        self.samples = 0
        self._buf = None

    def add(self, col, n: int):
        m = min(col.shape[0], n - self.samples)
        if self._buf is None:
            if isinstance(col, torch.Tensor):
                self._buf = torch.empty(n, dtype=torch.float32,
                                        device=col.device)
            else:
                self._buf = np.empty(n, np.float32)
        if m > 0:
            if isinstance(self._buf, torch.Tensor):
                self._buf[self.samples:self.samples + m].copy_(
                    torch.as_tensor(col[:m], device=self._buf.device))
            else:
                self._buf[self.samples:self.samples + m] = np.asarray(
                    col[:m].cpu() if isinstance(col, torch.Tensor)
                    else col[:m], np.float32)
        self.samples += col.shape[0]
        if self.samples < n:
            return None
        full, self._buf, self.samples = self._buf, None, 0
        return full


def on_device(x, device: torch.device) -> torch.Tensor:
    """A capture (numpy or torch) as a float32 tensor on ``device``:
    one host-to-device copy for a host capture."""
    return torch.as_tensor(x, dtype=torch.float32).to(device)


class SideStream:
    """An extension's CUDA stream, made at first use on a card.  Inside
    :meth:`on` the current stream is it (the current stream is per
    thread); on the CPU :meth:`on` does nothing."""

    def __init__(self):
        self._stream = None

    @contextlib.contextmanager
    def on(self, device: torch.device, after_current: bool = False):
        """Run the body on the extension's stream.  ``after_current``:
        the body reads what the current stream wrote just before (a
        capture copied out of device taps), so it waits for it first."""
        if device.type != "cuda":
            yield
            return
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        if after_current:
            self._stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(self._stream):
            yield
