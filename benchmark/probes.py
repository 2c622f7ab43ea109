"""Wrappers put around the program's entry points from outside.

Nothing in the program is edited: bound methods of the live objects are
replaced by wrappers that call them.  They record

- host spans (name, block, start, end) of the calls into each layer,
  kept in memory: the engine's ``_next_x`` (ring pop and copy to the
  card) and ``run_block_gather`` (the step), the source's
  ``next_block`` (the ring pop), the server's ``_process_fetched``
  (the fan-out: fetch wait, encode, queue) and ``_encode_payloads``,
  the waterfall's ``ingest`` and ``frame``;
- for the correctness check: the engine's state for the listened
  channels before and after the stream's first block and a few blocks
  sampled in the window, the ADPCM encoder state before each block's
  encode, and which block each waterfall row was made from;
- each clock correction (the engine's ``retune_all``): its clock, the
  engine's block count when it was entered and when it returned, and
  the listened channels' rotator words entering the first block
  dispatched after it returned (the judge places the retune by them:
  :func:`.reference.judge.placements`).

After a sampled block's snapshots each of ``hooks`` is called with the
block's number, on the step's thread (a part's ``snapshot``).
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time

import torch


def flatten(obj, prefix: str = "") -> dict:
    """{field path: tensor} of nested dataclasses of tensors."""
    if isinstance(obj, torch.Tensor):
        return {prefix: obj}
    out = {}
    for f in dataclasses.fields(obj):
        out.update(flatten(getattr(obj, f.name),
                           f"{prefix}.{f.name}" if prefix else f.name))
    return out


class Probes:
    def __init__(self, eng, server, src, chans, spans: bool):
        self.eng, self.server = eng, server
        self.C = eng.params.num_channels
        self._idx = torch.as_tensor(chans, dtype=torch.int64,
                                    device=eng.device)
        self.spans: list[tuple[str, int, float, float]] = []
        self.snaps: dict[int, dict] = {}      # block -> {"in", "out"}
        self.codec: dict[int, dict] = {}      # block -> {chan: (pred, idx)}
        self.wf_rows: dict[tuple, list] = {}  # slot key -> [last block]
        self._wf_last: dict[tuple, int] = {}
        self._wf_blocks = 0
        self._fanned = 0
        self._encoded = 0
        self.targets: list[float] = []        # sample the block after each
        self.hooks: list = []                 # hook(n) after a sample
        # (clock, block count entered, returned, host start, end)
        self.retunes: list[tuple[float, int, int, float, float]] = []
        self.marks: dict[int, torch.Tensor] = {}   # block -> rotator words
        self.banks: dict[int, list] = {}      # block -> [columns in, out]
        self._mark_after: int | None = None
        self._lock = threading.Lock()
        self._wrap(eng, "run_block_gather", self._step)
        self._wrap(eng, "retune_all", self._retune)
        self._wrap(server, "_encode_payloads", self._encode)
        self._wrap(server.wf, "ingest", self._wf_ingest)
        self._wrap(server.wf, "frame", self._wf_frame)
        if spans:
            self._wrap(eng, "_next_x", self._span_call("engine._next_x",
                                                       lambda: eng.seq))
            self._wrap(src, "next_block",
                       self._span_call("source.next_block", lambda: eng.seq))
        self._wrap_async(server, "_process_fetched", self._fanout)

    # -- wrapping ----------------------------------------------------------
    @staticmethod
    def _wrap(obj, name, wrapper):
        orig = getattr(obj, name)
        setattr(obj, name, functools.partial(wrapper, orig))

    @staticmethod
    def _wrap_async(obj, name, wrapper):
        orig = getattr(obj, name)

        async def call(*a, **k):
            return await wrapper(orig, *a, **k)
        setattr(obj, name, call)

    def _span(self, name, block, t0, t1):
        with self._lock:
            self.spans.append((name, block, t0, t1))

    def _span_call(self, name, block_of):
        def wrapper(orig, *a, **k):
            b, t0 = block_of(), time.monotonic()
            try:
                return orig(*a, **k)
            finally:
                self._span(name, b, t0, time.monotonic())
        return wrapper

    # -- the state of the listened channels --------------------------------
    def snapshot(self) -> dict:
        """The engine's state for the listened channels, copied on the
        step's stream (so it is the state between two blocks)."""
        out = {}
        for k, t in flatten(self.eng.state).items():
            if t.dim() >= 1 and t.shape[-1] == self.C and k != "ddc.x_tail":
                out[k] = t.index_select(t.dim() - 1, self._idx)
            else:
                out[k] = t.clone()
        return out

    def _due_sample(self) -> bool:
        with self._lock:
            if self.targets and time.monotonic() >= self.targets[0]:
                self.targets.pop(0)
                return True
        return False

    def _due_mark(self, n: int) -> bool:
        with self._lock:
            if self._mark_after is not None and n > self._mark_after:
                self._mark_after = None
                return True
        return False

    def _step(self, orig, idx):
        n = self.eng.seq
        sample = n == 0 or self._due_sample()
        mark = self._due_mark(n)
        t0 = time.monotonic()
        if sample:
            self.snaps[n] = {"in": self.snapshot()}
        elif mark:
            self.marks[n] = self.eng.state.ddc.phi1.index_select(0, self._idx)
        if sample or mark:
            self.banks[n] = [self._bank()]
        out = orig(idx)
        if sample:
            self.snaps[n]["out"] = self.snapshot()
        if sample or mark:
            self.banks[n].append(self._bank())
        self._span("engine.run_block_gather", n, t0, time.monotonic())
        if sample:
            for hook in self.hooks:
                hook(n)
        return out

    # -- clock corrections ---------------------------------------------------
    def _bank(self) -> torch.Tensor:
        """The listened channels' stage-1 bank columns, copied on the
        step's stream."""
        return self.eng.tuning.bank.index_select(1, self._idx)

    def _retune(self, orig, clock, *a, **k):
        seq, t0 = self.eng.seq, time.monotonic()
        try:
            return orig(clock, *a, **k)
        finally:
            with self._lock:
                self.retunes.append((float(clock), seq, self.eng.seq, t0,
                                     time.monotonic()))
                self._mark_after = self.eng.seq

    # -- the server ----------------------------------------------------------
    def _encode(self, orig, audio, audio2, iq_re, iq_im, chmap, keys):
        n = self._encoded
        self._encoded += 1
        chans = {k[1] for k in keys if k[0] == "adpcm"}
        cc = self.server._chan_codec
        self.codec[n] = {ch: (int(cc[ch][0]), int(cc[ch][1])) if ch in cc
                         else (0, 0) for ch in chans}
        t0 = time.monotonic()
        try:
            return orig(audio, audio2, iq_re, iq_im, chmap, keys)
        finally:
            self._span("server.encode", n, t0, time.monotonic())

    async def _fanout(self, orig, *a, **k):
        n = self._fanned
        t0 = time.monotonic()
        try:
            return await orig(*a, **k)
        finally:
            self._fanned += 1
            self._span("server.fanout", n, t0, time.monotonic())

    @property
    def fanned(self) -> int:
        return self._fanned

    # -- the waterfall -------------------------------------------------------
    def _wf_ingest(self, orig, x, ready=None):
        n = self._wf_blocks
        self._wf_blocks += 1
        t0 = time.monotonic()
        try:
            return orig(x, ready)
        finally:
            for key, slot in list(self.server.wf.slots.items()):
                if slot._acc_n == 0 and slot.refs > 0:
                    self._wf_last[key] = n
            self._span("wf.ingest", n, t0, time.monotonic())

    def _wf_frame(self, orig, slot):
        t0 = time.monotonic()
        try:
            return orig(slot)
        finally:
            self.wf_rows.setdefault(slot.key, []).append(
                self._wf_last.get(slot.key))
            self._span("wf.frame", self._wf_blocks - 1, t0, time.monotonic())
