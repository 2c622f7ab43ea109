"""Shared waterfall subsystem: N client views on <= capacity chains.

Port of :mod:`flydog_sdr_gps_tpu.server.wf_service`.  Reference
architecture: at most ``wf_chans`` (<= 4) wideband waterfall DDCs exist
in the FPGA; each connection owns one and programs its decimation/NCO
(`rx/rx_waterfall.cpp:410-510`).  Here:

- a SLOT is one streaming decimation chain at a (zoom, start, interp)
  view; connections attach/detach, identical views share one slot;
- the per-zoom builds (filters, pixel maps) are process-wide
  (`models.waterfall.make_wf_params`);
- frames are computed lazily (once per slot per due row) no matter how
  many clients watch, then fanned out with per-connection pacing
  (fps table `rx_waterfall.cpp:71-72,98-102` = off/1/5/13/23),
  aperture and compression state.

DX-masked frequency ranges zero their pixels before the dB mapping
(`rx_waterfall.cpp:905-918`).

The slots' state lives on ``device`` (the card unless the caller asks
for the CPU); :meth:`WfSubsystem.ingest` takes the raw ADC block as a
tensor there (``StreamEngine._last_x``).

As the reference compiles ``jit_ingest`` and ``jit_frame`` once per
zoom, each slot runs on one of ``capacity`` chains of device buffers
(state, tune, mask, row, and an accumulation buffer of ``ingest_blocks``
x block into which each raw block is copied), reused when a view is
evicted; the ingest and the frame are programs over a chain's buffers
(CUDA graphs on a card, keyed by chain, zoom and interp; the same
static-buffer bodies run on the CPU).  On a card the chains run on a
stream of their own, after the event the engine records when the
block is made: the ingest runs beside the receiver's step, and the
caller's stream waits only for the raw block's copy.  Right after a
slot's ingest its row is computed and copied without blocking into
pinned memory, and :meth:`WfSubsystem.frame` waits on that copy's
event only (a ``.cpu()`` there waited for everything on the stream,
the next block's step too).

Threads: the control plane (:meth:`WfSubsystem.attach`,
:meth:`WfSubsystem.set_masked`, on the server's event loop) does no
work on the chains: it marks a slot's chain to be bound (state zeroed,
tune and mask copied in) or re-masked, and the data plane
(:meth:`WfSubsystem.ingest`, :meth:`WfSubsystem.frame`, in executor
threads) applies the marks under one lock before it touches the chain.
That lock holds every use of the chains' stream, and graphs are
captured on a stream of their own, so no other work lands in a
capture.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from .. import _graphs
from ..models import waterfall as wf_model
from ..numerology import MAX_ZOOM, WF_OUT_PX

# reference fps table: WF_SPEED_OFF/1FPS/SLOW/MED/FAST
WF_SPEEDS_FPS = (0, 1, 5, 13, 23)
# reference wf_interp_t {max, min, last, drop, cma} + CIC-comp offset
WF_INTERP = ("max", "min", "last", "drop", "cma")
WF_CIC_COMP = 10


class _Chain:
    """One waterfall DDC's device buffers (the reference's <= 4 FPGA
    waterfall channels): whichever slot it serves, the addresses stay."""

    def __init__(self, idx: int, params: wf_model.WfParams, device):
        st = wf_model.init_state(wf_model.make_wf_params(
            MAX_ZOOM, params.adc_clock, params.ui_srate), device)
        self.idx = idx
        self.phi, self.base_tail, self.ring = st.phi, st.base_tail, st.ring
        self.hb_tails = st.hb_tails                 # (MAX_ZOOM, tail)
        self.bank = torch.zeros(len(params.h_base), dtype=torch.complex64,
                                device=device)
        self.dphi = torch.zeros((), dtype=torch.int64, device=device)
        self.mask = torch.ones(params.out_px, dtype=torch.float32,
                               device=device)
        self.row = torch.zeros(params.out_px, dtype=torch.float32,
                               device=device)
        self.inputs: dict[int, torch.Tensor] = {}   # ingest length -> acc
        pin = torch.device(device).type == "cuda"
        self.rows_host = [torch.zeros(params.out_px, dtype=torch.float32,
                                      pin_memory=pin) for _ in range(2)]
        self.turn = 0
        self.slot: WfSlot | None = None

    def state(self, zoom: int) -> wf_model.WfState:
        """The chain's state buffers as a ``WfState`` at ``zoom``."""
        return wf_model.WfState(phi=self.phi, base_tail=self.base_tail,
                                hb_tails=self.hb_tails[:max(zoom, 1)],
                                ring=self.ring)

    def input(self, n: int) -> torch.Tensor:
        """The accumulation buffer of an ingest of ``n`` samples (made
        once for each length: a graph reads its address)."""
        buf = self.inputs.get(n)
        if buf is None:
            buf = self.inputs[n] = torch.zeros(n, dtype=torch.float32,
                                               device=self.ring.device)
        return buf


class WfSlot:
    """One view (zoom, start bin, interp) that connections share, on the
    chain it was given when it was attached."""

    def __init__(self, key: tuple, params: wf_model.WfParams, cf: float,
                 tune: tuple, mask: torch.Tensor | None, interp: str):
        self.key = key
        self.params = params
        self.cf = cf
        self.tune = tune                # (bank, dphi) tensors on the device
        self.mask = mask                # (out_px,) multiplier, or None
        self.interp = interp
        self.refs = 0
        self.need = 1
        self.dirty = False
        self.row_db: np.ndarray | None = None
        self.row_seq = 0
        self.chain: _Chain | None = None
        self.fetch = None               # (pinned row, event) in flight
        # marks the data plane applies to the chain: bind (zero the
        # state, copy tune and mask in), re-mask
        self.bind = False
        self.remask = False
        self.lock = threading.Lock()    # one frame() at a time
        self.owner: WfSubsystem | None = None
        self._acc_n = 0                 # blocks in the accumulation buffer
        self._block = 0                 # their length

    @property
    def state(self) -> wf_model.WfState:
        """The streaming state: the chain's buffers (assigning copies
        into them)."""
        return self.chain.state(self.params.zoom)

    @state.setter
    def state(self, value: wf_model.WfState) -> None:
        self.owner._on_chain(
            self, lambda: _graphs.copy_into(self.state, value))

    @property
    def acc(self) -> list[torch.Tensor]:
        """The raw blocks waiting for a multi-block ingest (views of the
        accumulation buffer; assigning copies into it)."""
        if not self._acc_n:
            return []
        buf, n = self.chain.input(self.need * self._block), self._block
        return [buf[i * n:(i + 1) * n] for i in range(self._acc_n)]

    @acc.setter
    def acc(self, blocks) -> None:
        def stage():
            self._acc_n = 0
            for x in blocks:
                self._stage(x)
        self.owner._on_chain(self, stage)

    def _stage(self, x: torch.Tensor) -> None:
        """Copy one raw block into the accumulation buffer."""
        n = x.shape[0]
        self.need = self.params.ingest_blocks(n)
        if n != self._block:
            self._acc_n, self._block = 0, n
        buf = self.chain.input(self.need * n)
        buf[self._acc_n * n:(self._acc_n + 1) * n].copy_(x)
        self._acc_n += 1


class WfSubsystem:
    """Owns the shared slots; all work on the chains happens in the
    caller's executor threads, under one lock (one ingest per slot per
    block)."""

    def __init__(self, adc_clock: float, ui_srate: float,
                 capacity: int = 4, masked=(), *,
                 device: torch.device | str = "cuda"):
        self.adc_clock = adc_clock
        self.ui_srate = ui_srate
        self.capacity = capacity
        self.masked = list(masked)       # [(f_lo_hz, f_hi_hz), ...]
        self.device = torch.device(device)
        self.slots: dict[tuple, WfSlot] = {}
        self._chains: list[_Chain] = []
        # the ingest and frame programs of every chain, in one pool: they
        # run one after another on the chains' stream (the set captures
        # on a stream of its own)
        self._graphs = _graphs.GraphSet(self.device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self._graphs.captures else None)
        self._lock = threading.Lock()    # every use of the chains

    @property
    def graphs(self) -> dict:
        """The captured programs ({} on the CPU)."""
        return self._graphs.graphs

    def _on_stream(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    # -- attach / detach ---------------------------------------------------
    def attach(self, zoom: int, start_bin: int,
               interp: str = "cma") -> WfSlot | None:
        key = (zoom, start_bin, interp)
        slot = self.slots.get(key)
        if slot is None:
            if len(self.slots) >= self.capacity:
                self._evict_unreferenced()
            if len(self.slots) >= self.capacity:
                return None              # all chains busy (wf_chans full)
            slot = self._make_slot(key)
            self._bind(slot)
            self.slots[key] = slot
        slot.refs += 1
        return slot

    def detach(self, slot: WfSlot | None) -> None:
        if slot is not None and slot.refs > 0:
            slot.refs -= 1

    def _evict_unreferenced(self) -> None:
        for k in [k for k, s in list(self.slots.items()) if s.refs <= 0]:
            slot = self.slots.pop(k)
            slot.chain.slot = None

    def _make_slot(self, key: tuple) -> WfSlot:
        zoom, start_bin, interp = key
        params = wf_model.make_wf_params(zoom, self.adc_clock,
                                         self.ui_srate)
        hz_per_start = self.ui_srate / (WF_OUT_PX << MAX_ZOOM)
        span = params.span
        cf = start_bin * hz_per_start + span / 2
        cf = min(max(cf, span / 2), self.ui_srate)
        bank, dphi = wf_model.tune(params, cf)
        return WfSlot(
            key=key, params=params, cf=cf,
            tune=(torch.as_tensor(bank, device=self.device),
                  torch.tensor(dphi, dtype=torch.int64,
                               device=self.device)),
            mask=self._device_mask(cf, span), interp=interp)

    def _bind(self, slot: WfSlot) -> None:
        """Give ``slot`` a free chain (made when fewer than ``capacity``
        exist), marked to be bound at its next use."""
        chain = next((c for c in self._chains if c.slot is None), None)
        if chain is None:
            chain = _Chain(len(self._chains), slot.params, self.device)
            self._chains.append(chain)
        chain.slot, slot.chain, slot.owner = slot, chain, self
        slot.bind = True

    def _on_chain(self, slot: WfSlot, fn) -> None:
        """Run ``fn`` (a write into the slot's chain: a state or blocks
        carried in) after the chain's marks, under the lock, on the
        chains' stream after what the caller's stream has queued."""
        caller = (torch.cuda.current_stream(self.device)
                  if self._stream is not None else None)
        with self._lock, self._on_stream():
            if caller is not None:
                self._stream.wait_stream(caller)
            self._apply_marks(slot)
            fn()
            if caller is not None:
                caller.wait_stream(self._stream)

    def _apply_marks(self, slot: WfSlot) -> None:
        """Bind or re-mask the slot's chain as marked (under the lock, on
        the chains' stream).  A mark is cleared before its tensors are
        read, so a mark set meanwhile is applied at the next use."""
        chain = slot.chain
        if slot.bind:
            slot.bind = slot.remask = False
            bank, dphi = slot.tune
            for buf in (chain.phi, chain.base_tail, chain.hb_tails,
                        chain.ring):
                buf.zero_()
            chain.bank.copy_(bank)
            chain.dphi.copy_(dphi)
            self._keep(bank, dphi)
            slot.tune = (chain.bank, chain.dphi)
            self._copy_mask(slot)
        if slot.remask:
            slot.remask = False
            self._copy_mask(slot)
            slot.fetch = None           # a row in flight has the old mask
            slot.dirty = True

    def _copy_mask(self, slot: WfSlot) -> None:
        mask = slot.mask
        if mask is None:
            slot.chain.mask.fill_(1.0)
        else:
            slot.chain.mask.copy_(mask)
            self._keep(mask)

    def _keep(self, *tensors) -> None:
        """Keep the memory of tensors made on another stream until the
        chains' stream has read them."""
        if self._stream is not None:
            for t in tensors:
                if t.is_cuda:
                    t.record_stream(self._stream)

    def _pixel_mask(self, cf: float, span: float) -> np.ndarray | None:
        if not self.masked:
            return None
        edges = cf - span / 2 + span * np.arange(WF_OUT_PX + 1) / WF_OUT_PX
        mask = np.ones(WF_OUT_PX, np.float32)
        for (lo, hi) in self.masked:
            hit = (edges[1:] >= lo) & (edges[:-1] <= hi)
            mask[hit] = 0.0
        return None if mask.all() else mask

    def _device_mask(self, cf: float, span: float) -> torch.Tensor | None:
        m = self._pixel_mask(cf, span)
        return None if m is None else torch.as_tensor(m, device=self.device)

    def set_masked(self, masked) -> None:
        """Update the DX masked-frequency list; live slots re-mask (at
        the data plane's next use of their chains)."""
        self.masked = list(masked)
        for slot in list(self.slots.values()):
            slot.mask = self._device_mask(slot.cf, slot.params.span)
            slot.remask = slot.dirty = True

    # -- data plane (executor threads) ------------------------------------
    def ingest(self, x_dev: torch.Tensor, ready=None) -> None:
        """Advance every live slot with one raw ADC block, taken whole
        (the reference cuts it into chunks for its compiler's sake; the
        streaming tails make a whole and a chunked ingest equal), and
        start the fetch of each advanced slot's row.

        On a card the work runs on the chains' stream, after ``ready``
        (an event recorded when the block was made; without one, after
        everything queued on the caller's stream); the caller's stream
        waits only until the block is copied into the slots' buffers,
        so a source may overwrite it in its next block."""
        with self._lock:
            live = [s for s in list(self.slots.values())
                    if s.refs > 0 and s.chain.slot is s]
            if not live:
                return
            caller = (torch.cuda.current_stream(self.device)
                      if self._stream is not None else None)
            with self._on_stream():
                if caller is not None:
                    if ready is None:
                        self._stream.wait_stream(caller)
                    else:
                        self._stream.wait_event(ready)
                for slot in live:
                    self._apply_marks(slot)
                    slot._stage(x_dev)
                if caller is not None:
                    caller.wait_stream(self._stream)
                for slot in live:
                    if slot._acc_n < slot.need:
                        continue
                    self._ingest(slot)
                    slot.dirty = True
                    self._start_fetch(slot)

    def _ingest(self, slot: WfSlot) -> None:
        chain, params = slot.chain, slot.params
        n = slot.need * slot._block
        slot._acc_n = 0
        x, st = chain.input(n), chain.state(params.zoom)

        def body():
            _graphs.copy_into(st, wf_model.wf_ingest(
                params, st, x, chain.bank, chain.dphi))
        self._graphs.run(("ingest", chain.idx, params.zoom, n), body)

    def _start_fetch(self, slot: WfSlot) -> None:
        """Compute the slot's row into its chain's row buffer and copy it
        without blocking into the chain's next pinned buffer."""
        chain, params, interp = slot.chain, slot.params, slot.interp
        st = chain.state(params.zoom)

        def body():
            chain.row.copy_(wf_model.wf_frame(params, st, "hanning", interp,
                                              mask=chain.mask))
        self._graphs.run(("frame", chain.idx, params.zoom, interp), body)
        host = chain.rows_host[chain.turn]
        chain.turn ^= 1
        host.copy_(chain.row, non_blocking=True)
        event = None
        if self._stream is not None:
            event = torch.cuda.Event()
            event.record(self._stream)
        slot.fetch = (host, event)

    def frame(self, slot: WfSlot) -> np.ndarray:
        """Current row (out_px,) dBFS; computed once per dirty slot no
        matter how many connections read it: the row whose fetch the
        last ingest started (waiting for that copy only), or one
        computed now (after a mask change, or before any ingest).  A
        slot that has lost its chain (detached and evicted meanwhile)
        keeps its last row, or the row of an empty state."""
        with slot.lock:
            with self._lock, self._on_stream():
                if slot.chain.slot is not slot:
                    if slot.row_db is None:
                        slot.row_db = wf_model.wf_frame(
                            slot.params, wf_model.init_state(slot.params,
                                                             "cpu"),
                            "hanning", slot.interp).numpy()
                    return slot.row_db
                self._apply_marks(slot)
                if not slot.dirty and slot.row_db is not None:
                    return slot.row_db
                if slot.fetch is None:
                    self._start_fetch(slot)
                (host, event), slot.fetch = slot.fetch, None
                slot.dirty = False
            if event is not None:
                event.synchronize()
            slot.row_db = host.numpy().copy()
            slot.row_seq += 1
        return slot.row_db
