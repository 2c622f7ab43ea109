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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import waterfall as wf_model
from ..numerology import MAX_ZOOM, WF_OUT_PX

# reference fps table: WF_SPEED_OFF/1FPS/SLOW/MED/FAST
WF_SPEEDS_FPS = (0, 1, 5, 13, 23)
# reference wf_interp_t {max, min, last, drop, cma} + CIC-comp offset
WF_INTERP = ("max", "min", "last", "drop", "cma")
WF_CIC_COMP = 10


@dataclasses.dataclass
class WfSlot:
    key: tuple                       # (zoom, start_bin, interp)
    params: wf_model.WfParams
    cf: float
    tune: tuple                      # (bank, dphi) tensors on the device
    state: wf_model.WfState
    mask: torch.Tensor | None        # (out_px,) multiplier on the device
    interp: str = "cma"
    refs: int = 0
    acc: list = dataclasses.field(default_factory=list)
    need: int = 1
    dirty: bool = False
    row_db: np.ndarray | None = None
    row_seq: int = 0


class WfSubsystem:
    """Owns the shared slots; all device work happens in the caller's
    executor thread (one ingest per slot per block)."""

    def __init__(self, adc_clock: float, ui_srate: float,
                 capacity: int = 4, masked=(), *,
                 device: torch.device | str = "cuda"):
        self.adc_clock = adc_clock
        self.ui_srate = ui_srate
        self.capacity = capacity
        self.masked = list(masked)       # [(f_lo_hz, f_hi_hz), ...]
        self.device = torch.device(device)
        self.slots: dict[tuple, WfSlot] = {}

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
            self.slots[key] = slot
        slot.refs += 1
        return slot

    def detach(self, slot: WfSlot | None) -> None:
        if slot is not None and slot.refs > 0:
            slot.refs -= 1

    def _evict_unreferenced(self) -> None:
        for k in [k for k, s in self.slots.items() if s.refs <= 0]:
            del self.slots[k]

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
            state=wf_model.init_state(params, self.device),
            mask=self._device_mask(cf, span), interp=interp)

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
        """Update the DX masked-frequency list; live slots re-mask."""
        self.masked = list(masked)
        for slot in self.slots.values():
            slot.mask = self._device_mask(slot.cf, slot.params.span)
            slot.dirty = True

    # -- data plane (executor thread) ---------------------------------------
    def ingest(self, x_dev: torch.Tensor) -> None:
        """Advance every live slot with one raw ADC block, taken whole
        (the reference cuts it into chunks for its compiler's sake; the
        streaming tails make a whole and a chunked ingest equal)."""
        for slot in list(self.slots.values()):
            if slot.refs <= 0:
                continue
            need = slot.params.ingest_blocks(x_dev.shape[0])
            if need > 1:
                slot.acc.append(x_dev)
                if len(slot.acc) < need:
                    continue
                x = torch.cat(slot.acc)
                slot.acc = []
            else:
                x = x_dev
            bank, dphi = slot.tune
            slot.state = wf_model.wf_ingest(slot.params, slot.state, x, bank,
                                            dphi)
            slot.dirty = True

    def frame(self, slot: WfSlot) -> np.ndarray:
        """Current row (out_px,) dBFS; computed once per dirty slot no
        matter how many connections read it."""
        if slot.dirty or slot.row_db is None:
            row = wf_model.wf_frame(slot.params, slot.state, "hanning",
                                    slot.interp, mask=slot.mask)
            slot.row_db = row.cpu().numpy()
            slot.row_seq += 1
            slot.dirty = False
        return slot.row_db
