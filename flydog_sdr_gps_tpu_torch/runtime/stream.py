"""The streaming engine: blocks in, per-channel audio out.

Port of the block loop and control plane of
:mod:`flydog_sdr_gps_tpu.runtime.stream`: one block program advances
every channel; the host keeps the sequence accounting, the 48-bit block
timestamps, the NaN health check and the fan-out to subscribers.  (The
server's fused gather, its prewarm and checkpointing are not ported
yet.)
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..models import rx_channel as rx
from ..ops import channelizer as chz
from ..ops import demod as demod_ops
from ..ops import fastfir
from ..ops import nco


@dataclasses.dataclass
class ChannelCtl:
    """Host-side mirror of one channel's tuning (control plane)."""
    freq_hz: float = 10.0e6
    mode: int = demod_ops.MODE_USB
    passband: tuple[float, float] | None = None
    agc_on: bool = True
    manual_gain_db: float = 50.0
    squelch: float = 0.0
    nb_on: bool = False
    nb_wild: bool = False
    deemph_on: bool = False
    mute_over_dbm: float = 20.0
    nr_on: bool = False             # spectral NR (NR_SPECTRAL)
    nr_notch_on: bool = False       # LMS autonotch (NR_ORIG/NR_WDSP)
    nr_den_on: bool = False         # LMS denoiser
    in_use: bool = False


class StreamEngine:
    """Owns the receiver state on ``device`` and advances it block by
    block."""

    def __init__(self, params: rx.RxParams, source, *,
                 device: torch.device | str = "cuda"):
        self.params = params
        self.source = source
        self.device = torch.device(device)
        self.state = rx.init_state(params, self.device)
        self.ctl = [ChannelCtl() for _ in range(params.num_channels)]
        self.tuning = rx.default_tuning(params, self.device)
        self.seq = 0
        self.block_ticks = 0            # 48-bit tick of block start
        self.subscribers: list[Callable] = []
        self.resets = 0

    # -- control plane ---------------------------------------------------
    def set_channel(self, ch: int, **kwargs) -> None:
        """Apply "SET"-style changes (freq/mode/passband/agc/...)."""
        ctl = self.ctl[ch]
        retune = False
        recoef = False
        for k, v in kwargs.items():
            if not hasattr(ctl, k):
                raise KeyError(k)
            if getattr(ctl, k) != v:
                setattr(ctl, k, v)
                retune |= k == "freq_hz"
                recoef |= k in ("mode", "passband")
        t = self.tuning                 # updated in place
        if retune:
            fcw = nco.freq_to_fcw(ctl.freq_hz, self.params.adc_clock)
            col, dp = chz.build_filterbank_column(self.params.ddc, fcw)
            t.bank[:, ch] = torch.as_tensor(col, device=self.device)
            t.dphi1[ch] = dp
        if recoef:
            pb = ctl.passband or rx._default_passband(ctl.mode)
            coef = fastfir.passband_freq_coef(
                self.params.fs_out, pb[0], pb[1], plan=self.params.fir)
            t.pb_coef[:, ch] = torch.as_tensor(coef, device=self.device)
            t.mode[ch] = ctl.mode
        # scalar per-channel knobs
        t.manual_gain_db[ch] = np.nan if ctl.agc_on else ctl.manual_gain_db
        t.squelch_thresh[ch] = ctl.squelch
        t.nb_on[ch] = ctl.nb_on
        t.nb_wild[ch] = ctl.nb_wild
        t.deemph_on[ch] = ctl.deemph_on
        t.mute_over_dbm[ch] = ctl.mute_over_dbm
        t.nr_on[ch] = ctl.nr_on
        t.nr_notch_on[ch] = ctl.nr_notch_on
        t.nr_den_on[ch] = ctl.nr_den_on
        self.tuning = rx.with_gates(t)

    def retune_all(self, adc_clock_corrected: float) -> None:
        """Clock-discipline feedback: rebuild every NCO against the
        corrected ADC clock (`rx/rx_sound.cpp:334-344`).  Only the tuning
        words change; the decimation plan stays at nominal."""
        fcws = [nco.freq_to_fcw(c.freq_hz, adc_clock_corrected)
                for c in self.ctl]
        bank, dphi = chz.build_filterbank(self.params.ddc, fcws)
        self.tuning = dataclasses.replace(
            self.tuning, bank=torch.as_tensor(bank, device=self.device),
            dphi1=torch.as_tensor(dphi, device=self.device))

    # -- data plane ------------------------------------------------------
    def run_block(self) -> rx.RxTaps:
        """Pull one source block through the pipeline; fan out."""
        ticks = getattr(self.source, "ticks", 0)
        x = self.source.next_block(self.params.ddc.adc_block)
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x).to(self.device)
        self.state, taps = rx.rx_block(self.params, self.state, self.tuning,
                                       x)
        self.block_ticks = ticks
        self.seq += 1
        if self.seq % 64 == 0:          # cheap periodic health check
            if not bool(torch.isfinite(taps.audio).all()):
                self.reset_streaming_state()
        for fn in self.subscribers:
            fn(self, taps)
        return taps

    def reset_streaming_state(self) -> None:
        """Full streaming-state reset (data-pump reset analogue)."""
        self.state = rx.init_state(self.params, self.device)
        self.resets += 1
