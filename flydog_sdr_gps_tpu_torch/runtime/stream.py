"""The streaming engine: blocks in, per-channel audio out.

Port of the block loop and control plane of
:mod:`flydog_sdr_gps_tpu.runtime.stream`: one block program advances
every channel; the host keeps the sequence accounting, the 48-bit block
timestamps, the NaN health check and the fan-out to subscribers.

The serving path is :meth:`StreamEngine.run_block_gather`: it advances
the block and packs only the subscribed channels' tap columns into one
flat float32 tensor on the device (the reference's layout, so the
server unpacks it unchanged), which :meth:`StreamEngine.start_fetch`
copies to pinned host memory without blocking, so that the copy runs
while the next block is computed.  :meth:`save_state` and
:meth:`load_state` checkpoint the streaming state.

As the reference jits its step (``use_jit=True``), the engine on a card
runs the compiled step (``use_graphs``, :func:`..models.rx_channel.
jit_rx_block`): each block and each bucket's serving program is a CUDA
graph replayed over buffers the step owns.  The engine's ``state`` and
``tuning`` are those buffers; assigning either copies into them.  A
block's taps and packed result are buffers too, overwritten by the next
block.
"""

from __future__ import annotations

import dataclasses
import pickle
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
                 device: torch.device | str = "cuda",
                 use_graphs: bool | None = None):
        """``use_graphs``: run the compiled step (the reference's
        ``use_jit``); by default on a card, and not on the CPU, where
        ``True`` runs the compiled step's static-buffer body with
        nothing captured.  ``False`` is the eager step."""
        self.params = params
        self.source = source
        self.device = torch.device(device)
        if use_graphs is None:
            use_graphs = self.device.type == "cuda"
        # the compiled step owns the state and tuning buffers; None: the
        # eager step, whose state and tuning are rebound every block
        self._compiled = (rx.jit_rx_block(params, self.device)
                          if use_graphs else None)
        self._gsteps: dict[int, ServeProgram] = {}
        if self._compiled is None:
            self.state = rx.init_state(params, self.device)
            self.tuning = rx.default_tuning(params, self.device)
        self.ctl = [ChannelCtl() for _ in range(params.num_channels)]
        self.seq = 0
        self.block_ticks = 0            # 48-bit tick of block start
        self.subscribers: list[Callable] = []
        self.resets = 0
        self._last_x: torch.Tensor | None = None   # raw block (waterfall)
        self._x_ready = None            # event after it was made (card)
        # host buffers of the packed fetch: two, used in turns, made once
        # at the largest bucket's length (pinning memory stalls the card,
        # so it is kept off the block loop) and sliced for smaller ones
        bucket = 1
        while bucket < params.num_channels:
            bucket *= 2
        self._fetch_bufs = [
            torch.empty(self.packed_len(bucket), dtype=torch.float32,
                        pin_memory=self.device.type == "cuda")
            for _ in range(2)]
        self._fetch_turn = 0

    @property
    def compiled(self) -> rx.CompiledRxBlock | None:
        """The compiled step (its graphs, capture times and buffers), or
        None for the eager engine."""
        return self._compiled

    # -- the state and tuning: on the compiled step, its own buffers -----
    @property
    def state(self) -> rx.RxState:
        return self._state if self._compiled is None else self._compiled.state

    @state.setter
    def state(self, value: rx.RxState) -> None:
        if self._compiled is None:
            self._state = value
        else:
            rx.copy_into(self._compiled.state, value)

    @property
    def tuning(self) -> rx.RxTuning:
        return (self._tuning if self._compiled is None
                else self._compiled.tuning)

    @tuning.setter
    def tuning(self, value: rx.RxTuning) -> None:
        if self._compiled is None:
            self._tuning = value
            return
        step = self._compiled
        rx.copy_into(step.tuning, value)
        # the same buffers under the new gates (one reference swap, so a
        # block in flight on another thread reads one gate tuple whole)
        step.tuning = dataclasses.replace(
            step.tuning, **{f: getattr(value, f) for f in rx.GATE_FIELDS})

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
    def _next_x(self) -> tuple[int, torch.Tensor]:
        """The source's tick and next block on the device.  The block is
        kept as ``_last_x`` (the waterfall's input), and on a card
        ``_x_ready`` is an event recorded just after it was made (before
        the step), which a consumer on another stream waits on.  A
        compiled source's block is its output buffer, which its next
        block overwrites: a consumer that keeps it longer copies it
        (``WfSubsystem.ingest`` does, and makes the caller's stream wait
        for its copy)."""
        ticks = getattr(self.source, "ticks", 0)
        x = self.source.next_block(self.params.ddc.adc_block)
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x).to(self.device)
        self._last_x = x            # raw block for waterfall taps
        self._x_ready = _ready_event(x)
        return ticks, x

    def _advance(self) -> tuple[torch.Tensor, rx.RxTaps]:
        """One source block through the block program."""
        ticks, x = self._next_x()
        if self._compiled is None:
            self.state, taps = rx.rx_block(self.params, self.state,
                                           self.tuning, x)
        else:
            taps = self._compiled.block(x)
        self.block_ticks = ticks
        self.seq += 1
        return x, taps

    def run_block(self) -> rx.RxTaps:
        """Pull one source block through the pipeline; fan out."""
        _, taps = self._advance()
        if self.seq % 64 == 0:          # cheap periodic health check
            if not bool(torch.isfinite(taps.audio).all()):
                self.reset_streaming_state()
        for fn in self.subscribers:
            fn(self, taps)
        return taps

    def run_block_gather(self, idx: np.ndarray) -> torch.Tensor:
        """The serving path: advance the block AND pack the subscribed
        channels' tap columns on the device.

        idx: (bucket,) channel numbers.  Returns ONE flat float32 tensor
        on the device, ``[audio rows | audio2 rows | iq_re rows | iq_im
        rows | smeter(C) | peak]``, each tap's subscriber columns
        transposed to (bucket, block) row-major, so that one host fetch
        brings everything a block's listeners need and each channel's
        audio is contiguous for the batched ADPCM encode.  ``peak`` is
        max|x| of the raw block.  Like the reference's fused program,
        this path runs no NaN health check and no subscriber fan-out.

        On the compiled step the result is the bucket's result buffer,
        which the bucket's next block overwrites: :meth:`start_fetch`
        enqueues its copy on the same stream before the next replay, so
        the copy reads this block's result (take it through
        ``start_fetch`` before running another block).
        """
        if self._compiled is None:
            x, taps = self._advance()
            return pack_columns(taps, x, idx)
        ticks, x = self._next_x()
        packed = self._gstep_for(len(idx))(x, idx)
        self.block_ticks = ticks
        self.seq += 1
        return packed

    def _gstep_for(self, bucket: int) -> "ServeProgram":
        """The ONE definition of the fused serve program per bucket size
        (``run_block_gather`` and ``prewarm_gather`` share it, or the
        prewarm would capture a program the serving path never runs)."""
        prog = self._gsteps.get(bucket)
        if prog is None:
            prog = self._gsteps.setdefault(bucket, ServeProgram(
                self._compiled, bucket, self.packed_len(bucket)))
        return prog

    def packed_len(self, bucket: int) -> int:
        """Floats in :meth:`run_block_gather`'s result for one bucket."""
        p = self.params
        return 4 * bucket * p.audio_block + p.num_channels + 1

    def prewarm_gather(self, bucket: int) -> None:
        """Capture the fused serve program for one bucket size (for the
        current gates) off the block loop: safe to call from a thread
        while the loop runs blocks, because it never touches the engine
        state (a warm-up, when one is needed, runs on scratch buffers).
        Meanwhile no thread may synchronize the whole device (see
        :meth:`CompiledRxBlock.prepare`).  The eager engine has nothing
        to prepare: the host buffers were pinned at the largest bucket's
        length when it was made."""
        if self._compiled is not None:
            self._gstep_for(bucket).prepare()

    def start_fetch(self, packed: torch.Tensor) -> "PackedFetch":
        """Begin copying a packed tensor to the host without blocking.

        On the card the copy goes into pinned memory on the current
        stream, followed by an event, so it overlaps whatever is
        enqueued next (the next block).  ``.result()`` of the returned
        handle waits for that event only and gives a 1-D float32 numpy
        array.  The two host buffers are used in turns: a handle's
        result must be taken before the second fetch after it starts.
        """
        buf = self._fetch_bufs[self._fetch_turn][:packed.numel()]
        if buf.numel() != packed.numel():
            raise ValueError(f"{packed.numel()} floats are more than the "
                             "largest bucket's packed length")
        self._fetch_turn ^= 1
        buf.copy_(packed, non_blocking=True)
        event = None
        if packed.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(packed.device))
        return PackedFetch(buf, event)

    def fetch(self, packed: torch.Tensor) -> np.ndarray:
        """The packed tensor on the host (the counterpart of the
        reference server's ``jax.device_get`` of the fused result)."""
        return self.start_fetch(packed).result()

    def reset_streaming_state(self) -> None:
        """Full streaming-state reset (data-pump reset analogue)."""
        self.state = rx.init_state(self.params, self.device)
        self.resets += 1

    # -- checkpoint / resume --------------------------------------------
    # The reference firmware persists only JSON config; like the
    # reference package, the port can also snapshot the full streaming
    # state so a restarted server resumes mid-stream without filter
    # warm-up glitches.
    def save_state(self, path: str) -> None:
        """Snapshot the streaming state (numpy leaves), the sequence
        accounting and the control mirrors."""
        leaves = [t.cpu().numpy()
                  for t in _state_leaves(self._whole_state())]
        with open(path, "wb") as f:
            pickle.dump(dict(leaves=leaves, seq=self.seq,
                             block_ticks=self.block_ticks, ctl=self.ctl), f)

    def _whole_state(self) -> rx.RxState:
        """The streaming state as one ``RxState`` (what a checkpoint
        holds)."""
        return self.state

    def load_state(self, path: str) -> None:
        """Resume from a snapshot that :meth:`save_state` wrote (a
        pickle: load only files this program wrote)."""
        with open(path, "rb") as f:
            snap = pickle.load(f)
        leaves = iter(snap["leaves"])
        self.state = _state_like(
            rx.init_state(self.params, self.device),
            lambda ref: torch.as_tensor(next(leaves), device=self.device))
        self.seq = snap["seq"]
        self.block_ticks = snap["block_ticks"]
        # Rebuild the device tuning from the restored control mirrors.
        # As in the reference, the mirrors keep freq, mode, passband,
        # AGC, squelch, nb_on, the three NR switches and in_use; nb_wild,
        # deemph_on and mute_over_dbm come back at their defaults.  The
        # tuning is built for all channels at once (the reference walks
        # set_channel per channel, which gives the same tensors).
        keep = ("freq_hz", "mode", "passband", "agc_on", "manual_gain_db",
                "squelch", "nb_on", "nr_on", "nr_notch_on", "nr_den_on",
                "in_use")
        self.ctl = [ChannelCtl(**{k: getattr(c, k) for k in keep})
                    for c in snap["ctl"]]
        self.tuning = self._tuning_from_ctl()

    def _tuning_from_ctl(self) -> rx.RxTuning:
        """The tuning that ``set_channel`` calls for every field of every
        control mirror would leave behind."""
        ctl = self.ctl
        t = rx.default_tuning(
            self.params, self.device, freqs_hz=[c.freq_hz for c in ctl],
            modes=[c.mode for c in ctl],
            passbands=[tuple(c.passband or rx._default_passband(c.mode))
                       for c in ctl])

        def col(values, dtype):
            return torch.as_tensor(np.asarray(values, dtype),
                                   device=self.device)
        return rx.with_gates(dataclasses.replace(
            t,
            manual_gain_db=col([np.nan if c.agc_on else c.manual_gain_db
                                for c in ctl], np.float32),
            squelch_thresh=col([c.squelch for c in ctl], np.float32),
            nb_on=col([c.nb_on for c in ctl], bool),
            nb_wild=col([c.nb_wild for c in ctl], bool),
            deemph_on=col([c.deemph_on for c in ctl], bool),
            mute_over_dbm=col([c.mute_over_dbm for c in ctl], np.float32),
            nr_on=col([c.nr_on for c in ctl], bool),
            nr_notch_on=col([c.nr_notch_on for c in ctl], bool),
            nr_den_on=col([c.nr_den_on for c in ctl], bool)))

    # -- timestamps ------------------------------------------------------
    def gps_timestamp(self, clock_hz: float | None = None
                      ) -> tuple[int, float]:
        """(48-bit ticks, seconds) of the current block start; feeds
        the GPS-timestamped IQ headers (`rx/rx_sound.cpp:654-661`)."""
        clk = clock_hz or self.params.adc_clock
        return self.block_ticks, self.block_ticks / clk


def _ready_event(x: torch.Tensor):
    """An event recorded on the current stream of ``x``'s card (None on
    the CPU)."""
    if not x.is_cuda:
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(x.device))
    return event


def pack_columns(taps: rx.RxTaps, x: torch.Tensor,
                 idx: np.ndarray) -> torch.Tensor:
    """The served columns of one block as ONE flat float32 tensor on the
    taps' device: ``[audio rows | audio2 rows | iq_re rows | iq_im rows |
    smeter(C) | peak]``, the channels ``idx`` of each tap transposed to
    (len(idx), block) row-major; ``peak`` is max|x| of the raw block.
    ``idx`` is a host array or an int64 tensor on the taps' device.
    This is :meth:`StreamEngine.run_block_gather`'s result, and what the
    server packs from ``run_block``'s taps for an engine without it."""
    i = idx if isinstance(idx, torch.Tensor) else torch.as_tensor(
        np.asarray(idx), dtype=torch.int64, device=taps.audio.device)
    iq = taps.iq_post_agc.index_select(1, i)
    cols = [a.T.reshape(-1)
            for a in (taps.audio.index_select(1, i),
                      taps.audio2.index_select(1, i), iq.real, iq.imag)]
    return torch.cat(cols + [taps.smeter_dbm, x.abs().max().reshape(1)])


class ServeProgram:
    """The fused serve program of one bucket on a compiled step: the
    block step, then :func:`pack_columns` of the bucket's channels (an
    index buffer) into a result buffer of the packed length."""

    def __init__(self, step: rx.CompiledRxBlock, bucket: int,
                 packed_len: int):
        self.step = step
        self.bucket = bucket
        self.idx = torch.zeros(bucket, dtype=torch.int64, device=step.device)
        self.packed = torch.zeros(packed_len, dtype=torch.float32,
                                  device=step.device)
        self._idx_host = np.zeros(bucket, np.int64)

    def body(self, state: rx.RxState, tuning: rx.RxTuning, x: torch.Tensor,
             idx: torch.Tensor, packed: torch.Tensor) -> None:
        taps = self.step.body(state, tuning, x)
        packed.copy_(pack_columns(taps, x, idx))

    def _live(self, tuning: rx.RxTuning) -> None:
        s = self.step
        self.body(s.state, tuning, s.x, self.idx, self.packed)

    def __call__(self, x: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
        """One served block of ``x`` for channels ``idx``; returns the
        result buffer."""
        idx = np.asarray(idx, np.int64)
        if not np.array_equal(idx, self._idx_host):
            # a new channel set (rare): the one host-to-device copy of a
            # served block, outside the graph
            self.idx.copy_(torch.from_numpy(idx))
            self._idx_host = idx.copy()
        self.step.x.copy_(x)
        self.step.run(("gather", self.bucket), self._live)
        return self.packed

    def prepare(self) -> None:
        """Capture this program without touching the live buffers."""
        s = self.step

        def warm(tuning):
            self.body(rx.init_state(s.params, s.device), tuning,
                      torch.zeros_like(s.x), torch.zeros_like(self.idx),
                      torch.empty_like(self.packed))
        s.prepare(("gather", self.bucket), self._live, warm)


class PackedFetch:
    """A host copy in flight (see :meth:`StreamEngine.start_fetch`)."""

    def __init__(self, buf: torch.Tensor, event):
        self._buf = buf
        self._event = event

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._buf.numpy().copy()


def _state_like(ref, leaf):
    """A state shaped like ``ref`` (nested dataclasses of tensors) whose
    tensors are ``leaf(ref_tensor)``, taken in field order."""
    if isinstance(ref, torch.Tensor):
        return leaf(ref)
    return type(ref)(**{f.name: _state_like(getattr(ref, f.name), leaf)
                        for f in dataclasses.fields(ref)})


def _state_leaves(state) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    _state_like(state, lambda t: out.append(t) or t)
    return out
