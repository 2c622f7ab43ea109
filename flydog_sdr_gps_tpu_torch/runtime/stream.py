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

The control plane (a SET, a GPS clock correction) changes the tuning from
another thread than the step's.  Each change reaches the step in one
ordered piece: the step's thread holds the engine's dispatch lock while
it enqueues a block, and a change is enqueued under the same lock, on the
stream the blocks are enqueued on (:meth:`StreamEngine._hand_over`), so a
block enqueued before it reads the old tuning whole and one enqueued
after it the new.  What a change computes (a retune's bank) is made
before the lock, on the card on a stream of its own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import pickle
import threading
import time
from typing import Callable

import numpy as np
import torch

from ..models import rx_channel as rx
from ..ops import channelizer as chz
from ..ops import demod as demod_ops
from ..ops import fastfir
from ..ops import nco
from ..utils.trace import get_trace
from .source import ThreadedSource


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
        # held while a block is enqueued, and while a control-plane change
        # is (_hand_over); on a card the blocks are enqueued on the stream
        # current here, and what a change builds is built on a stream of
        # its own
        self._dispatch = threading.Lock()
        card = self.device.type == "cuda"
        self._step_stream = (torch.cuda.current_stream(self.device)
                             if card else None)
        self._tune_stream = torch.cuda.Stream(self.device) if card else None
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
        self._stage = block_stage(source, self.device)
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
        if card:
            # a retune's path made ready here, off the block loop: its
            # kernels' first loads and its memory on the tuning stream
            self._on_tune_stream(lambda: chz.build_filterbank_device(
                params.ddc, np.zeros(params.num_channels, np.int64),
                self.device))
            self._tune_stream.synchronize()

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
        """Handed to the step whole (:meth:`_hand_over`), after what the
        caller's stream has queued (``value`` was made there)."""
        self._hand_over(functools.partial(self._put_tuning, value))

    def _put_tuning(self, value: rx.RxTuning) -> None:
        """Make ``value`` the step's tuning (under the dispatch lock)."""
        if self._compiled is None:
            self._tuning = value
            return
        step = self._compiled
        rx.copy_into(step.tuning, value)
        # the same buffers under the new gates
        step.tuning = dataclasses.replace(
            step.tuning, **{f: getattr(value, f) for f in rx.GATE_FIELDS})

    def _on_tune_stream(self, build: Callable[[], object]):
        """``build()``, and an event after it: on a card run on the
        engine's tuning stream, off the step's, so that the step keeps
        its stream while a retune's bank is made; on the CPU run here
        (the event is None)."""
        if self._tune_stream is None:
            return build(), None
        with torch.cuda.stream(self._tune_stream):
            out = build()
            ready = torch.cuda.Event()
            ready.record(self._tune_stream)
        return out, ready

    def _hand_over(self, apply: Callable[[], None], ready=None,
                   made: tuple = (), span: str | None = None,
                   block: int = -1, detail=None) -> None:
        """Enqueue ``apply()`` (the copies of a control-plane change into
        the step's tuning, or its rebinding) under the dispatch lock, on
        the stream the blocks are enqueued on, after the event ``ready``
        (the change's build; None: after what the caller's stream has
        queued).  A block enqueued before reads the old tuning whole, one
        after the new.  ``made``: tensors of the build that ``apply``
        reads, kept from reuse until the step's stream is past them.  The
        lock is held for the enqueue alone; ``span`` names its span."""
        step = self._step_stream
        caller = (torch.cuda.current_stream(self.device) if step is not None
                  else None)
        with self._dispatch:
            t0 = time.monotonic_ns()
            if step is None:
                apply()
            else:
                with torch.cuda.stream(step):
                    if ready is not None:
                        step.wait_event(ready)
                    elif caller != step:
                        step.wait_stream(caller)
                    for t in made:
                        t.record_stream(step)
                    apply()
            if span is not None:
                get_trace().span(span, block, t0, detail=detail)

    # -- control plane ---------------------------------------------------
    def set_channel(self, ch: int, **kwargs) -> None:
        """Apply "SET"-style changes (freq/mode/passband/agc/...).  The
        channel's column of each changed tuning field (its bank column
        and word on a retune) reaches the step in one piece, as
        :meth:`retune_all`'s bank does (span ``engine.retune_apply``,
        detail ``"set_channel"``); the gates follow in a second piece."""
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
        cols: dict[str, object] = {}        # field -> channel ch's value
        if retune:
            fcw = nco.freq_to_fcw(ctl.freq_hz, self.params.adc_clock)
            cols["bank"], cols["dphi1"] = chz.build_filterbank_column(
                self.params.ddc, fcw)
        if recoef:
            pb = ctl.passband or rx._default_passband(ctl.mode)
            cols["pb_coef"] = fastfir.passband_freq_coef(
                self.params.fs_out, pb[0], pb[1], plan=self.params.fir)
            cols["mode"] = ctl.mode
        # scalar per-channel knobs
        cols.update(
            manual_gain_db=np.nan if ctl.agc_on else ctl.manual_gain_db,
            squelch_thresh=ctl.squelch, nb_on=ctl.nb_on,
            nb_wild=ctl.nb_wild, deemph_on=ctl.deemph_on,
            mute_over_dbm=ctl.mute_over_dbm, nr_on=ctl.nr_on,
            nr_notch_on=ctl.nr_notch_on, nr_den_on=ctl.nr_den_on)
        t = self.tuning                 # updated in place
        staged, ready = self._on_tune_stream(lambda: {
            f: torch.as_tensor(np.asarray(v), dtype=getattr(t, f).dtype,
                               device=self.device) for f, v in cols.items()})

        def apply():
            for f, v in staged.items():
                getattr(t, f)[..., ch].copy_(v)
        self._hand_over(apply, ready, tuple(staged.values()),
                        "engine.retune_apply", self.seq, "set_channel")
        # the gates read back after the writes, on the blocks' stream
        with (torch.cuda.stream(self._step_stream)
              if self._step_stream is not None
              else contextlib.nullcontext()):
            gated = rx.with_gates(t)
        self.tuning = gated

    def retune_all(self, adc_clock_corrected: float) -> None:
        """Clock-discipline feedback: rebuild every NCO against the
        corrected ADC clock (`rx/rx_sound.cpp:334-344`).  Only the tuning
        words change; the decimation plan stays at nominal.

        The words are made on the host, the stage-1 bank from them on the
        engine's device (:func:`..ops.channelizer.build_filterbank_device`,
        on a card on the engine's tuning stream), and the new ``(bank,
        dphi1)`` reach the step in one piece (:meth:`_hand_over`): when
        this returns, every block enqueued later reads them and every
        block enqueued before read the old pair.  Spans: ``engine.retune``
        (this call on the caller's thread) and ``engine.retune_apply``
        (the enqueue under the lock), numbered by ``seq`` at entry."""
        seq, t0 = self.seq, time.monotonic_ns()
        fcws = nco.freqs_to_fcws([c.freq_hz for c in self.ctl],
                                 adc_clock_corrected)
        (bank, dphi), ready = self._on_tune_stream(
            lambda: chz.build_filterbank_device(self.params.ddc, fcws,
                                                self.device))
        self._hand_over(
            lambda: self._put_tuning(dataclasses.replace(
                self.tuning, bank=bank, dphi1=dphi)),
            ready, (bank, dphi), "engine.retune_apply", seq)
        get_trace().span("engine.retune", seq, t0)

    # -- data plane ------------------------------------------------------
    def _next_x(self) -> tuple[int, torch.Tensor]:
        """The source's tick and next block on the device.  The block is
        kept as ``_last_x`` (the waterfall's input), and on a card
        ``_x_ready`` is an event recorded just after it was made (before
        the step), which a consumer on another stream waits on.

        A staged block (:class:`..runtime.source.BlockStage`) is already
        on the card or being copied there: the current stream waits for
        its copy, and the step's thread waits only while the block is
        not yet staged (the span ``engine.stage_wait``).  Its buffer is
        overwritten once the block after next is taken.  Otherwise a host
        block's copy to the device is the span ``engine.h2d`` (host time:
        a copy from pageable memory returns once the stream reached it
        and the copy is done).  A compiled source's block is its output
        buffer, which its next block overwrites.  A consumer that keeps a
        block longer copies it (``WfSubsystem.ingest`` does, and makes the
        caller's stream wait for its copy)."""
        if self._stage is not None:
            ticks, x = self._stage.take(self.seq)
        else:
            ticks = getattr(self.source, "ticks", 0)
            x = self.source.next_block(self.params.ddc.adc_block)
            if isinstance(x, np.ndarray):
                t0 = time.monotonic_ns()
                x = torch.from_numpy(x).to(self.device)
                get_trace().span("engine.h2d", self.seq, t0)
        self._last_x = x            # raw block for waterfall taps
        self._x_ready = _ready_event(x)
        return ticks, x

    def _advance(self) -> tuple[torch.Tensor, rx.RxTaps]:
        """One source block through the block program."""
        ticks, x = self._next_x()
        with self._dispatch:
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
        prog = self._gstep_for(len(idx))
        prog.select(idx)
        with self._dispatch:
            packed = prog(x)
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


def block_stage(source, device: torch.device):
    """The staging of ``source``'s blocks onto ``device`` ahead of the
    step, where it pays: a threaded host source feeding a card.  None
    for any other source (a compiled one makes its block on the card)
    and for a CPU engine: the block is then taken on the step's
    thread."""
    if device.type == "cuda" and isinstance(source, ThreadedSource):
        return source.stage(device)
    return None


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
    This is :meth:`StreamEngine.run_block_gather`'s result."""
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

    def select(self, idx: np.ndarray) -> None:
        """Serve channels ``idx`` from the next block on."""
        idx = np.asarray(idx, np.int64)
        if not np.array_equal(idx, self._idx_host):
            # a new channel set (rare): the one host-to-device copy of a
            # served block, outside the graph
            self.idx.copy_(torch.from_numpy(idx))
            self._idx_host = idx.copy()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """One served block of ``x`` for the selected channels; returns
        the result buffer."""
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
