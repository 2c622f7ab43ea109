"""GPS receiver service: runs the GPS subsystem inside the live server.

The port's copy of :mod:`flydog_sdr_gps_tpu.runtime.gps_service`, with
two additions: ``errors`` counts the chunks the loop caught an exception
on, so that a caller can tell a logged failure from a quiet run; and a
manager on the card runs its device work (the scene, acquisition, the
tracking kernel and their fetches) on a CUDA stream of its own, so the
receiver's block program, on the default stream, never queues behind
it and the GPS fetches wait for GPS work only.

Reference: `gps_main()` (`gps/gps.cpp:40`) creates SearchTask, 12
ChanTasks and SolveTask on the coroutine scheduler; solutions feed
`clock_correction()` (`init/clk.cpp:117-275`) whose corrected ADC
clock retunes every DDC NCO (`rx/rx_sound.cpp:334-344`).

Here one asyncio task drives the whole loop: IF chunks stream through
`GpsManager.process` (acquisition + the batched tracking kernel run on
device, in an executor so the event loop stays live), solutions run on
a fixed IF-time cadence, and clock corrections call back into the
`StreamEngine` on the event-loop thread (serializing control-plane
mutations with the websocket SET handlers).

Spans (the tracer's), numbered by the chunk's index (``chunks`` before
it was counted): ``gps.chunk``, one chunk's ``mgr.process`` (detail
``"search"`` when a search ran in it); ``gps.solve``, one solve after
it; ``gps.correction``, :meth:`GpsReceiver._apply_clock` after a fix,
with its outcome as detail: ``"applied"`` (the engine retuned),
``"gated"`` (the recent estimates spread too far), ``"small"`` (under
``min_clock_change_ppm`` from the clock in use) or ``"unlocked"`` (the
clock discipline is not locked yet).
"""

from __future__ import annotations

import asyncio
import time

import torch

from ..utils.log import lprintf
from ..utils.trace import get_trace


class GpsReceiver:
    """Owns a GPS IF source + GpsManager and runs them as a service."""

    def __init__(self, source, manager, engine=None,
                 chunk_seconds: float = 0.1,
                 solve_interval: float = 2.0,
                 search_interval: float = 20.0,
                 assist_ephemerides=None,
                 min_clock_change_ppm: float = 0.005,
                 realtime: bool = False):
        self.source = source
        self.mgr = manager
        self.engine = engine
        self.chunk = int(round(chunk_seconds * manager.tp.fs))
        self.solve_interval = solve_interval
        self.search_interval = search_interval
        self.assist = assist_ephemerides
        self.min_change = min_clock_change_ppm
        self.realtime = realtime
        self.retunes = 0
        self.errors = 0                 # chunks that raised (logged)
        self.chunks = 0                 # chunks processed
        self.adc_clock_corrected = manager.adc_clock_nom
        self._next_solve = solve_interval
        self._next_search = 0.0
        self._stop = asyncio.Event()
        dev = getattr(manager, "device", None)
        self._stream = (torch.cuda.Stream(dev)
                        if dev is not None and dev.type == "cuda" else None)

    def _on_stream(self, fn, *args):
        """``fn(*args)`` with the receiver's stream current (the current
        stream is per thread: this runs in the executor's)."""
        if self._stream is None:
            return fn(*args)
        with torch.cuda.stream(self._stream):
            return fn(*args)

    # -- the service loop --------------------------------------------------
    async def run(self) -> None:
        loop = asyncio.get_running_loop()
        if self._stream is not None:
            # what was queued before (the manager's state, the scene's
            # tables) is done before the receiver's stream reads it
            self._stream.wait_stream(
                torch.cuda.current_stream(self._stream.device))
        period = self.chunk / self.mgr.tp.fs
        next_t = time.monotonic()
        while not self._stop.is_set():
            t_if = self.mgr.ticks / self.mgr.tp.fs
            search = (t_if >= self._next_search
                      and len(self.mgr.channels) < self.mgr.max_chans)
            if search:
                self._next_search = t_if + self.search_interval
            k = self.chunks
            try:
                raw = await loop.run_in_executor(
                    None, self._on_stream, self.source.next_block,
                    self.chunk)
                await loop.run_in_executor(
                    None, self._on_stream, self._process, raw, search, k)
            except Exception as e:      # noqa: BLE001 — keep serving
                self.errors += 1
                lprintf("gps service error: %s", e)
                await asyncio.sleep(0.5)
                continue
            self.chunks += 1
            if search:
                lprintf("GPS search: tracking %s",
                        sorted(self.mgr.channels))
            t_if = self.mgr.ticks / self.mgr.tp.fs
            if t_if >= self._next_solve:
                self._next_solve = t_if + self.solve_interval
                fix = await loop.run_in_executor(None, self._solve, k)
                if fix is not None:
                    self._apply_clock(k)
            if self.realtime:
                next_t += period
                delay = next_t - time.monotonic()
                if delay > 0:
                    await asyncio.sleep(delay)
                else:
                    next_t = time.monotonic()
            else:
                await asyncio.sleep(0)

    def _process(self, raw, search: bool, k: int) -> None:
        """``mgr.process`` of chunk ``k`` (span ``gps.chunk``)."""
        t0, searches = time.monotonic_ns(), self.mgr.searches
        self.mgr.process(raw, search)
        get_trace().span("gps.chunk", k, t0, detail=(
            "search" if self.mgr.searches != searches else None))

    def _solve(self, k: int):
        """One solve after chunk ``k`` (span ``gps.solve``)."""
        t0 = time.monotonic_ns()
        try:
            return self.mgr.solve(self.assist)
        finally:
            get_trace().span("gps.solve", k, t0)

    def _apply_clock(self, chunk: int = -1) -> None:
        """Clock-discipline feedback on the event-loop thread (no race
        with SET-command tuning edits); span ``gps.correction`` of
        ``chunk``, its outcome as detail."""
        t0 = time.monotonic_ns()
        outcome = self._correct_clock()
        get_trace().span("gps.correction", chunk, t0, detail=outcome)

    def _correct_clock(self) -> str:
        if not self.mgr.clock.locked:
            return "unlocked"
        clk = self.mgr.adc_clock()
        # stability gate (the reference's MMA + outlier window serves
        # the same purpose, `init/clk.cpp:205-263`): only retune on a
        # SETTLED estimate.  A wandering estimate (e.g. the long-run
        # drift noted in PARITY.md) would otherwise retune every few
        # seconds and smear every narrowband decoder mid-capture.
        self._clk_hist = (getattr(self, "_clk_hist", []) + [clk])[-6:]
        if len(self._clk_hist) >= 4:
            spread_ppm = ((max(self._clk_hist) - min(self._clk_hist))
                          / clk * 1e6)
            if spread_ppm > 0.05:
                return "gated"
        dppm = abs(clk - self.adc_clock_corrected) / clk * 1e6
        if dppm < self.min_change:
            return "small"
        self.adc_clock_corrected = clk
        if self.engine is not None:
            self.engine.retune_all(clk)
            self.retunes += 1
            lprintf("GPS clock correction: %.3f Hz (%+.3f ppm), "
                    "retuned %d channels", clk,
                    (clk / self.mgr.adc_clock_nom - 1) * 1e6,
                    self.engine.params.num_channels)
        return "applied"

    def stop(self) -> None:
        self._stop.set()

    # -- status -----------------------------------------------------------
    def status(self) -> dict:
        st = self.mgr.status()
        st["retunes"] = self.retunes
        st["adc_clock_corrected"] = self.adc_clock_corrected
        return st
