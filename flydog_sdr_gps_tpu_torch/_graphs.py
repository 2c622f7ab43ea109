"""Programs captured as CUDA graphs over buffers their owner keeps.

The port's counterpart of ``jax.jit``: a program is a Python function
that reads and writes only tensors its owner made once (its input,
state and output buffers), so that a CUDA graph of it stays valid for
as long as the owner lives.  :class:`GraphSet` keeps one graph per key
(a tuple: the program's name and whatever chose its Python branches, as
a jitted function is kept per static argument), all in one memory pool,
and captures them on a stream of its own:

- the first run of a key runs eagerly on the live buffers: it is the
  real work, and the warm-up that makes cuBLAS handles and cuFFT plans,
  which must exist before a capture; the key is then captured
  (``thread_local`` mode, so other threads go on launching), and later
  runs replay it on the caller's current stream;
- :meth:`GraphSet.prepare` captures a key ahead of time, off the caller's
  loop, warming on scratch buffers when needed;
- a capture that fails raises, and that key never runs again (no eager
  run in its place);
- the wrappers' launch counters stay true: a capture records each
  wrapper's launches (``_build.recording``) and every replay credits
  them (``_build.credit``);
- on the CPU, or when the owner asks for no capture (``enabled=False``,
  the eager twin the card's tests hold a capture to), a run is the
  program's body, with nothing captured;
- each key's eager first run (or :meth:`GraphSet.prepare`'s warm-up) and
  its capture are the tracer's spans ``graphs.first_run`` and
  ``graphs.capture``, with the key as their detail (host time; nothing
  is recorded where nothing is captured).

Graphs of one set share its pool, so they must run in stream order (one
at a time): an owner whose programs run on two streams keeps a set for
each.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Iterable

import torch

from . import _build
from .utils.trace import get_trace


def copy_into(dst, src) -> None:
    """Copy each tensor of ``src`` into the same field of ``dst`` (a
    tensor or nested dataclasses of tensors; fields that are not tensors
    are left alone): how a control-plane change reaches a program's
    buffers.  Shapes and dtypes must agree; a field whose tensor already
    is ``dst``'s is skipped."""
    if isinstance(dst, torch.Tensor):
        if src is dst:
            return
        if not isinstance(src, torch.Tensor) or src.shape != dst.shape \
                or src.dtype != dst.dtype:
            raise ValueError(
                f"cannot copy {getattr(src, 'dtype', type(src))} "
                f"{tuple(getattr(src, 'shape', ()))} into a {dst.dtype} "
                f"{tuple(dst.shape)} buffer")
        dst.copy_(src)
        return
    for f in dataclasses.fields(dst):
        d = getattr(dst, f.name)
        if isinstance(d, torch.Tensor) or dataclasses.is_dataclass(d):
            copy_into(d, getattr(src, f.name))


class Graph:
    """One captured program: its CUDA graph and the launches each wrapper
    made during the capture (credited at every replay, so a replayed
    program counts as an eager one does).  The capture's wall time is
    the tracer's span ``graphs.capture``."""

    def __init__(self, graph, launches: dict):
        self.graph = graph
        self.launches = launches

    def replay(self) -> None:
        self.graph.replay()
        _build.credit(self.launches)


def _warm_blas(device: torch.device) -> None:
    """One tiny float32 matmul on this thread's current stream: it makes
    the thread's cuBLAS handle and that stream's workspace, which must
    not be made inside a capture."""
    a = torch.zeros((8, 8), dtype=torch.float32, device=device)
    torch.matmul(a, a)


class GraphSet:
    """The graphs of one owner's programs on one device (see the module
    docstring).  ``generators``: the ``torch.Generator``s the programs
    draw from, registered with every graph so that each replay draws the
    numbers an eager run would at the generator's state.  ``enabled``
    False: never capture, run the bodies (on a card too)."""

    def __init__(self, device: torch.device | str,
                 generators: Iterable[torch.Generator] = (),
                 enabled: bool = True):
        self.device = torch.device(device)
        self.enabled = enabled
        self.graphs: dict[tuple, Graph] = {}
        # launches of the warm-ups :meth:`prepare` ran on scratch buffers
        # (real launches, counted as such; {wrapper: n})
        self.warmup_launches: dict = {}
        self.generators = tuple(generators)
        self._warm: set = set()             # warm keys run eagerly here
        self._failed: dict[tuple, str] = {}  # keys whose capture failed
        self._lock = threading.Lock()       # one capture at a time
        self.stream = None
        if self.captures:
            self._pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)

    @property
    def captures(self) -> bool:
        """Whether runs are captured (on a card) or just run (the CPU, or
        not ``enabled``)."""
        return self.enabled and self.device.type == "cuda"

    def _refuse_failed(self, key: tuple) -> None:
        if key in self._failed:             # no eager run in its place
            raise RuntimeError(f"the capture of {key} failed: "
                               f"{self._failed[key]}")

    def run(self, key: tuple, fn: Callable[[], object],
            warm_key=None) -> None:
        """Run program ``key`` whose body over the live buffers is
        ``fn()``: replay its graph, or (the key's first run) run it
        eagerly and capture it.  ``warm_key`` names what the eager run
        warmed (cuBLAS, cuFFT plans) for :meth:`prepare`; by default the
        key itself."""
        if not self.captures:
            fn()
            return
        graph = self.graphs.get(key)
        if graph is None:
            self._refuse_failed(key)
            with self._lock:
                graph = self.graphs.get(key)
                if graph is None:
                    t0 = time.monotonic_ns()
                    fn()                    # this run, and the warm-up
                    get_trace().span("graphs.first_run", -1, t0, detail=key)
                    self._warm.add(key if warm_key is None else warm_key)
                    self._capture(key, fn)
                    return
        graph.replay()

    def prepare(self, key: tuple, fn: Callable[[], object],
                warm: Callable[[], object], warm_key=None) -> None:
        """Capture ``key`` off the caller's loop (from any thread, beside
        replays on another).  ``fn`` is as for :meth:`run`; ``warm()``
        runs the same program eagerly on scratch buffers, and runs only
        when ``warm_key`` has not yet run here: the live buffers are
        never touched.

        While it captures, no other thread may synchronize the whole
        device (``torch.cuda.synchronize()``, ``empty_cache()``): CUDA
        refuses a wait on a capturing stream, and the capture fails.
        Wait on a stream or an event instead."""
        if not self.captures:
            return
        warm_key = key if warm_key is None else warm_key
        with self._lock:
            if key in self.graphs:
                return
            self._refuse_failed(key)
            if warm_key not in self._warm:
                t0 = time.monotonic_ns()
                with torch.cuda.stream(self.stream), \
                        _build.recording() as launches:
                    warm()
                get_trace().span("graphs.first_run", -1, t0, detail=key)
                _build.credit(launches)
                for wrapper, n in launches.items():
                    self.warmup_launches[wrapper] = \
                        self.warmup_launches.get(wrapper, 0) + n
                self.stream.synchronize()
                self._warm.add(warm_key)
            self._capture(key, fn)

    def _capture(self, key: tuple, fn: Callable[[], object]) -> None:
        """Record ``fn`` in a CUDA graph on the set's own stream, in this
        thread's capture mode only, into the set's memory pool."""
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        t0 = time.monotonic_ns()
        # the capture begins after what the caller's stream has queued
        # (the key's eager run): a capture that overlapped that run on
        # the card corrupted its output (a compiled scene source's first
        # block, in 2 of 4 runs)
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            _warm_blas(self.device)
            with _build.recording() as launches:
                graph.capture_begin(pool=self._pool,
                                    capture_error_mode="thread_local")
                recorded = False
                try:
                    fn()
                    recorded = True
                    graph.capture_end()
                except BaseException as e:
                    self._failed[key] = repr(e)
                    if not recorded:        # end the broken capture
                        try:
                            graph.capture_end()
                        except Exception:   # noqa: BLE001 — the first
                            pass            # error is the one to raise
                    raise
        get_trace().span("graphs.capture", -1, t0, detail=key)
        self.graphs[key] = Graph(graph, dict(launches))
