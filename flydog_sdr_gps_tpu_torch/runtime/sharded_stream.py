"""The multi-device engine: :class:`StreamEngine` over a device mesh.

Port of :mod:`flydog_sdr_gps_tpu.runtime.sharded_stream`.  The step is
:class:`..parallel.ShardedProgram`: the 125 Msps front half split
in time with halo exchange of the filter tails, the audio-rate back half
re-sharded over every device.  It is a drop-in ``StreamEngine``: the
server's block loop, the control plane ("SET" -> :meth:`set_channel`),
the GPS clock feedback (:meth:`retune_all`) and checkpoints work
unchanged.  What differs:

- the state and the per-device tuning live split over the mesh; the
  engine also keeps the whole tuning on the mesh's first device, which
  the control plane edits: every assignment of ``tuning`` (a SET,
  ``retune_all``, a restored checkpoint, ``convert.load_ctl``) re-shards
  it, so the mesh never runs on a stale tuning;
- :meth:`run_block` places each block over the mesh's time rows and
  returns whole-C taps on the first device;
- there is no fused step-and-gather (``run_block_gather = None``); the
  server packs the same columns from ``run_block``'s taps;
- a checkpoint is the single-device engine's format in the unfused
  representation (stage-1 tail rotated): it loads into a
  ``StreamEngine`` with ``RxParams(stage2="unfused")``, and such an
  engine's checkpoint loads here.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import parallel
from ..models import rx_channel as rx
from ..parallel import distributed
from .stream import StreamEngine, _ready_event


class ShardedStreamEngine(StreamEngine):
    """``StreamEngine`` whose step runs split over a (time, chan) mesh."""

    # the server's fused serving path belongs to the single-device step;
    # with this engine it packs the columns from run_block's taps
    run_block_gather = None

    def __init__(self, params: rx.RxParams, source, mesh=None,
                 time: int | None = None, chan: int | None = None,
                 use_graphs: bool | None = None):
        """``use_graphs``: capture the mesh step's programs
        (:class:`..parallel.ShardedProgram`) as CUDA graphs, by default
        on cards; ``False``, and the CPU, run the same bodies with
        nothing captured."""
        if mesh is None:
            mesh = distributed.make_global_mesh(time=time, chan=chan)
        self.mesh = mesh
        dev = mesh.device(mesh.local_rows[0], 0)
        if use_graphs is None:
            use_graphs = dev.type == "cuda"
        self._program = parallel.ShardedProgram(
            params, mesh,
            parallel.shard_rx_state(rx.init_state(params, dev), mesh, params),
            parallel.shard_rx_tuning(rx.default_tuning(params, dev), mesh),
            use_graphs=use_graphs)
        # the single-device step is never built: the mesh step replaces
        # it; the base's state and tuning assignments copy into the
        # program's buffers
        super().__init__(params, source, device=dev, use_graphs=False)

    @property
    def program(self) -> "parallel.ShardedProgram":
        """The mesh step (its graphs and buffers)."""
        return self._program

    # -- the state and tuning: the program's own buffers ------------------
    @property
    def state(self) -> "parallel.ShardedRxState":
        """The streaming state split over the mesh; assigning (a whole
        ``RxState`` is sharded first) copies into the buffers."""
        return self._program.state

    @state.setter
    def state(self, value) -> None:
        if isinstance(value, rx.RxState):
            value = parallel.shard_rx_state(value, self.mesh, self.params)
        self._program.load_state(value)

    @property
    def tuning(self) -> rx.RxTuning:
        """The whole tuning; setting it re-shards it over the mesh, into
        the program's shard buffers, with each shard's gates."""
        return self._tuning

    @tuning.setter
    def tuning(self, value: rx.RxTuning) -> None:
        self._tuning = value
        self._program.load_tuning(parallel.shard_rx_tuning(value, self.mesh))

    @property
    def sharded_tuning(self) -> "parallel.ShardedRxTuning":
        return self._program.tuning

    # -- data plane ------------------------------------------------------
    def run_block(self) -> rx.RxTaps:
        """One source block over the mesh (this process's time rows of
        it when several processes share the mesh); whole-C taps on the
        first device; fan out."""
        ticks = getattr(self.source, "ticks", 0)
        x = self.source.next_block(self.params.ddc.adc_block
                                   // self.mesh.num_processes)
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        x = x.to(self.device)
        self._last_x = x            # raw block for waterfall taps
        self._x_ready = _ready_event(x)
        taps = self._program(x)
        taps = parallel.gather_taps(taps, self.mesh, self.device)
        self.block_ticks = ticks
        self.seq += 1
        if self.seq % 64 == 0:          # cheap periodic health check
            if not bool(torch.isfinite(taps.audio).all()):
                self.reset_streaming_state()
        for fn in self.subscribers:
            fn(self, taps)
        return taps

    # -- checkpoint / resume ----------------------------------------------
    def _whole_state(self) -> rx.RxState:
        return parallel.gather_rx_state(self.state, self.mesh, self.device)

    def scaling_report(self, iters: int = 4) -> dict:
        """Wall time a step on this mesh, on a zero block and a program of
        its own from a fresh state (the live state is not touched)."""
        x = torch.zeros(self.params.ddc.adc_block // self.mesh.num_processes,
                        dtype=torch.float32, device=self.device)
        prog = parallel.ShardedProgram(
            self.params, self.mesh, parallel.shard_rx_state(
                rx.init_state(self.params, self.device), self.mesh,
                self.params),
            parallel.shard_rx_tuning(self.tuning, self.mesh),
            use_graphs=False)
        rep = distributed.scaling_report(self.mesh, lambda: prog(x), (),
                                         iters=iters)
        rep["channels"] = self.params.num_channels
        return rep
