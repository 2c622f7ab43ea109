"""The multi-device engine: :class:`StreamEngine` over a device mesh.

Port of :mod:`flydog_sdr_gps_tpu.runtime.sharded_stream`.  The step is
:func:`..parallel.make_sharded_rx_step`: the 125 Msps front half split
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
from .stream import StreamEngine


class ShardedStreamEngine(StreamEngine):
    """``StreamEngine`` whose step runs split over a (time, chan) mesh."""

    # the server's fused serving path belongs to the single-device step;
    # with this engine it packs the columns from run_block's taps
    run_block_gather = None

    def __init__(self, params: rx.RxParams, source, mesh=None,
                 time: int | None = None, chan: int | None = None):
        if mesh is None:
            mesh = distributed.make_global_mesh(time=time, chan=chan)
        self.mesh = mesh
        # the eager step, as the reference's passes use_jit=False: the
        # mesh step has no compiled program yet
        super().__init__(params, source,
                         device=mesh.device(mesh.local_rows[0], 0),
                         use_graphs=False)
        self._step = parallel.make_sharded_rx_step(params, mesh)
        self.state = parallel.shard_rx_state(self.state, mesh, params)

    # -- control plane ---------------------------------------------------
    @property
    def tuning(self) -> rx.RxTuning:
        """The whole tuning; setting it re-shards it over the mesh."""
        return self._tuning

    @tuning.setter
    def tuning(self, value: rx.RxTuning) -> None:
        self._tuning = value
        self.sharded_tuning = parallel.shard_rx_tuning(value, self.mesh)

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
        self.state, taps = self._step(
            self.state, self.sharded_tuning,
            distributed.host_shard_block(self.mesh, x))
        taps = parallel.gather_taps(taps, self.mesh, self.device)
        self.block_ticks = ticks
        self.seq += 1
        if self.seq % 64 == 0:          # cheap periodic health check
            if not bool(torch.isfinite(taps.audio).all()):
                self.reset_streaming_state()
        for fn in self.subscribers:
            fn(self, taps)
        return taps

    def reset_streaming_state(self) -> None:
        self.state = parallel.shard_rx_state(
            rx.init_state(self.params, self.device), self.mesh, self.params)
        self.resets += 1

    # -- checkpoint / resume ----------------------------------------------
    def _whole_state(self) -> rx.RxState:
        return parallel.gather_rx_state(self.state, self.mesh, self.device)

    def load_state(self, path: str) -> None:
        super().load_state(path)
        self.state = parallel.shard_rx_state(self.state, self.mesh,
                                             self.params)

    def scaling_report(self, iters: int = 4) -> dict:
        """Wall time a step on this mesh, on a zero block and a fresh
        state chain (the live state is not touched)."""
        x = distributed.host_shard_block(self.mesh, torch.zeros(
            self.params.ddc.adc_block // self.mesh.num_processes,
            dtype=torch.float32, device=self.device))
        chain = {"state": parallel.shard_rx_state(
            rx.init_state(self.params, self.device), self.mesh,
            self.params)}

        def step():
            chain["state"], _ = self._step(chain["state"],
                                           self.sharded_tuning, x)
        rep = distributed.scaling_report(self.mesh, step, (), iters=iters)
        rep["channels"] = self.params.num_channels
        return rep
