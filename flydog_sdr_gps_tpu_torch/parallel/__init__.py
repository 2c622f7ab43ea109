"""Device-mesh parallelism for the receiver.

Port of :mod:`flydog_sdr_gps_tpu.parallel`: a (time, chan) mesh of
devices driven by one process (:mod:`.mesh`), the sharded receiver step
with its halo exchange (:mod:`.sharded_rx`) and the multi-process glue
(:mod:`.distributed`).

- **channel parallelism**: the channel axis of the filter bank and of
  every per-channel state is split over the mesh; no exchange in steady
  state.
- **time parallelism** (the 125 Msps front half): each ADC block is
  split in time; the filter-history halos (stage-1 input tail, stage-2
  tail) pass from each time shard to the next.
- the audio-rate back half re-shards channels over ALL devices (a
  gather over time, then each device's channel group).
"""

from .mesh import Mesh, make_mesh, mesh_shape
from .sharded_rx import (ShardedProgram, ShardedRxState, ShardedRxTuning,
                         gather_rx_state, gather_taps, make_sharded_rx_step,
                         shard_rx_state, shard_rx_tuning)

__all__ = ["Mesh", "ShardedProgram", "ShardedRxState", "ShardedRxTuning",
           "gather_rx_state",
           "gather_taps", "make_mesh", "make_sharded_rx_step", "mesh_shape",
           "shard_rx_state", "shard_rx_tuning"]
