"""The (time, chan) device mesh.

Port of :mod:`flydog_sdr_gps_tpu.parallel.mesh`.  The reference builds a
``jax.sharding.Mesh``; here a mesh is a plain grid of ``torch.device``s
that the sharded step (:mod:`.sharded_rx`) drives from one process.  A
device may appear more than once: ``["cpu"] * 8`` is the CPU test mesh
(the reference's eight virtual CPU devices), and ``[cuda:0] * 4`` runs
every shard, halo and re-shard of a (2, 2) mesh on one card.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (time, chan) grid of devices.

    ``devices[t][k]`` is the device of time shard t and channel shard k.
    Across processes (:mod:`.distributed`) each time row belongs to one
    process: ``row_process[t]`` is its rank, and ``process_index`` is this
    process's; a row of another process names that process's devices.
    """
    devices: tuple[tuple[torch.device, ...], ...]
    row_process: tuple[int, ...] = ()
    process_index: int = 0

    def __post_init__(self):
        if not self.row_process:
            object.__setattr__(self, "row_process", (0,) * len(self.devices))

    @property
    def shape(self) -> dict[str, int]:
        return {"time": len(self.devices), "chan": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    def device(self, t: int, k: int) -> torch.device:
        return self.devices[t][k]

    @property
    def num_processes(self) -> int:
        return max(self.row_process) + 1

    def is_local(self, t: int) -> bool:
        """Whether time row t runs in this process."""
        return self.row_process[t] == self.process_index

    @property
    def local_rows(self) -> list[int]:
        return [t for t in range(len(self.devices)) if self.is_local(t)]


def _cuda_devices() -> list[torch.device]:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "make_mesh: no CUDA device found; pass devices=['cpu'] * n for "
            "a mesh of CPU devices")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(time: int = 1, chan: int | None = None, devices=None) -> Mesh:
    """Build a (time, chan) mesh over ``devices`` (default: every CUDA
    device; without one this raises, it never falls back to the CPU).

    ``time`` shards ADC blocks in time (the halo-exchange front half);
    ``chan`` shards the DDC channel axis, by default every device left.
    """
    devs = _cuda_devices() if devices is None else \
        [torch.device(d) for d in devices]
    n = len(devs)
    if chan is None:
        chan = n // time
    if time * chan != n:
        raise ValueError(f"time*chan = {time}*{chan} != {n} devices")
    return Mesh(tuple(tuple(devs[t * chan:(t + 1) * chan])
                      for t in range(time)))


def mesh_shape(mesh: Mesh) -> tuple[int, int]:
    return mesh.shape["time"], mesh.shape["chan"]
