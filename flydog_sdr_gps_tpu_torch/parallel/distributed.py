"""Multi-process deployment glue.

Port of :mod:`flydog_sdr_gps_tpu.parallel.distributed`.  The reference
runs ``jax.distributed`` over hosts; here each process joins a
``torch.distributed`` group (NCCL between cards, gloo on the CPU) and
drives the mesh rows of its own devices:

- the mesh is laid out process-major, so that only the TIME axis crosses
  processes: its halos (``tail1`` raw samples, ``tail2`` stage-1 outputs
  per channel shard) are ``send``/``recv``, the gather over time is
  ``all_gather``, and the DDC carries come from the last process.  The
  channel axis stays inside each process; a split that would carry it
  across processes is refused.
- each process feeds only its own time rows of the ADC stream
  (:func:`host_shard_block`).

Single-process meshes take the same code with a process count of 1.
"""

from __future__ import annotations

import time as _time

import numpy as np
import torch

from .mesh import Mesh, make_mesh, mesh_shape


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> int:
    """Join the process group when launched as several processes.

    A no-op returning 1 for one process, so that callers can use the same
    entry point everywhere; otherwise returns the process count.
    ``coordinator`` is an ``init_method`` (``tcp://host:port``,
    ``file:///path``) or a bare ``host:port``; ``backend`` defaults to
    NCCL with a card and gloo without.
    """
    if num_processes is None or num_processes <= 1:
        return 1
    import torch.distributed as dist
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator is None:
        raise ValueError("init_distributed: several processes need a "
                         "coordinator address")
    if "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=coordinator,
                            world_size=num_processes, rank=process_id)
    return dist.get_world_size()


def process_count() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def make_global_mesh(time: int | None = None, chan: int | None = None,
                     devices=None) -> Mesh:
    """(time, chan) mesh over every process's devices.

    ``devices``: this process's devices (default: every card with one
    process, card ``rank % count`` with several).  Every process must
    have as many.  Default layout: time = the process count, chan = the
    local device count.  Rows are given to processes in order (process
    0 holds the first ``time / processes`` rows), so ``time`` must be a
    multiple of the process count: the channel axis never crosses
    processes.
    """
    procs, rank = process_count(), process_index()
    if devices is None:
        if procs == 1:
            return make_mesh(time or 1, chan)
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("make_global_mesh: no CUDA device found; "
                               "pass devices=['cpu'] * n")
        devices = [torch.device("cuda", rank % n)]
    local = [torch.device(d) for d in devices]
    total = len(local) * procs
    if time is None:
        time = procs
    if chan is None:
        chan = total // time
    if time * chan != total:
        raise ValueError(f"time*chan = {time}*{chan} != {total}")
    if time % procs:
        raise ValueError(
            f"time={time} is not a multiple of the {procs} processes: the "
            "chan axis would cross processes (only the time axis may)")
    rows = time // procs
    grid = tuple(tuple(local[(t % rows) * chan:(t % rows + 1) * chan])
                 for t in range(time))
    return Mesh(grid, row_process=tuple(t // rows for t in range(time)),
                process_index=rank)


def host_shard_block(mesh: Mesh, x_local) -> list:
    """Place this process's contiguous part of the ADC block (its time
    rows; the whole block in one process) on the mesh: ``xs[t][k]`` is
    time slice t on device (t, k), None for a row of another process.
    Rows on one device share one tensor."""
    t_sz, k_sz = mesh_shape(mesh)
    rows = mesh.local_rows
    if isinstance(x_local, np.ndarray):
        x_local = torch.from_numpy(x_local)
    nl = x_local.shape[0] // len(rows)
    xs = [[None] * k_sz for _ in range(t_sz)]
    for i, t in enumerate(rows):
        part = x_local[i * nl:(i + 1) * nl]
        placed: dict = {}
        for k in range(k_sz):
            dev = mesh.device(t, k)
            if dev not in placed:
                placed[dev] = part.to(dev)
            xs[t][k] = placed[dev]
    return xs


def _sync(mesh: Mesh) -> None:
    for t in mesh.local_rows:
        for dev in mesh.devices[t]:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)


def scaling_report(mesh: Mesh, step_fn, args, iters: int = 4) -> dict:
    """Wall time a step on this mesh, after one step that is not timed
    (with channels grown with the devices, step_time(1 device) /
    step_time(N devices) is the weak-scaling efficiency)."""
    step_fn(*args)
    _sync(mesh)
    t0 = _time.perf_counter()
    for _ in range(iters):
        step_fn(*args)
    _sync(mesh)
    dt = (_time.perf_counter() - t0) / iters
    return {"devices": mesh.size, "time_shards": mesh.shape["time"],
            "chan_shards": mesh.shape["chan"], "step_seconds": dt}


__all__ = ["host_shard_block", "init_distributed", "make_global_mesh",
           "process_count", "process_index", "scaling_report"]
