"""The multi-device receiver step over a (time, chan) mesh.

Port of :mod:`flydog_sdr_gps_tpu.parallel.sharded_rx` (one ``shard_map``
there).  Here one process drives every device of its mesh rows, and the
parallel decomposition of ``models.rx_channel.rx_block`` is the same:

1. **Front half (DDC, 125 Msps).**  The ADC block is split along
   'time' (device (t, k) takes the t-th contiguous slice) and the filter
   bank along 'chan' (device (t, k) holds the bank columns of channel
   shard k).  Filter history crosses time-shard boundaries: device (t, k)
   needs the last ``tail1`` raw samples of shard t-1 (stage 1) and the
   last ``tail2`` stage-1 outputs of device (t-1, k) (stage 2).  Time
   shard 0 takes the carried tails instead.  The 48-bit NCO phase of
   shard t is ``advance(phi1, dphi1, t * k1/T)``, exact in int64.
   Stage 1 is the cuBLAS product and the exact rotator
   (``channelizer.stage1_apply``); stage 2 is ``channelizer.
   stage2_apply``, which on a card is CUDA kernel 2 (the reference's
   unfused ``stage2_pallas``).  ``params.stage2`` is ignored, as in the
   reference.
2. **Back half (audio rate).**  Channels are re-sharded over every
   device: the DDC output is gathered over 'time', and device (t, k)
   keeps channel group ``g = k*T + t``, i.e. channels ``k*C/K + t*C/(T*K)
   ... + C/(T*K)``, and runs ``rx_channel.audio_back_half`` on it with
   the tuning of that group alone.  The host gates of a group
   (``rx_channel.with_gates``) are its own, as the reference's
   ``lax.cond`` gates run on each shard's tuning: a group with no LMS
   lane does not advance its LMS delay lines.

Between devices of one process a halo or a gather is a tensor copy;
between processes (:mod:`.distributed`, only the time axis crosses them)
the halos and the carries are ``send``/``recv`` and the gather over time
is ``all_gather``.  The DDC carries come from the last time shard; each
channel shard keeps one copy of its DDC carry, on the device of its
first time row.

Requirements (the reference's messages): C % (T*K) == 0, audio_block % T
== 0, and ``k1/T >= tail2`` (a halo must fit in one neighbour shard).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from ..models import rx_channel as rx
from ..ops import channelizer as chz
from ..ops import nco
from .distributed import host_shard_block
from .mesh import Mesh, mesh_shape

# the tuning fields of the DDC: columns of channel shard k, the same on
# every time row
_DDC_TUNING = ("bank", "dphi1")


@dataclasses.dataclass
class ShardedRxState:
    """An ``RxState`` split over a mesh.

    ``ddc[k]``: channel shard k's DDC carry (x_tail (tail1,), y_tail
    (tail2, C/K) rotated, phi1 (C/K,)) on the device of this process's
    first row and chan k; only time row 0 reads x_tail and y_tail.
    ``back[t][k]``: the audio-rate state of channel group k*T + t on
    device (t, k) (its ``ddc`` field is None); None for a row of another
    process.
    """
    ddc: list[chz.DDCState]
    back: list[list[rx.RxState | None]]


@dataclasses.dataclass
class ShardedRxTuning:
    """``shards[t][k]``: the ``RxTuning`` of device (t, k): the bank
    columns and rotator words of channel shard k, and the back-half
    fields of channel group k*T + t with that group's host gates."""
    shards: list[list[rx.RxTuning | None]]


def _on(device: torch.device):
    """Make ``device`` current, for the kernels' raw launches."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _sizes(mesh: Mesh, num_channels: int) -> tuple[int, int, int, int]:
    t_sz, k_sz = mesh_shape(mesh)
    if num_channels % (t_sz * k_sz):
        raise ValueError(f"channels {num_channels} not divisible by mesh "
                         f"{t_sz}x{k_sz}")
    c_chan = num_channels // k_sz
    return t_sz, k_sz, c_chan, c_chan // t_sz


def _columns(x: torch.Tensor, lo: int, n: int,
             device: torch.device) -> torch.Tensor:
    """Columns [lo, lo+n) of the last axis as a new contiguous tensor on
    ``device``; a 0-d tensor (a replicated field) is copied whole."""
    part = x if x.dim() == 0 else x[..., lo:lo + n]
    return part.to(device, copy=True).contiguous()


def _map_fields(obj, fn):
    """A copy of nested dataclasses with ``fn`` applied to each tensor
    (a None field stays None)."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    return type(obj)(**{f.name: _map_fields(getattr(obj, f.name), fn)
                        for f in dataclasses.fields(obj)})


def _cat_fields(parts: list, device: torch.device):
    """Nested dataclasses whose tensors are the ``parts``' tensors joined
    along the last axis in order (0-d ones: the first part's value; a
    None field stays None)."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        if first.dim() == 0:
            return first.to(device, copy=True)
        return torch.cat([p.to(device) for p in parts], dim=-1)
    return type(first)(**{
        f.name: _cat_fields([getattr(p, f.name) for p in parts], device)
        for f in dataclasses.fields(first)})


def _group_order(mesh: Mesh) -> list[tuple[int, int]]:
    """(t, k) of channel groups 0, 1, ...: group k*T + t is on (t, k)."""
    t_sz, k_sz = mesh_shape(mesh)
    return [(t, k) for k in range(k_sz) for t in range(t_sz)]


# ---------------------------------------------------------------------------
# placing and gathering state, tuning and taps
# ---------------------------------------------------------------------------

def shard_rx_state(state: rx.RxState, mesh: Mesh,
                   params: rx.RxParams) -> ShardedRxState:
    """Split a whole ``RxState`` (the unfused representation: y_tail
    rotated) over the mesh.  Rows of other processes get None."""
    t_sz, k_sz, c_chan, c_local = _sizes(mesh, params.num_channels)
    r0 = mesh.local_rows[0]
    ddc = []
    for k in range(k_sz):
        dev = mesh.device(r0, k)
        ddc.append(chz.DDCState(
            x_tail=state.ddc.x_tail.to(dev, copy=True),
            y_tail=_columns(state.ddc.y_tail, k * c_chan, c_chan, dev),
            phi1=_columns(state.ddc.phi1, k * c_chan, c_chan, dev)))
    back_only = dataclasses.replace(state, ddc=None)
    back = [[None] * k_sz for _ in range(t_sz)]
    for g, (t, k) in enumerate(_group_order(mesh)):
        if mesh.is_local(t):
            dev = mesh.device(t, k)
            back[t][k] = _map_fields(
                back_only, lambda x: _columns(x, g * c_local, c_local, dev))
    return ShardedRxState(ddc=ddc, back=back)


def gather_rx_state(state: ShardedRxState, mesh: Mesh,
                    device: torch.device | str) -> rx.RxState:
    """The whole ``RxState`` on ``device``: what the reference's
    ``np.asarray`` of each global array gives.  The inverse of
    :func:`shard_rx_state`."""
    if mesh.num_processes > 1:
        raise ValueError("gather_rx_state needs every row of the mesh in "
                         "this process")
    device = torch.device(device)
    whole = _cat_fields([state.back[t][k] for t, k in _group_order(mesh)],
                        device)
    ddc = chz.DDCState(
        x_tail=state.ddc[0].x_tail.to(device, copy=True),
        y_tail=torch.cat([d.y_tail.to(device) for d in state.ddc], dim=1),
        phi1=torch.cat([d.phi1.to(device) for d in state.ddc]))
    return dataclasses.replace(whole, ddc=ddc)


def _device_tuning(tuning: rx.RxTuning, ddc_part: dict, lo: int, n: int,
                   device: torch.device) -> rx.RxTuning:
    """Device (t, k)'s tuning: ``ddc_part`` (bank, dphi1 of its channel
    shard) and columns [lo, lo+n) of every back-half field."""
    fields = {f.name: getattr(tuning, f.name)
              for f in dataclasses.fields(tuning)
              if isinstance(getattr(tuning, f.name), torch.Tensor)}
    back = {name: _columns(v, lo, n, device) for name, v in fields.items()
            if name not in _DDC_TUNING}
    return rx.with_gates(dataclasses.replace(tuning, **back, **ddc_part))


def shard_rx_tuning(tuning: rx.RxTuning, mesh: Mesh) -> ShardedRxTuning:
    """Split a whole ``RxTuning`` over the mesh.  Time rows that share a
    device share their channel shard's bank and rotator words."""
    t_sz, k_sz, c_chan, c_local = _sizes(mesh, tuning.mode.shape[0])
    shards = [[None] * k_sz for _ in range(t_sz)]
    ddc_parts: dict = {}
    for g, (t, k) in enumerate(_group_order(mesh)):
        if not mesh.is_local(t):
            continue
        dev = mesh.device(t, k)
        key = (k, dev)
        if key not in ddc_parts:
            ddc_parts[key] = {
                name: _columns(getattr(tuning, name), k * c_chan, c_chan, dev)
                for name in _DDC_TUNING}
        shards[t][k] = _device_tuning(tuning, ddc_parts[key], g * c_local,
                                      c_local, dev)
    return ShardedRxTuning(shards=shards)


def gather_taps(taps, mesh: Mesh, device: torch.device | str) -> rx.RxTaps:
    """Whole-C ``RxTaps`` on ``device`` from the per-device taps of
    :func:`make_sharded_rx_step` (channel group order).  Across
    processes each process gathers every row's taps (``all_gather``)."""
    device = torch.device(device)
    if mesh.num_processes > 1:
        taps = _all_gather_taps(taps, mesh)
    return _cat_fields([taps[t][k] for t, k in _group_order(mesh)], device)


# ---------------------------------------------------------------------------
# collectives between processes (only the time axis crosses them)
# ---------------------------------------------------------------------------

def _real(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t) if t.is_complex() else t


def _p2p(ops: list[tuple[bool, torch.Tensor, int]]) -> None:
    """Run (is_send, tensor, peer rank) point-to-point operations as one
    batch and wait for them."""
    if not ops:
        return
    import torch.distributed as dist
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend if send else dist.irecv, _real(t), peer)
        for send, t, peer in ops])
    for r in reqs:
        r.wait()


def _all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Concatenate every process's ``x`` (its rows, stacked on axis 0) in
    process order."""
    import torch.distributed as dist
    parts = [torch.empty_like(x) for _ in range(mesh.num_processes)]
    dist.all_gather([_real(p) for p in parts], _real(x.contiguous()))
    return torch.cat(parts)


def _comm_device(mesh: Mesh) -> torch.device:
    return mesh.device(mesh.local_rows[0], 0)


def _all_gather_taps(taps, mesh: Mesh):
    t_sz, k_sz = mesh_shape(mesh)
    rows = mesh.local_rows
    dev = _comm_device(mesh)
    out = [[None] * k_sz for _ in range(t_sz)]
    for k in range(k_sz):
        local = [taps[t][k] for t in rows]
        whole = {}
        for f in dataclasses.fields(local[0]):
            stacked = torch.stack([getattr(p, f.name).to(dev)
                                   for p in local])
            whole[f.name] = _all_gather_rows(stacked, mesh)
        for t in range(t_sz):
            out[t][k] = type(local[0])(**{n: v[t] for n, v in whole.items()})
    return out


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def make_sharded_rx_step(params: rx.RxParams, mesh: Mesh):
    """Build the multi-device receiver step.

    Returns ``step(state, tuning, x) -> (new_state, taps)``: ``state`` a
    :class:`ShardedRxState`, ``tuning`` a :class:`ShardedRxTuning`, ``x``
    this process's part of the ADC block (a tensor or numpy array; the
    whole (adc_block,) block in one process) or what
    :func:`host_shard_block` made of it.  ``taps[t][k]`` are the
    ``RxTaps`` of channel group k*T + t on device (t, k)
    (:func:`gather_taps` joins them).
    """
    plan = params.ddc
    t_sz, k_sz, c_chan, c_local = _sizes(mesh, params.num_channels)
    if params.audio_block % t_sz:
        raise ValueError("audio_block must divide by time shards")
    k1_local = plan.k1 // t_sz
    if k1_local < plan.tail2:
        raise ValueError(
            f"time shard too small: k1_local={k1_local} < tail2="
            f"{plan.tail2}; raise audio_block or lower time shards")
    rows = mesh.local_rows
    first, last = rows[0], rows[-1]
    multi = mesh.num_processes > 1
    cdev = _comm_device(mesh)
    owner = mesh.row_process

    def left_of(t, k, own, edge, tail):
        """The ``tail`` samples before shard t's first: the carry at
        t=0, shard t-1's last ones (a copy from its device, or what
        another process sent)."""
        dev = mesh.device(t, k)
        if t == 0:
            return own.to(dev)
        if mesh.is_local(t - 1):
            return edge(t - 1)[-tail:].to(dev)
        return edge(None).to(dev)

    def step(state: ShardedRxState, tuning: ShardedRxTuning, x):
        xs = x if isinstance(x, list) else host_shard_block(mesh, x)
        local = [(t, k) for t in rows for k in range(k_sz)]

        # ---- stage 1 and its halo: shard t-1's last tail1 samples ----
        ops, x_edge = [], None
        if last + 1 < t_sz:
            ops.append((True, xs[last][0][-plan.tail1:].to(cdev)
                        .contiguous(), owner[last + 1]))
        if first > 0:
            x_edge = torch.empty(plan.tail1, dtype=torch.float32,
                                 device=cdev)
            ops.append((False, x_edge, owner[first - 1]))
        if multi:
            _p2p(ops)
        y1 = {}
        for t, k in local:
            dev, tun = mesh.device(t, k), tuning.shards[t][k]
            with _on(dev):
                left = left_of(t, k, state.ddc[k].x_tail,
                               lambda s: x_edge if s is None else xs[s][k],
                               plan.tail1)
                x_ext = torch.cat([left, xs[t][k]])
                phi = nco.advance(state.ddc[k].phi1.to(dev), tun.dphi1,
                                  t * k1_local)
                y1[t, k] = chz.stage1_apply(plan, x_ext, tun.bank, phi,
                                            tun.dphi1)   # (k1/T, C/K)

        # ---- stage 2 and its halo: (t-1, k)'s last tail2 outputs ----
        ops, y_edge = [], {}
        for k in range(k_sz):
            if last + 1 < t_sz:
                ops.append((True, y1[last, k][-plan.tail2:].to(cdev)
                            .contiguous(), owner[last + 1]))
            if first > 0:
                y_edge[k] = torch.empty((plan.tail2, c_chan),
                                        dtype=torch.complex64, device=cdev)
                ops.append((False, y_edge[k], owner[first - 1]))
        if multi:
            _p2p(ops)
        y_ext, iq_local = {}, {}
        for t, k in local:
            with _on(mesh.device(t, k)):
                left = left_of(t, k, state.ddc[k].y_tail,
                               lambda s: y_edge[k] if s is None
                               else y_ext[s, k], plan.tail2)
                y_ext[t, k] = torch.cat([left, y1.pop((t, k))])
                iq_local[t, k] = chz.stage2_apply(plan, y_ext[t, k])

        # ---- re-shard: all of time, this device's channel group ----
        if multi:
            whole = {k: _all_gather_rows(torch.stack(
                [iq_local[t, k].to(cdev) for t in rows]), mesh)
                for k in range(k_sz)}
            by_row = lambda s, k: whole[k][s]
        else:
            by_row = lambda s, k: iq_local[s, k]
        back = [[None] * k_sz for _ in range(t_sz)]
        taps = [[None] * k_sz for _ in range(t_sz)]
        for t, k in local:
            dev = mesh.device(t, k)
            cols = slice(t * c_local, (t + 1) * c_local)
            iq = torch.cat([by_row(s, k)[:, cols].to(dev)
                            for s in range(t_sz)])
            # ---- audio-rate back half on the group ----
            with _on(dev):
                back[t][k], taps[t][k] = rx.audio_back_half(
                    params, state.back[t][k], tuning.shards[t][k], iq)

        # ---- DDC carries from the last time shard ----
        ddc = []
        if t_sz - 1 in rows and 0 in rows:
            x_tails = [xs[t_sz - 1][k][-plan.tail1:] for k in range(k_sz)]
            y_tails = [y_ext[t_sz - 1, k][-plan.tail2:]
                       for k in range(k_sz)]
        else:
            ops, x_tails, y_tails = [], [None] * k_sz, [None] * k_sz
            if t_sz - 1 in rows:
                ops.append((True, xs[t_sz - 1][0][-plan.tail1:].to(cdev)
                            .contiguous(), owner[0]))
                ops += [(True, y_ext[t_sz - 1, k][-plan.tail2:].to(cdev)
                         .contiguous(), owner[0]) for k in range(k_sz)]
            if 0 in rows:
                xt = torch.empty(plan.tail1, dtype=torch.float32,
                                 device=cdev)
                x_tails = [xt] * k_sz
                y_tails = [torch.empty((plan.tail2, c_chan),
                                       dtype=torch.complex64, device=cdev)
                           for _ in range(k_sz)]
                ops.append((False, xt, owner[t_sz - 1]))
                ops += [(False, y, owner[t_sz - 1]) for y in y_tails]
            _p2p(ops)
        for k in range(k_sz):
            old = state.ddc[k]
            dev = old.phi1.device
            dphi = tuning.shards[first][k].dphi1.to(dev)
            ddc.append(chz.DDCState(
                x_tail=(old.x_tail if x_tails[k] is None
                        else x_tails[k].to(dev, copy=True)),
                y_tail=(old.y_tail if y_tails[k] is None
                        else y_tails[k].to(dev, copy=True)),
                phi1=nco.advance(old.phi1, dphi, plan.k1)))
        return ShardedRxState(ddc=ddc, back=back), taps

    return step
