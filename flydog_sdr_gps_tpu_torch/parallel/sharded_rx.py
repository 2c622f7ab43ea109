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

from .. import _graphs
from ..models import rx_channel as rx
from ..ops import channelizer as chz
from ..ops import nco
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

def _check(params: rx.RxParams, mesh: Mesh) -> None:
    """The reference's requirements of a mesh step, with its messages."""
    plan = params.ddc
    t_sz = _sizes(mesh, params.num_channels)[0]
    if params.audio_block % t_sz:
        raise ValueError("audio_block must divide by time shards")
    k1_local = plan.k1 // t_sz
    if k1_local < plan.tail2:
        raise ValueError(
            f"time shard too small: k1_local={k1_local} < tail2="
            f"{plan.tail2}; raise audio_block or lower time shards")


def _clone(obj):
    """A copy of nested lists and dataclasses with every tensor cloned
    (host fields, such as a tuning's gates, kept)."""
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, list):
        return [_clone(x) for x in obj]
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _clone(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), (torch.Tensor, list))
            or dataclasses.is_dataclass(getattr(obj, f.name))})
    return obj


def make_sharded_rx_step(params: rx.RxParams, mesh: Mesh):
    """Build the multi-device receiver step.

    Returns ``step(state, tuning, x) -> (new_state, taps)``: ``state`` a
    :class:`ShardedRxState`, ``tuning`` a :class:`ShardedRxTuning`, ``x``
    this process's part of the ADC block (a tensor or numpy array; the
    whole (adc_block,) block in one process) or what
    :func:`.distributed.host_shard_block` made of it.  ``taps[t][k]``
    are the ``RxTaps`` of channel group k*T + t on device (t, k)
    (:func:`gather_taps` joins them).

    The step is :class:`ShardedProgram`'s body run with nothing
    captured, over buffers of its own: ``state`` and ``tuning`` are
    copied in, and the new state and the taps are returned as copies.
    """
    _check(params, mesh)
    prog = None

    def step(state: ShardedRxState, tuning: ShardedRxTuning, x):
        nonlocal prog
        if prog is None:
            prog = ShardedProgram(params, mesh, _clone(state),
                                  _clone(tuning), use_graphs=False)
        else:
            prog.load_state(state)
            prog.load_tuning(tuning)
        if isinstance(x, list):         # host_shard_block's placement
            x = torch.cat([x[t][0].to(prog.cdev) for t in mesh.local_rows])
        taps = prog(torch.as_tensor(x))
        return _clone(prog.state), _clone(taps)

    return step


# ---------------------------------------------------------------------------
# the compiled step
# ---------------------------------------------------------------------------

class ShardedProgram:
    """The mesh step over buffers this program owns (the reference's
    ``jax.jit`` of its ``shard_map``).

    Each device's compute between two exchanges is a program, keyed by
    that shard's gates: stage 1 (``("s1", t, k)``), stage 2 after the
    stage-1 halo (``("s2", t, k)``), the back half after the re-shard
    (``("back", t, k) + gates``).  The exchanges (the halos, the
    re-shard, the carries: copies between devices, ``batch_isend_irecv``
    and ``all_gather`` between processes) run between them, outside any
    graph, so one code path serves one process and several.  When one
    process drives a mesh of one device (the (2, 2) mesh of one card),
    the whole step, segments and exchanges, is one program (``whole``),
    keyed by every shard's gates.  On a card each program is a CUDA graph
    (:mod:`.._graphs`) unless ``use_graphs`` is False; on the CPU, or
    then, the same bodies run with nothing captured.

    ``state`` and ``tuning`` are the buffers (:meth:`load_state` and
    :meth:`load_tuning` copy into them).  :meth:`__call__` returns the
    per-device taps buffers, which the next block overwrites.
    """

    def __init__(self, params: rx.RxParams, mesh: Mesh,
                 state: ShardedRxState, tuning: ShardedRxTuning,
                 use_graphs: bool = True):
        _check(params, mesh)
        plan = params.ddc
        t_sz, k_sz, c_chan, c_local = _sizes(mesh, params.num_channels)
        self.params, self.mesh = params, mesh
        self.state, self.tuning = state, tuning
        self.rows = mesh.local_rows
        self.local = [(t, k) for t in self.rows for k in range(k_sz)]
        self.cdev = _comm_device(mesh)
        devs = list(dict.fromkeys(mesh.device(t, k) for t, k in self.local))
        self.whole = mesh.num_processes == 1 and len(devs) == 1
        self._graphs = {d: _graphs.GraphSet(d, enabled=use_graphs)
                        for d in devs}
        self.k1_local = plan.k1 // t_sz
        n2 = params.audio_block // t_sz
        nl = plan.adc_block // t_sz

        def grid(fn):
            g = [[None] * k_sz for _ in range(t_sz)]
            for t, k in self.local:
                g[t][k] = fn(t, k, mesh.device(t, k))
            return g
        f32, i64, c64 = torch.float32, torch.int64, torch.complex64
        # the process's part of the block; rows on the comm device read
        # views of it, other devices a copy of their row
        self.x = torch.zeros(nl * len(self.rows), dtype=f32, device=self.cdev)
        placed: dict = {}

        def x_row(t, k, dev):
            i = self.rows.index(t)
            if dev == self.cdev:
                return self.x[i * nl:(i + 1) * nl]
            if (t, dev) not in placed:
                placed[t, dev] = torch.zeros(nl, dtype=f32, device=dev)
            return placed[t, dev]
        self.xs = grid(x_row)
        # (row copy, its slice of x): the rows the first exchange copies
        self._x_copies = [(buf, self.x[self.rows.index(t) * nl:
                                       (self.rows.index(t) + 1) * nl])
                          for (t, _dev), buf in placed.items()]
        self.x_left = grid(lambda t, k, d: torch.zeros(plan.tail1, dtype=f32,
                                                       device=d))
        self.phi = grid(lambda t, k, d: torch.zeros(c_chan, dtype=i64,
                                                    device=d))
        self.y1 = grid(lambda t, k, d: torch.zeros(
            (self.k1_local, c_chan), dtype=c64, device=d))
        self.y_left = grid(lambda t, k, d: torch.zeros(
            (plan.tail2, c_chan), dtype=c64, device=d))
        self.iq_local = grid(lambda t, k, d: torch.zeros(
            (n2, c_chan), dtype=c64, device=d))
        self.iq_back = grid(lambda t, k, d: torch.zeros(
            (params.audio_block, c_local), dtype=c64, device=d))

        def taps(t, k, d):
            def z(dtype):
                return torch.zeros((params.audio_block, c_local),
                                   dtype=dtype, device=d)
            return rx.RxTaps(audio=z(f32), audio2=z(f32), iq_pre_fir=z(c64),
                             iq_post_agc=z(c64),
                             smeter_dbm=torch.zeros(c_local, dtype=f32,
                                                    device=d))
        self.taps = grid(taps)

    def load_state(self, value: ShardedRxState) -> None:
        """Copy a sharded state into the state buffers."""
        for mine, new in zip(self.state.ddc, value.ddc):
            _graphs.copy_into(mine, new)
        for row_b, row_v in zip(self.state.back, value.back):
            for mine, new in zip(row_b, row_v):
                if mine is not None:
                    _graphs.copy_into(mine, new)

    def load_tuning(self, value: ShardedRxTuning) -> None:
        """Copy a sharded tuning into the shard buffers, and take each
        shard's host gates."""
        bufs = self.tuning.shards
        for t, row in enumerate(value.shards):
            for k, new in enumerate(row):
                if new is not None:
                    _graphs.copy_into(bufs[t][k], new)
                    bufs[t][k] = dataclasses.replace(
                        bufs[t][k], **{f: getattr(new, f)
                                       for f in rx.GATE_FIELDS})

    def __call__(self, x: torch.Tensor):
        """One block: ``x`` (this process's part of the ADC block) copied
        into the input buffer, then the step; returns ``taps[t][k]``."""
        self.x.copy_(x)
        if self.whole:
            key = ("mesh",) + tuple(rx.gates(self.tuning.shards[t][k])
                                    for t, k in self.local)
            self._graphs[self.cdev].run(key, self._body)
        else:
            self._body()
        return self.taps

    def _segment(self, key: tuple, dev: torch.device, fn) -> None:
        """One device's compute between two exchanges: a program of its
        own (or, in a whole-step program, just its body)."""
        with _on(dev):
            if self.whole:
                fn()
            else:
                self._graphs[dev].run(key, fn)

    def _body(self) -> None:
        params, mesh, plan = self.params, self.mesh, self.params.ddc
        t_sz, k_sz = mesh_shape(mesh)
        rows, local, cdev = self.rows, self.local, self.cdev
        first, last = rows[0], rows[-1]
        owner, multi = mesh.row_process, mesh.num_processes > 1
        state, tuning = self.state, self.tuning
        c_local = params.num_channels // (t_sz * k_sz)
        n2 = params.audio_block // t_sz

        # ---- exchange: the block's rows, stage 1's halo, the phases ----
        for buf, part in self._x_copies:
            buf.copy_(part)
        ops, x_edge = [], None
        if last + 1 < t_sz:
            ops.append((True, self.xs[last][0][-plan.tail1:].to(cdev)
                        .contiguous(), owner[last + 1]))
        if first > 0:
            x_edge = torch.empty(plan.tail1, dtype=torch.float32,
                                 device=cdev)
            ops.append((False, x_edge, owner[first - 1]))
        if multi:
            _p2p(ops)
        for t, k in local:
            if t == 0:
                left = state.ddc[k].x_tail
            elif mesh.is_local(t - 1):
                left = self.xs[t - 1][k][-plan.tail1:]
            else:
                left = x_edge
            self.x_left[t][k].copy_(left)
            self.phi[t][k].copy_(state.ddc[k].phi1)

        # ---- stage 1 ----
        for t, k in local:
            def s1(t=t, k=k):
                tun = tuning.shards[t][k]
                x_ext = torch.cat([self.x_left[t][k], self.xs[t][k]])
                phi = nco.advance(self.phi[t][k], tun.dphi1,
                                  t * self.k1_local)
                self.y1[t][k].copy_(chz.stage1_apply(plan, x_ext, tun.bank,
                                                     phi, tun.dphi1))
            self._segment(("s1", t, k), mesh.device(t, k), s1)

        # ---- exchange: stage 2's halo ----
        ops, y_edge = [], {}
        for k in range(k_sz):
            if last + 1 < t_sz:
                ops.append((True, self.y1[last][k][-plan.tail2:].to(cdev)
                            .contiguous(), owner[last + 1]))
            if first > 0:
                y_edge[k] = torch.empty((plan.tail2, self.y1[first][k]
                                         .shape[1]), dtype=torch.complex64,
                                        device=cdev)
                ops.append((False, y_edge[k], owner[first - 1]))
        if multi:
            _p2p(ops)
        for t, k in local:
            if t == 0:
                left = state.ddc[k].y_tail
            elif mesh.is_local(t - 1):
                left = self.y1[t - 1][k][-plan.tail2:]
            else:
                left = y_edge[k]
            self.y_left[t][k].copy_(left)

        # ---- stage 2 ----
        for t, k in local:
            def s2(t=t, k=k):
                y_ext = torch.cat([self.y_left[t][k], self.y1[t][k]])
                self.iq_local[t][k].copy_(chz.stage2_apply(plan, y_ext))
            self._segment(("s2", t, k), mesh.device(t, k), s2)

        # ---- exchange: the re-shard (all of time, this group) ----
        if multi:
            whole = {k: _all_gather_rows(torch.stack(
                [self.iq_local[t][k].to(cdev) for t in rows]), mesh)
                for k in range(k_sz)}

            def by_row(s, k):
                return whole[k][s]
        else:
            def by_row(s, k):
                return self.iq_local[s][k]
        for t, k in local:
            cols = slice(t * c_local, (t + 1) * c_local)
            for s in range(t_sz):
                self.iq_back[t][k][s * n2:(s + 1) * n2].copy_(
                    by_row(s, k)[:, cols])

        # ---- the back half on each group ----
        for t, k in local:
            def back(t=t, k=k):
                new, taps = rx.audio_back_half(
                    params, state.back[t][k], tuning.shards[t][k],
                    self.iq_back[t][k])
                _graphs.copy_into(state.back[t][k], new)
                _graphs.copy_into(self.taps[t][k], taps)
            self._segment(("back", t, k) + rx.gates(tuning.shards[t][k]),
                          mesh.device(t, k), back)

        # ---- exchange: the DDC carries from the last time shard ----
        if t_sz - 1 in rows and 0 in rows:
            x_tails = [self.xs[t_sz - 1][k][-plan.tail1:]
                       for k in range(k_sz)]
            y_tails = [self.y1[t_sz - 1][k][-plan.tail2:]
                       for k in range(k_sz)]
        else:
            ops, x_tails, y_tails = [], [None] * k_sz, [None] * k_sz
            if t_sz - 1 in rows:
                ops.append((True, self.xs[t_sz - 1][0][-plan.tail1:].to(cdev)
                            .contiguous(), owner[0]))
                ops += [(True, self.y1[t_sz - 1][k][-plan.tail2:].to(cdev)
                         .contiguous(), owner[0]) for k in range(k_sz)]
            if 0 in rows:
                xt = torch.empty(plan.tail1, dtype=torch.float32,
                                 device=cdev)
                x_tails = [xt] * k_sz
                y_tails = [torch.empty_like(state.ddc[k].y_tail, device=cdev)
                           for k in range(k_sz)]
                ops.append((False, xt, owner[t_sz - 1]))
                ops += [(False, y, owner[t_sz - 1]) for y in y_tails]
            _p2p(ops)
        for k in range(k_sz):
            carry = state.ddc[k]
            with _on(carry.phi1.device):
                if x_tails[k] is not None:
                    carry.x_tail.copy_(x_tails[k])
                    carry.y_tail.copy_(y_tails[k])
                carry.phi1.copy_(nco.advance(
                    carry.phi1, tuning.shards[first][k].dphi1.to(
                        carry.phi1.device), plan.k1))
