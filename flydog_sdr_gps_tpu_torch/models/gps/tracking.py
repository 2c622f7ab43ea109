"""GPS tracking: 12-channel early/prompt/late correlator bank.

Port of :mod:`flydog_sdr_gps_tpu.models.gps.tracking`.  Reference
split: the FPGA runs per-channel carrier/code NCOs and E/P/L
accumulators at 16.368 Msps (`verilog/gps/demod.v:72-295`); the e_cpu
ISR reads accumulators and runs integrator loop filters ~1 kHz
(`e_cpu/kiwi.gps.asm:452-664`); the host does bit sync, subframes and
power monitoring (`gps/channel.cpp:376-553`).

The JAX package runs the bank as one ``lax.scan`` over 1 ms epochs
(`tracking.py:189-330`).  Here :func:`track_epochs` is the CUDA kernel
``gps_track_f32`` (``csrc/gps_track.cu``: a thread-block cluster of
``CLUSTER`` blocks a row, each block a share of every epoch's samples,
the epochs in a loop inside the kernel) for CUDA tensors, and
:func:`track_epochs_plain` — a Python loop over epochs of exactly the
reference's ``epoch_step`` — for tensors on the CPU.  The state is a
dataclass of ``(capacity,)`` tensors that both update in place;
acquiring or dropping a satellite writes one row of them.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ... import _build
from ...numerology import (CA_CHIP_RATE, E1B_CODELEN, GPS_FC, GPS_FS,
                           L1_CODELEN)
from . import cacode

NW = 1027                       # chips spanned by 1 ms + margin
# the kernel's blocks a row, a thread-block cluster (kCluster of
# csrc/gps_track.cu): the fastest of 1, 2, 4 and 8 (PERF.md §6)
CLUSTER = 8
# outputs a kernel launch writes, (n_ep, nch) each, in this order
OUT_FIELDS = ("ip", "qp", "ip_pre", "code_phase", "qp_pre", "carr_freq",
              "dll_err", "pll_err", "cn0")
# state fields the loops update (the rest are set by activate_channel)
LOOP_FIELDS = ("code_phase", "code_rate", "carr_phase", "carr_freq",
               "ip_prev", "qp_prev")


@dataclasses.dataclass(frozen=True, eq=False)
class TrackParams:
    fs: float = GPS_FS
    fc: float = GPS_FC
    epoch: int = 16368              # samples per 1 ms epoch
    pll_bw: float = 18.0            # Hz
    fll_bw: float = 10.0            # Hz
    dll_bw: float = 3.0             # Hz
    corr_spacing: float = 0.5       # chips, E/L offset

    @property
    def t_epoch(self) -> float:
        return self.epoch / self.fs

    # standard 2nd-order loop gains (zeta = 0.707)
    @property
    def pll_g1(self) -> float:
        wn = self.pll_bw / 0.53
        return float(2 * 0.707 * wn * self.t_epoch)

    @property
    def pll_g2(self) -> float:
        wn = self.pll_bw / 0.53
        return float(wn * wn * self.t_epoch * self.t_epoch)

    @property
    def fll_g(self) -> float:
        return float(self.fll_bw / 0.25 * self.t_epoch)

    @property
    def dll_g(self) -> float:
        return float(4 * self.dll_bw * self.t_epoch)


@dataclasses.dataclass
class TrackState:
    """Per-channel tracking state, all (nch,) float32 unless noted.

    The bank is constellation-generic: ``code_len`` is 1023 for GPS
    C/A rows (tiled x4 in the 4092-wide code table) or 4092 for
    Galileo E1B memory codes; ``boc`` enables the BOC(1,1) subcarrier
    in the replica; ``corr_half`` is the per-channel E/L offset in
    chips (0.5 for C/A's triangular ACF, 0.25 for BOC(1,1)'s narrow
    main peak).  This mirrors how the reference FPGA runs E1B in the
    same demod.v channels by downloading a longer code and a flag
    (`verilog/gps/demod.v`, `CmdSetE1Bcode`).
    """
    code_phase: torch.Tensor    # chips, fractional, mod code_len
    code_rate: torch.Tensor     # chips per raw sample
    carr_phase: torch.Tensor    # radians
    carr_freq: torch.Tensor     # radians per raw sample
    ip_prev: torch.Tensor       # previous prompt I (for FLL cross/dot)
    qp_prev: torch.Tensor       # previous prompt Q
    active: torch.Tensor        # bool — channel enabled
    code_len: torch.Tensor      # chips per code period (1023 / 4092)
    boc: torch.Tensor           # 1.0 = BOC(1,1) subcarrier on replica
    corr_half: torch.Tensor     # E/L correlator offset, chips

    def clone(self) -> TrackState:
        return TrackState(**{f.name: getattr(self, f.name).clone()
                             for f in dataclasses.fields(self)})


def _f32(values, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.float32), device=device)


def init_track_state(params: TrackParams, prns, code_phases, dopplers,
                     device: torch.device | str = "cuda"
                     ) -> tuple[TrackState, torch.Tensor]:
    """Start tracking from acquisition results.

    code_phases in chips (at the acquisition instant), dopplers in Hz.
    Returns (state, code_table (nch*4092,) float32).
    """
    nch = len(prns)
    code_rate = np.full(nch, CA_CHIP_RATE, np.float64)
    dop = np.asarray(dopplers, np.float64)
    # carrier-derived code Doppler: chip rate scales with (1 + fd/fL1)
    code_rate *= (1.0 + dop / 1.57542e9)
    z = torch.zeros((nch,), dtype=torch.float32, device=device)
    state = TrackState(
        code_phase=_f32(np.asarray(code_phases) % L1_CODELEN, device),
        code_rate=_f32(code_rate / params.fs, device),
        carr_phase=z.clone(),
        carr_freq=_f32(2 * np.pi * (params.fc + dop) / params.fs, device),
        ip_prev=z.clone(), qp_prev=z.clone(),
        active=torch.ones((nch,), dtype=torch.bool, device=device),
        code_len=z + float(L1_CODELEN),
        boc=z.clone(),
        corr_half=z + float(np.float32(params.corr_spacing)))
    table = np.concatenate(
        [np.tile(cacode.ca_code_any(p).astype(np.float32),
                 E1B_CODELEN // L1_CODELEN) for p in prns])
    return state, torch.as_tensor(table, device=device)


def empty_track_state(params: TrackParams, capacity: int,
                      device: torch.device | str = "cuda"
                      ) -> tuple[TrackState, torch.Tensor]:
    """Fixed-capacity all-inactive bank (+ zero code table).

    The capacity is fixed (GPS_MAX_CHANS=12, matching the FPGA's fixed
    correlator count `verilog/gps/gps.v`); acquiring or dropping a
    satellite only writes one row of these tensors.
    """
    def full(v):
        return torch.full((capacity,), float(np.float32(v)),
                          dtype=torch.float32, device=device)
    state = TrackState(
        code_phase=full(0.0), code_rate=full(CA_CHIP_RATE / params.fs),
        carr_phase=full(0.0),
        carr_freq=full(2 * np.pi * params.fc / params.fs),
        ip_prev=full(0.0), qp_prev=full(0.0),
        active=torch.zeros((capacity,), dtype=torch.bool, device=device),
        code_len=full(L1_CODELEN), boc=full(0.0),
        corr_half=full(params.corr_spacing))
    return state, torch.zeros((capacity * E1B_CODELEN,), dtype=torch.float32,
                              device=device)


def activate_channel(params: TrackParams, state: TrackState,
                     code_table: torch.Tensor, idx: int, prn: int,
                     code_phase: float, doppler: float,
                     code: np.ndarray | None = None,
                     boc: bool = False,
                     corr_half: float | None = None
                     ) -> tuple[TrackState, torch.Tensor]:
    """Start tracking ``prn`` in row ``idx`` (handoff from acquisition,
    `gps/channel.cpp` ChanStart): row writes into the state's tensors
    and the code table, in place (both are also returned).

    ``code`` defaults to the C/A code for ``prn``; pass a 4092-chip
    E1B memory code (+ ``boc=True``) for a Galileo channel.
    """
    if code is None:
        code = cacode.ca_code_any(prn)
    code = np.asarray(code, np.float32)
    code_len = len(code)
    if corr_half is None:
        corr_half = 0.25 if boc else params.corr_spacing
    rate = (CA_CHIP_RATE * (1.0 + doppler / 1.57542e9)) / params.fs
    cf = 2 * np.pi * (params.fc + doppler) / params.fs
    row = {"code_phase": code_phase % code_len, "code_rate": rate,
           "carr_phase": 0.0, "carr_freq": cf, "ip_prev": 0.0,
           "qp_prev": 0.0, "code_len": float(code_len),
           "boc": 1.0 if boc else 0.0, "corr_half": float(corr_half)}
    for name, value in row.items():
        getattr(state, name)[idx] = float(np.float32(value))
    state.active[idx] = True
    code_table[idx * E1B_CODELEN:(idx + 1) * E1B_CODELEN] = torch.as_tensor(
        np.tile(code, E1B_CODELEN // code_len), device=code_table.device)
    return state, code_table


def deactivate_channel(state: TrackState, idx: int) -> TrackState:
    state.active[idx] = False
    return state


def loop_constants(params: TrackParams) -> tuple[np.float32, ...]:
    """The float32 constants of the reference's loop updates as its
    compiler folds them: XLA turns a division by a constant into a
    product with its reciprocal and a chain of constant products into
    one constant.  So ``dfreq / n`` is ``dfreq * (1/n)``,
    ``carr_freq / 2pi * fs - fc`` is ``carr_freq * (fs/2pi) - fc`` and
    ``CA_CHIP_RATE * (1 + carr_dop / f_L1) / fs`` is
    ``(carr_dop * (1/f_L1) + 1) * (CA_CHIP_RATE/fs)``; each product and
    the add after it are then one fused multiply-add (:func:`_fma`).
    Returns (1/n, fs/2pi, 1/f_L1, CA_CHIP_RATE/fs)."""
    f32 = np.float32
    one = f32(1.0)
    return (one / f32(params.epoch),
            (one / f32(2 * np.pi)) * f32(params.fs),
            one / f32(1.57542e9),
            f32(CA_CHIP_RATE) * (one / f32(params.fs)))


def _fma(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32: a fused multiply-add.  The
    reference's compiler contracts its loop updates into these (XLA's
    CPU backend does, as nvcc does in the kernel), and a phase of a
    thousand chips rounded twice drifts by an ulp an epoch.  The float64
    product of two float32 values is exact."""
    return (a.double() * b.double() + c.double()).float()


def _check_args(state: TrackState, code_table: torch.Tensor,
                raw: torch.Tensor, epoch: int) -> int:
    nch = state.code_phase.shape[0]
    if raw.dim() != 2 or raw.shape[1] != epoch or \
            raw.dtype != torch.float32:
        raise ValueError(f"track_epochs: raw must be float32 (n_ep, "
                         f"{epoch}), got {raw.dtype} {tuple(raw.shape)}")
    if code_table.shape != (nch * E1B_CODELEN,) or \
            code_table.dtype != torch.float32:
        raise ValueError("track_epochs: code_table must be float32 "
                         f"({nch} * {E1B_CODELEN},)")
    return nch


def track_epochs_plain(params: TrackParams, state: TrackState,
                       code_table: torch.Tensor, raw: torch.Tensor):
    """Plain version: the reference's ``epoch_step`` in torch, a Python
    loop over the epochs of raw (n_epochs, epoch).  Float32 throughout,
    in the reference's order of operations.  The state is updated in
    place; returns (state, outs) with outs[name] (n_ep, nch)."""
    nch = _check_args(state, code_table, raw, params.epoch)
    dev = raw.device
    n = params.epoch
    t = torch.arange(n, dtype=torch.float32, device=dev)
    gf = np.float32(params.fll_g)
    two_pi = np.float32(2 * np.pi)
    ch_off = torch.arange(nch, dtype=torch.int64, device=dev)[:, None] \
        * E1B_CODELEN
    sub_big = torch.tensor([1.0] * 8 + [-1.0] * 8, dtype=torch.float32,
                           device=dev).repeat(NW)
    jj = torch.arange(n, device=dev)
    # scalars as float32 tensors for _fma's float64 arithmetic
    g1, g2, gd, n_t, fc, one, c_inv_n, c_dop, c_l1, c_rate = (
        torch.tensor(np.float32(v), device=dev)
        for v in (params.pll_g1, params.pll_g2, params.dll_g, n,
                  params.fc, 1.0, *loop_constants(params)))
    outs = {k: [] for k in OUT_FIELDS}
    cp, rate = state.code_phase.clone(), state.code_rate.clone()
    cph, cf = state.carr_phase.clone(), state.carr_freq.clone()
    ip_prev, qp_prev = state.ip_prev.clone(), state.qp_prev.clone()
    act, is_boc = state.active, state.boc > 0
    cl = state.code_len
    for e in range(raw.shape[0]):
        x = raw[e]
        # ---- carrier wipeoff: (nch, n) ----
        ph = _fma(t[None, :], cf[:, None], cph[:, None])
        xi = x[None, :] * torch.cos(ph)        # I = x*cos
        xq = -x[None, :] * torch.sin(ph)       # Q = -x*sin (mix by e^{-j ph})
        # ---- code replicas at E/P/L: the chip window, repeated 16x,
        # sliced at the sub-chip start (see the reference's comment) ----
        i0 = torch.floor(cp).to(torch.int64)
        f0 = cp - i0.to(torch.float32)
        widx = torch.remainder(
            i0[:, None] - 1 + torch.arange(NW, device=dev)[None, :],
            cl.to(torch.int64)[:, None]) + ch_off
        big = code_table[widx].repeat_interleave(16, dim=1)   # (nch, 16NW)
        s_prompt = 16 + torch.round(f0 * 16.0).to(torch.int64)
        s_half = torch.round(state.corr_half * 16.0).to(torch.int64)

        def code_at(starts):
            # dynamic_slice clamps its start so the slice fits
            starts = torch.clamp(starts, 0, big.shape[1] - n)
            idx = starts[:, None] + jj[None, :]
            c = torch.gather(big, 1, idx)
            return c * torch.where(is_boc[:, None], sub_big[idx],
                                   torch.ones((), device=dev))

        c_e = code_at(s_prompt + s_half)
        c_p = code_at(s_prompt)
        c_l = code_at(s_prompt - s_half)
        ie, qe = (xi * c_e).sum(1), (xq * c_e).sum(1)
        ip, qp = (xi * c_p).sum(1), (xq * c_p).sum(1)
        il, ql = (xi * c_l).sum(1), (xq * c_l).sum(1)
        # the prompt split at the window's internal code-period boundary
        t_b = (cl - torch.remainder(cp, cl)) / rate
        pre = t[None, :] < t_b[:, None]
        zero = torch.zeros((), device=dev)
        ip_pre = torch.where(pre, xi * c_p, zero).sum(1)
        qp_pre = torch.where(pre, xq * c_p, zero).sum(1)

        # ---- discriminators ----
        e_mag = torch.sqrt(ie * ie + qe * qe)
        l_mag = torch.sqrt(il * il + ql * ql)
        dll_err = (e_mag - l_mag) / torch.clamp(e_mag + l_mag, min=1e-9)
        qp_post = qp - qp_pre
        ip_post = ip - ip_pre
        use_pre = (ip_pre * ip_pre + qp_pre * qp_pre
                   >= ip_post * ip_post + qp_post * qp_post)
        ip_l = torch.where(is_boc, torch.where(use_pre, ip_pre, ip_post), ip)
        qp_l = torch.where(is_boc, torch.where(use_pre, qp_pre, qp_post), qp)
        tiny = torch.full((), 1e-9, device=dev)
        pll_err = torch.atan(qp_l / torch.where(ip_l.abs() < 1e-9, tiny,
                                                ip_l))
        cross = ip_l * qp_prev - qp_l * ip_prev
        dot = ip_l * ip_prev + qp_l * qp_prev
        fll_err = torch.atan(cross / torch.where(dot.abs() < 1e-9, tiny,
                                                 dot))

        # ---- loop updates (per raw sample units) ----
        # as the reference's compiler emits them (see loop_constants)
        dfreq = _fma(g2, pll_err, -(gf * fll_err))
        carr_freq = _fma(dfreq, c_inv_n, cf)
        carr_phase = torch.remainder(
            _fma(g1, pll_err, _fma(cf, n_t, cph)), two_pi)
        # carrier-aided code rate: code Doppler = carr Doppler / 1540
        carr_dop = _fma(carr_freq, c_dop, -fc)
        code_rate = _fma(carr_dop, c_l1, one) * c_rate
        code_phase = torch.remainder(
            _fma(gd, dll_err, _fma(rate, n_t, cp)), cl)
        cn0 = (ip * ip + qp * qp) / torch.clamp(
            e_mag * e_mag + l_mag * l_mag, min=1e-9)
        for k, v in (("ip", ip), ("qp", qp), ("ip_pre", ip_pre),
                     ("code_phase", cp), ("qp_pre", qp_pre),
                     ("carr_freq", carr_freq), ("dll_err", dll_err),
                     ("pll_err", pll_err), ("cn0", cn0)):
            outs[k].append(v)
        cp = torch.where(act, code_phase, cp)
        rate = torch.where(act, code_rate, rate)
        cph = torch.where(act, carr_phase, cph)
        cf = torch.where(act, carr_freq, cf)
        ip_prev, qp_prev = ip_l, qp_l
    for name, v in zip(LOOP_FIELDS, (cp, rate, cph, cf, ip_prev, qp_prev)):
        getattr(state, name).copy_(v)
    empty = torch.zeros((0, nch), dtype=torch.float32, device=dev)
    return state, {k: torch.stack(v) if v else empty
                   for k, v in outs.items()}


def track_epochs(params: TrackParams, state: TrackState,
                 code_table: torch.Tensor, raw: torch.Tensor, lib=None):
    """Track over raw (n_epochs, epoch) 1-bit (+-1 float) samples.

    Updates ``state`` in place and returns (state, outputs) with
    outputs[name] (n_epochs, nch) for every name of ``OUT_FIELDS``: ip,
    qp, ip_pre, qp_pre, the epoch-START code_phase, the new carr_freq,
    dll_err, pll_err and the cn0 proxy.  CPU tensors run the plain
    version; CUDA tensors the kernel, whose outputs are views of one
    (9, n_epochs, nch) tensor in ``OUT_FIELDS`` order.  ``lib`` is the
    kernel library to launch from: the package's build by default, or
    one from ``_build.load`` (``chip_smoke.py``'s clock64 build).
    """
    nch = _check_args(state, code_table, raw, params.epoch)
    if raw.device.type == "cpu":
        return track_epochs_plain(params, state, code_table, raw)
    _build.require_cuda(raw, "track_epochs")
    if params.epoch % 4 or params.epoch > 16 * NW:
        raise ValueError(f"track_epochs: the kernel takes epochs of a "
                         f"multiple of 4 samples up to {16 * NW}, got "
                         f"{params.epoch}")
    n_ep = raw.shape[0]
    raw = raw.contiguous()
    if raw.data_ptr() % 16:                 # the kernel reads float4s
        raw = raw.clone()
    outs = torch.empty((len(OUT_FIELDS), n_ep, nch), dtype=torch.float32,
                       device=raw.device)
    if n_ep == 0:
        return state, dict(zip(OUT_FIELDS, outs))
    if code_table.device != raw.device or not code_table.is_contiguous():
        raise ValueError("track_epochs: code_table must be contiguous on "
                         f"{raw.device}")
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        dtype = torch.bool if f.name == "active" else torch.float32
        if v.device != raw.device or not v.is_contiguous() or \
                v.shape != (nch,) or v.dtype != dtype:
            raise ValueError(f"track_epochs: state.{f.name} must be a "
                             f"contiguous ({nch},) {dtype} tensor on "
                             f"{raw.device}")
    f32 = np.float32
    stream = torch.cuda.current_stream(raw.device).cuda_stream
    # the kernel reads ``active`` as bytes: a torch.bool is one byte, 0/1
    lib = _build.lib() if lib is None else lib
    err = lib.gps_track_f32(
        raw.data_ptr(), code_table.data_ptr(),
        *(getattr(state, k).data_ptr() for k in LOOP_FIELDS),
        state.active.data_ptr(), state.code_len.data_ptr(),
        state.boc.data_ptr(),
        state.corr_half.data_ptr(), outs.data_ptr(), nch, n_ep,
        params.epoch, f32(params.pll_g1), f32(params.pll_g2),
        f32(params.fll_g), f32(params.dll_g), *loop_constants(params),
        f32(params.fc), stream)
    _build.check(err, "gps_track_f32")
    _build.count_launch(track_epochs)
    return state, dict(zip(OUT_FIELDS, outs))


track_epochs.launches = 0


def max_active_clusters(nch: int) -> int:
    """How many of the kernel's clusters the card can hold at once
    (``cudaOccupancyMaxActiveClusters``); a bank of ``nch`` rows runs all
    its rows side by side when this is >= nch."""
    out = ctypes.c_int(0)
    _build.check(_build.lib().gps_track_max_clusters(
        nch, ctypes.addressof(out)), "gps_track_max_clusters")
    return out.value


# ---------------------------------------------------------------------------
# host-side bit sync (reference: host Tracking() nav-bit collection,
# `gps/channel.cpp:430-530`)
# ---------------------------------------------------------------------------

def bit_sync_confident(ip_seq: np.ndarray, settle: int = 300,
                       min_flips: int = 8, dominance: float = 2.0
                       ) -> int | None:
    """Bit-boundary phase (0..19) with a confidence gate, or None.

    The first ``settle`` epochs are skipped (DLL/PLL pull-in makes
    spurious sign flips — the reference likewise waits for lock before
    collecting nav bits, `gps/channel.cpp:430-530`); the winning
    histogram bin must hold ``min_flips`` hits and beat the runner-up
    by ``dominance``.  ``settle`` must be a multiple of 20 so the
    returned phase is relative to ``ip_seq[0]``.
    """
    assert settle % 20 == 0
    seq = np.asarray(ip_seq)[settle:]
    flips = np.where(np.diff(np.signbit(seq)))[0] + 1
    if len(flips) == 0:
        return None
    hist = np.bincount(flips % 20, minlength=20)
    best = int(np.argmax(hist))
    runner = int(np.sort(hist)[-2])
    if hist[best] < min_flips or hist[best] < dominance * max(runner, 1):
        return None
    return best


def bit_sync(ip_seq: np.ndarray) -> tuple[int, np.ndarray]:
    """Find the 20 ms nav-bit boundary and integrate bits.

    ip_seq: (n_epochs,) prompt-I per 1 ms epoch for one channel.
    Returns (offset, bits +-1) — offset = epochs until first boundary.
    """
    ip_seq = np.asarray(ip_seq)
    flips = np.where(np.diff(np.signbit(ip_seq)))[0] + 1
    if len(flips) == 0:
        return 0, np.sign(ip_seq[::20])[: len(ip_seq) // 20]
    hist = np.bincount(flips % 20, minlength=20)
    offset = int(np.argmax(hist))
    usable = ip_seq[offset:]
    nbits = len(usable) // 20
    bits = np.sign(usable[: nbits * 20].reshape(nbits, 20).sum(axis=1))
    return offset, bits.astype(np.int8)
