"""GPS subsystem orchestration — the `gps_main()` analogue.

Port of :mod:`flydog_sdr_gps_tpu.models.gps.manager`: the same host
state machine, around the port's device work (acquisition with
``torch.fft``, the tracking kernel ``gps_track_f32``).

Reference flow (`gps/gps.cpp:40`, SURVEY.md section 3.4): SearchTask
round-robins satellites through FFT acquisition; hits hand off to one
of 12 channel tasks that track and collect nav bits; SolveTask every
2 s snapshots all channels, builds pseudoranges and solves position;
`clock_correction()` turns (GPS time, tick count) pairs into the
corrected ADC clock that retunes every DDC NCO
(`rx/rx_sound.cpp:334-344`).

Here the same state machine runs host-side around the device kernels:
acquisition and the tracking bank run on the card; decisions
(handoff, drop, solve cadence) are Python control flow at sub-Hz
rates, exactly like the reference's ARM-side logic.

Design points:
- the tracking bank has FIXED capacity (GPS_MAX_CHANS rows, like the
  FPGA's fixed correlator count): acquiring/dropping a satellite
  writes one row of the batched state's tensors.
- transmit time is anchored the way the reference builds pseudoranges
  (`gps/solve.cpp:60-167`): the HOW TOW of a decoded subframe dates
  the subframe's first bit; an unwrapped code-chip counter carries
  that date forward exactly (1 chip = 1/1.023 MHz of SV time), so
  t_tx(now) = TOW_anchor + delta_chips / 1.023 MHz.
- pseudoranges = c * (t_rx_common - t_tx_i); the common receive
  instant is the last processed epoch boundary, measured in receiver
  (nominal-rate) sample counts — the solver's clock-bias state absorbs
  the offset, exactly like the reference's tick-derived t_rx.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from ... import _graphs
from ...numerology import (ADC_CLOCK_NOM, CA_CHIP_RATE, E1B_CODELEN,
                           GALILEO_PRN_BASE, GPS_FS, GPS_MAX_CHANS,
                           L1_CODELEN)
from . import (acquisition, cacode, clock, ephemeris, galileo, solver,
               tracking)

C_LIGHT = solver.C_LIGHT


@dataclasses.dataclass
class GpsChannel:
    """Host-side per-satellite bookkeeping (the `gps/channel.cpp`
    ChanTask state, minus what lives in the batched TrackState)."""
    prn: int
    state_idx: int                  # row in the batched TrackState
    acquired_snr: float = 0.0
    code_len: int = L1_CODELEN      # chips per code period
    epochs: int = 0                 # epochs tracked since start
    chips: float = 0.0              # unwrapped code chips since start
    last_cp: float | None = None    # previous epoch code-phase snapshot
    # prompt-I epochs (and the unwrapped chips at each epoch start)
    # waiting to be folded into 20 ms nav bits — bounded by bit
    # consumption; before bit sync, capped at ~2.4 s
    ip_pending: list = dataclasses.field(default_factory=list)
    chip_pending: list = dataclasses.field(default_factory=list)
    bit_offset: int | None = None   # epoch phase of the bit boundary
    # per-epoch r (chips from window start to its internal code
    # boundary), kept only until bit sync resolves: the lag decision
    # must use r at the flip epoch, not the newest window's r (code
    # Doppler drifts r a few chips/s over the ~4 s sync window)
    r_pending: list = dataclasses.field(default_factory=list)
    bits_total: int = 0             # bits consumed (global bit index)
    # chips at the start of each consumed bit (ring of the last ~6100,
    # enough to date any subframe the assembler can still decode)
    bit_anchors: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=6100))
    anchor_base: int = 0            # global bit index of bit_anchors[0]
    # transmit-time reference: (t_tx at anchor, chips at anchor)
    tow_ref: tuple[float, float] | None = None
    # prompt I/Q ring for the UI IQ scatter (the reference's per-
    # channel IQ logger, CmdIQLogGet / `gps/solve.cpp:585-599`)
    iq_log: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=256))
    asm: ephemeris.SubframeAssembler = None
    lost_count: int = 0
    # Galileo symbol accumulator: code-period id -> prompt-I sum
    # (fed by the split pre/post prompts so boundary-straddling
    # windows contribute exactly to the right symbol)
    gal_acc: dict = dataclasses.field(default_factory=dict)
    gal_p0: float | None = None     # unwrapped chips of period id 0

    def __post_init__(self):
        if self.asm is None:
            self.asm = (galileo.InavAssembler(prn=self.svid)
                        if self.constellation == "galileo"
                        else ephemeris.SubframeAssembler(prn=self.prn))

    @property
    def constellation(self) -> str:
        return "galileo" if self.prn >= GALILEO_PRN_BASE else "gps"

    @property
    def svid(self) -> int:
        """Constellation-local satellite id (E1B SV id for Galileo)."""
        return (self.prn - GALILEO_PRN_BASE
                if self.prn >= GALILEO_PRN_BASE else self.prn)

    def t_tx_now(self) -> float | None:
        """SV transmit time (GPS s-of-week) of the sample at the
        current tracking boundary, dated from the last subframe."""
        if self.tow_ref is None:
            return None
        t0, chips0 = self.tow_ref
        return t0 + (self.chips - chips0) / CA_CHIP_RATE


class GpsManager:
    """Drives acquisition/tracking/solution from streamed IF blocks."""

    def __init__(self, max_chans: int = GPS_MAX_CHANS,
                 prns=tuple(range(1, 33)) + cacode.QZSS_PRNS,
                 acq_params: acquisition.AcqParams | None = None,
                 track_params: tracking.TrackParams | None = None,
                 min_snr: float = 30.0,   # peak/mean; noise plane
                                           # maxes out ~20 (ref min_sig
                                           # analogue, gps/search.cpp)
                 on_clock=None,
                 adc_clock_nom: float = ADC_CLOCK_NOM,
                 galileo_prns: tuple[int, ...] = (),
                 device: torch.device | str = "cuda",
                 use_graphs: bool | None = None):
        # the card unless the caller asks for the CPU: the tracking
        # state, the code table and acquisition live there
        self.device = torch.device(device)
        # the tracking step and its pack as one program over buffers (a
        # CUDA graph per capacity and epochs a chunk; the reference jits
        # it); by default on a card; on the CPU True runs the same
        # static-buffer body with nothing captured
        if use_graphs is None:
            use_graphs = self.device.type == "cuda"
        self._graphs = _graphs.GraphSet(self.device) if use_graphs else None
        self._track_bufs: dict[int, tuple] = {}   # per epochs a chunk
        self.acq = acq_params or acquisition.AcqParams()
        self.tp = track_params or tracking.TrackParams()
        self.max_chans = max_chans
        self.prns = tuple(prns)
        # Galileo E1B SV ids to search (needs E1B memory codes — ICD
        # data via galileo.set_e1b_codes, or the synthetic test codes)
        self.galileo_prns = tuple(galileo_prns)
        self.min_snr = min_snr
        self.channels: dict[int, GpsChannel] = {}
        # the clock discipline measures the IF sample rate against GPS
        # time; the IF sampler is clocked from the same oscillator as
        # the ADC (FPGA clocks `gps/sampler.v` from the ADC domain), so
        # the fractional error transfers to the ADC clock directly
        self.clock = clock.ClockDiscipline(nominal_hz=self.tp.fs)
        self.adc_clock_nom = adc_clock_nom
        self.ekf = solver.EkfSolver()
        self.on_clock = on_clock        # callback(adc_clock_hz)
        self.last_fix = None
        self.last_solutions: dict[str, dict] = {}
        self.fixes = 0
        self._track_state, self._code_table = tracking.empty_track_state(
            self.tp, max_chans, self.device)
        # acquire/drop only writes rows of these tensors; a chunk is one
        # launch of the tracking kernel, and its outputs come back PACKED
        # in one tensor and one copy to the host (`_advance_tracked`)
        self.ticks = 0                  # IF samples consumed (48-bit)
        self.samples_tracked = 0        # IF samples through tracking
        self._rem = np.zeros(0, np.float32)   # sub-epoch remainder
        # periodic background search (SearchTask cadence); 0 disables
        self.search_interval_s = 2.0
        self._last_search = 0
        self.searches = 0               # cold searches run by process()
        self._sbuf = np.zeros(0, np.float32)  # rolling search capture
        self._gal_deferred = False    # E1B search waiting for 2 windows

    # -- acquisition -----------------------------------------------------
    def cold_search(self, raw_if: np.ndarray,
                    advance_samples: int = 0) -> list[dict]:
        """Run the full-sky search on an IF capture and start tracking
        the hits (`SearchTask` -> `ChanStart`).

        The acquired code phase dates ``raw_if[0]``;
        ``advance_samples`` projects it forward to the instant the
        tracking bank will actually see next (the capture may be a
        rolling buffer of already-tracked samples — the reference's
        SearchTask likewise samples its own capture buffer,
        `gps/search.cpp:382-447`).

        E1B satellites are only searched when >= 2 code periods (2 x
        4 ms windows) are available: a single window can lose the
        whole correlation peak to a mid-window symbol flip (the cause
        of low-SNR false handoffs).
        """
        if len(self.channels) >= self.max_chans:
            return []
        tracked = {c.prn for c in self.channels.values()}
        todo = tuple(p for p in self.prns if p not in tracked)
        cands = []
        if todo:
            cands += acquisition.acquire_all(
                self.acq, raw_if[: self.acq.n_raw], prns=todo,
                device=self.device)
        todo_gal = tuple(p for p in self.galileo_prns
                         if GALILEO_PRN_BASE + p not in tracked)
        if todo_gal and len(raw_if) >= 2 * self.acq.n_raw:
            # 2 windows: non-coherent combining over a symbol edge
            for c in galileo.acquire_all_e1b(
                    self.acq, raw_if[: 2 * self.acq.n_raw],
                    prns=todo_gal, device=self.device):
                c["prn"] += GALILEO_PRN_BASE
                cands.append(c)
        elif todo_gal:
            self._gal_deferred = True
        cands.sort(key=lambda r: -r["snr"])
        started = []
        for cand in cands:
            if len(self.channels) >= self.max_chans:
                break
            if cand["prn"] in tracked or cand["snr"] < self.min_snr:
                continue
            if advance_samples:
                L = (E1B_CODELEN if cand["prn"] >= GALILEO_PRN_BASE
                     else L1_CODELEN)
                rate = (CA_CHIP_RATE
                        * (1.0 + cand["doppler"] / 1.57542e9)
                        / self.tp.fs)
                cand = dict(cand, code_phase=(
                    cand["code_phase"] + advance_samples * rate) % L)
            self._start_channel(cand)
            started.append(cand)
        return started

    def _free_row(self) -> int | None:
        used = {c.state_idx for c in self.channels.values()}
        for i in range(self.max_chans):
            if i not in used:
                return i
        return None

    def _start_channel(self, cand: dict) -> None:
        idx = self._free_row()
        if idx is None:
            return
        prn = cand["prn"]
        is_gal = prn >= GALILEO_PRN_BASE
        code = (galileo.e1b_code(prn - GALILEO_PRN_BASE) if is_gal
                else None)
        self._track_state, self._code_table = tracking.activate_channel(
            self.tp, self._track_state, self._code_table, idx,
            prn, cand["code_phase"], cand["doppler"],
            code=code, boc=is_gal)
        self.channels[prn] = GpsChannel(
            prn=prn, state_idx=idx, acquired_snr=cand["snr"],
            code_len=E1B_CODELEN if is_gal else L1_CODELEN)

    def _drop_channel(self, prn: int) -> None:
        ch = self.channels.pop(prn, None)
        if ch is not None:
            self._track_state = tracking.deactivate_channel(
                self._track_state, ch.state_idx)

    # -- tracking --------------------------------------------------------
    def track_block(self, raw_if) -> None:
        """Advance all channels over an IF block (multiple 1 ms epochs).

        Sub-epoch remainders are buffered so no samples are skipped
        (the tick counter must count exactly the samples tracked).
        ``raw_if`` may be a tensor on the manager's device (whole-epoch
        chunks from a device scene): it is consumed in place — no host
        round trip.
        """
        is_np = not isinstance(raw_if, torch.Tensor)
        n_in = int(raw_if.shape[0])
        self.ticks = (self.ticks + n_in) % (1 << 48)
        if not is_np and not len(self._rem) \
                and n_in % self.tp.epoch == 0:
            n_ep = n_in // self.tp.epoch
            used = n_in
            raw_e = raw_if.to(self.device, torch.float32).reshape(
                n_ep, self.tp.epoch)
            self.samples_tracked += used
            if not self.channels:
                return
            self._advance_tracked(raw_e, n_ep)
            return
        raw_np = (raw_if.cpu().numpy().astype(np.float32, copy=False)
                  if not is_np else np.asarray(raw_if, np.float32))
        buf = (np.concatenate([self._rem, raw_np])
               if len(self._rem) else raw_np)
        n_ep = len(buf) // self.tp.epoch
        used = n_ep * self.tp.epoch
        self._rem = buf[used:]
        if n_ep == 0:
            return
        self.samples_tracked += used
        if not self.channels:
            return
        raw_e = torch.as_tensor(buf[:used].reshape(n_ep, self.tp.epoch),
                                device=self.device)
        self._advance_tracked(raw_e, n_ep)

    # -- the tracking state: buffers a compiled step reads ----------------
    @property
    def _track_state(self) -> tracking.TrackState:
        return self._tstate

    @_track_state.setter
    def _track_state(self, value: tracking.TrackState) -> None:
        # the first assignment makes the buffers; later ones copy into
        # them (activating a row writes the same tensors in place)
        if getattr(self, "_tstate", None) is None:
            self._tstate = value
        else:
            _graphs.copy_into(self._tstate, value)

    @property
    def _code_table(self) -> torch.Tensor:
        return self._ctable

    @_code_table.setter
    def _code_table(self, value: torch.Tensor) -> None:
        if getattr(self, "_ctable", None) is None:
            self._ctable = value
        else:
            _graphs.copy_into(self._ctable, value)

    def _track_step(self, raw_e: torch.Tensor) -> torch.Tensor:
        """Kernel 6 over ``raw_e`` (n_ep, epoch), then its outputs packed
        [ip | qp | ip_pre | code_phase (n_ep, nch) each | end code_phase
        (nch)] in ONE tensor: one copy to the host a chunk."""
        _, outs = tracking.track_epochs(self.tp, self._track_state,
                                        self._code_table, raw_e)
        return torch.cat([outs["ip"].reshape(-1), outs["qp"].reshape(-1),
                          outs["ip_pre"].reshape(-1),
                          outs["code_phase"].reshape(-1),
                          self._track_state.code_phase.reshape(-1)])

    def _advance_tracked(self, raw_e, n_ep: int) -> None:
        if self._graphs is None:
            packed = self._track_step(raw_e)
        else:
            # the compiled step: the chunk copied into the program's
            # input buffer, the step replayed into its result buffer
            bufs = self._track_bufs.get(n_ep)
            if bufs is None:
                nch = self._track_state.code_phase.shape[0]
                bufs = self._track_bufs[n_ep] = (
                    torch.zeros(raw_e.shape, dtype=torch.float32,
                                device=self.device),
                    torch.zeros((4 * n_ep + 1) * nch, dtype=torch.float32,
                                device=self.device))
            raw_buf, packed = bufs
            raw_buf.copy_(raw_e)
            self._graphs.run(
                ("track", packed.numel() // (4 * n_ep + 1), n_ep),
                lambda: packed.copy_(self._track_step(raw_buf)))
        flat = packed.cpu().numpy()       # ONE device fetch
        nch = (len(flat) - 0) // (4 * n_ep + 1)
        nb = n_ep * nch
        ip = flat[0:nb].reshape(n_ep, nch)
        qp = flat[nb:2 * nb].reshape(n_ep, nch)
        ip_pre = flat[2 * nb:3 * nb].reshape(n_ep, nch)
        cp = flat[3 * nb:4 * nb].reshape(n_ep, nch)  # epoch-START phase
        end_cp = flat[4 * nb:4 * nb + nch]
        for ch in list(self.channels.values()):
            i = ch.state_idx
            self._advance_channel(ch, ip[:, i], qp[:, i], ip_pre[:, i],
                                  cp[:, i], float(end_cp[i]), n_ep)

    def _advance_channel(self, ch: GpsChannel, ip: np.ndarray,
                         qp: np.ndarray, ip_pre: np.ndarray,
                         cp_starts: np.ndarray,
                         cp_end: float, n_ep: int) -> None:
        # --- unwrap the code-chip counter across this block ---
        # cp_starts[0] is the phase at the last boundary (== ch.last_cp
        # when the channel was already running); each 1 ms epoch
        # advances by ~1023 chips regardless of constellation (E1B is
        # also 1.023 Mcps), so advance[k] = 1023 + wrap(diff - 1023)
        # with the wrap taken mod the channel's code length.
        ch.iq_log.extend(zip(ip.tolist(), qp.tolist()))
        L = float(ch.code_len)
        seq = np.concatenate([cp_starts, [cp_end]])
        adv = 1023.0 + ((np.diff(seq) - 1023.0 + L / 2) % L - L / 2)
        chips_at_start = ch.chips + np.concatenate(
            [[0.0], np.cumsum(adv[:-1])])
        ch.chips = float(chips_at_start[-1] + adv[-1])
        ch.last_cp = cp_end
        ch.epochs += n_ep

        # --- prompt history for bit/symbol extraction ---
        if ch.constellation == "galileo":
            # E1B symbols are one 4092-chip code period.  Each 1 ms
            # window's prompt was split at its internal code-period
            # boundary (ip_pre = before, ip - ip_pre = after), so
            # symbol integrals are assembled EXACTLY: period id from
            # the unwrapped chips of the period start.
            period_start = chips_at_start - np.mod(cp_starts, L)
            if ch.gal_p0 is None:
                ch.gal_p0 = float(period_start[0])
            # period starts sit at gal_p0 + k*L in unwrapped chips
            # (exact up to DLL jitter) — id them relative to gal_p0
            pids = np.rint((period_start - ch.gal_p0) / L
                           ).astype(np.int64)
            for w in range(n_ep):
                p = int(pids[w])
                ch.gal_acc[p] = ch.gal_acc.get(p, 0.0) + float(ip_pre[w])
                post = float(ip[w] - ip_pre[w])
                if post != 0.0:
                    ch.gal_acc[p + 1] = ch.gal_acc.get(p + 1, 0.0) + post
            self._consume_syms_gal(ch, int(pids[-1]))
        else:
            ch.ip_pending.extend(ip.tolist())
            # anchor candidates: every 1 ms epoch window contains
            # exactly ONE code-period boundary (epoch ~= code period);
            # nav-bit edges coincide with such boundaries (20
            # periods/bit), so storing each window's internal boundary
            # recovers the edge time at chip precision — the
            # reference's code-phase pseudorange term
            # (`gps/solve.cpp:60-167`).  WHICH window holds the bit
            # edge (flip window or the one before) is decided once at
            # bit-sync time (`_consume_bits`).
            r = (-cp_starts) % 1023.0      # chips from window start
            #                                to its internal boundary
            ch.chip_pending.extend((chips_at_start + r).tolist())
            if ch.bit_offset is None:
                ch.r_pending.extend(r.tolist())
            self._consume_bits(ch)

        # power monitor / drop (`CheckPower`, gps/channel.cpp:579):
        # Costas lock metric — mean|IP|^2 / mean(IP^2+QP^2) is ~1
        # when phase-locked (data on I only), ~0.4 on noise.  Counted
        # in epochs (feed-chunk-size invariant) with a pull-in grace
        # period, like the reference's sustained-low-power criterion.
        if ch.epochs > 500:
            if ch.constellation == "galileo":
                # a symbol (= code period) edge can fall mid-window;
                # those windows mix adjacent symbols and null |IP|
                # even in perfect lock — judge only the windows whose
                # boundary partial is clearly one-sided
                w = np.abs(ip_pre) < 0.25 * np.abs(ip)
                w |= np.abs(ip - ip_pre) < 0.25 * np.abs(ip)
                ipj, qpj = ip[w], qp[w]
                if len(ipj) < 8:
                    ipj, qpj = ip, qp
            else:
                ipj, qpj = ip, qp
            lock = (np.mean(np.abs(ipj)) ** 2 /
                    max(np.mean(ipj ** 2 + qpj ** 2), 1e-9))
            if lock < 0.55:
                ch.lost_count += n_ep
                if ch.lost_count > 2000:    # ~2 s of lost lock
                    self._drop_channel(ch.prn)
            else:
                # decay instead of reset: a channel oscillating around
                # the threshold (half-lock on a bad handoff) still
                # accumulates and gets dropped for re-search, like the
                # reference's sustained-power criterion
                ch.lost_count = max(0, ch.lost_count - n_ep // 2)

    def _consume_syms_gal(self, ch: GpsChannel, last_pid: int) -> None:
        """Emit completed 4 ms I/NAV symbols (one per E1B code
        period) from the split-prompt accumulator, feed the page
        assembler, drain TOW anchors.  No bit-sync search is needed:
        symbol edges ARE code period boundaries (`sdrnav_gal.cpp`
        exploits the same).

        A period p is complete once a window STARTS in period
        > p (later windows can only contribute to p+1 onwards)."""
        done = sorted(p for p in ch.gal_acc if p < last_pid)
        if not done:
            return
        syms = []
        for p in done:
            syms.append(ch.gal_acc.pop(p))
            # anchor: unwrapped chips at this period's start
            ch.bit_anchors.append(ch.gal_p0 + p * float(ch.code_len))
        ch.bits_total += len(syms)
        ch.anchor_base = ch.bits_total - len(ch.bit_anchors)
        ch.asm.feed(np.asarray(syms))
        for (_wt, start_sym, tow) in ch.asm.events:
            j = start_sym - ch.anchor_base
            if 0 <= j < len(ch.bit_anchors):
                # I/NAV TOW dates the start of its own nominal page
                ch.tow_ref = (tow, ch.bit_anchors[j])
        ch.asm.events.clear()

    def _consume_bits(self, ch: GpsChannel) -> None:
        """Fold pending 1 ms prompts into 20 ms nav bits, feed the
        subframe assembler, and drain TOW anchors."""
        if ch.bit_offset is None:
            if len(ch.ip_pending) < 1000:   # need bit-sync confidence
                return
            off = tracking.bit_sync_confident(np.asarray(ch.ip_pending))
            if off is None:
                # not confident yet; bound the window (multiples of 20
                # keep the mod-20 boundary phase intact)
                if len(ch.ip_pending) > 4000:
                    del ch.ip_pending[:2000]
                    del ch.chip_pending[:2000]
                    del ch.r_pending[:2000]
                return
            # --- resolve the 1-code-period anchor ambiguity ---
            # The flip histogram locates the bit edge to +-1 epoch;
            # the edge itself is a code-period boundary, and each
            # epoch window contains exactly one (at r chips in).  When
            # the boundary sits mid-window (r ~ 511) the flip epoch is
            # noise-split between the edge window and the next, so the
            # histogram alone can mis-date every anchor by exactly
            # 1 ms (= 1023 chips, ~300 km of pseudorange).  Decide
            # once which window holds the edge:
            #   r near the window ends -> the majority rule is solid:
            #     r > 511.5 means the edge window is mostly OLD bit,
            #     so the flip fires one epoch later (lag=1);
            #   r mid-window -> transition windows straddling the edge
            #     have collapsed |IP| (half old + half new bit): the
            #     weaker of the two candidate phases holds the edge.
            r = ch.r_pending[off] if off < len(ch.r_pending) else \
                ch.r_pending[-1]
            if r < 150.0 or r > 873.0:
                lag = 1 if r > 511.5 else 0
            else:
                ips = np.asarray(ch.ip_pending)
                nb = (len(ips) - off) // 20
                bseq = np.sign(ips[off: off + nb * 20]
                               .reshape(nb, 20).sum(axis=1))
                tr = np.where(bseq[1:] != bseq[:-1])[0] + 1
                j = off + 20 * tr
                j = j[(j >= 1) & (j < len(ips))]
                if len(j) == 0:
                    lag = 1 if r > 511.5 else 0
                else:
                    e_here = float(np.mean(np.abs(ips[j])))
                    e_prev = float(np.mean(np.abs(ips[j - 1])))
                    lag = 1 if e_prev < e_here else 0
            if off == 0 and lag == 1:
                off = 20            # keep the chip index in range
            ch.bit_offset = off
            ch.r_pending.clear()
            del ch.ip_pending[:off]
            # with lag=1 the edge boundary lives in the window BEFORE
            # each bit's first epoch: let the chip list lead by one
            del ch.chip_pending[:off - lag]
        nbits = len(ch.ip_pending) // 20
        if nbits == 0:
            return
        ips = np.asarray(ch.ip_pending[: nbits * 20]).reshape(nbits, 20)
        bits = np.sign(ips.sum(axis=1)).astype(np.int8)
        for k in range(nbits):
            ch.bit_anchors.append(ch.chip_pending[20 * k])
        del ch.ip_pending[: nbits * 20]
        del ch.chip_pending[: nbits * 20]
        ch.bits_total += nbits
        ch.anchor_base = ch.bits_total - len(ch.bit_anchors)
        ch.asm.feed(bits)
        for (_sub, start_bit, tow_next) in ch.asm.events:
            if tow_next <= 0:
                continue
            j = start_bit - ch.anchor_base
            if 0 <= j < len(ch.bit_anchors):
                # HOW TOW dates the start of the NEXT subframe; this
                # subframe's first bit is 6 s earlier
                ch.tow_ref = (tow_next - 6.0, ch.bit_anchors[j])
        ch.asm.events.clear()

    # -- combined step (server entry point) -------------------------------
    def process(self, raw_if: np.ndarray, search: bool = False) -> None:
        """Feed one IF block: tracking, then cold search when
        requested OR due.

        Like the reference's SearchTask (`gps/search.cpp:512`, which
        round-robins satellites forever), the search re-runs
        periodically on its own while any searched PRN is untracked —
        a satellite missed at start-up or dropped after a bad handoff
        is re-acquired without the caller asking.  Searches run on a
        rolling 2-window capture buffer; newly started channels get
        their code phase projected to the next tracked sample.
        """
        is_np = not isinstance(raw_if, torch.Tensor)
        if is_np:
            raw_if = np.asarray(raw_if, np.float32)
        self.track_block(raw_if)
        cap_len = 2 * self.acq.n_raw
        due = (self._search_due()
               if not search and self.search_interval_s > 0 else False)
        # search capture buffer: host arrays always; DEVICE IF is
        # fetched only when a search actually runs (the IF stream
        # otherwise never crosses the host link)
        if is_np or search or due or self._gal_deferred:
            # a device chunk: only its last cap_len samples cross
            raw_np = (raw_if if is_np else
                      raw_if[-cap_len:].cpu().numpy().astype(np.float32,
                                                             copy=False))
            if len(raw_np) >= cap_len:
                self._sbuf = raw_np[-cap_len:]
            else:
                self._sbuf = np.concatenate(
                    [self._sbuf, raw_np])[-cap_len:]
        if self._gal_deferred and len(self._sbuf) >= cap_len:
            self._gal_deferred = False
            due = True
        if (search or due) and len(self.channels) < self.max_chans \
                and len(self._sbuf) >= self.acq.n_raw:
            self.cold_search(
                self._sbuf,
                advance_samples=len(self._sbuf) - len(self._rem))
            self._last_search = self.samples_tracked
            self.searches += 1

    def _search_due(self) -> bool:
        if len(self.channels) >= self.max_chans:
            return False
        tracked = {c.prn for c in self.channels.values()}
        want = set(self.prns) | {GALILEO_PRN_BASE + p
                                 for p in self.galileo_prns}
        if want <= tracked:
            return False
        return (self.samples_tracked - self._last_search
                >= self.search_interval_s * self.tp.fs)

    # -- nav decode (compat shim; decoding now happens inline) ------------
    def decode_nav(self) -> None:
        """Nav decode runs incrementally inside :meth:`track_block`;
        kept for API compatibility."""

    def ephemerides(self) -> dict[int, ephemeris.Ephemeris]:
        """Currently decoded (complete) ephemerides per PRN."""
        return {ch.prn: ch.asm.eph for ch in self.channels.values()
                if ch.asm.eph.complete()}

    # -- solution --------------------------------------------------------
    def solve(self, ephemerides: dict[int, ephemeris.Ephemeris] | None
              = None, gps_time: float | None = None) -> np.ndarray | None:
        """Position solution from current tracking state + ephemerides.

        ``ephemerides``: optional prn -> Ephemeris overrides (assisted
        start; cold-start decode needs ~30 s of bits).  ``gps_time`` is
        ignored (transmit times are self-dated from decoded TOW); kept
        for API compatibility.

        Mirrors the reference's 3 solver sets (`gps/solve.cpp:571-640`):
        all sats, GPS/QZSS-only, Galileo-only; the fix comes from the
        best available set ("all" preferred).
        """
        ephemerides = ephemerides or {}
        decoded = self.ephemerides()
        meas = []                       # (prn, kind, sat_pos, prange)
        for ch in self.channels.values():
            eph = ephemerides.get(ch.prn) or decoded.get(ch.prn)
            t_tx = ch.t_tx_now()
            if eph is None or t_tx is None:
                continue
            pos, sv_clk = eph.sat_pos(t_tx)
            meas.append((ch.prn, ch.constellation, t_tx, pos, sv_clk))
        if len(meas) < 4:
            return None
        # common receive instant: all channels snapshot the same epoch
        # boundary; estimate its GPS time as max t_tx + nominal flight
        # time, like the reference's GetClock (`gps/solve.cpp:168`)
        t_rx = max(m[2] for m in meas) + 0.068
        sets = {
            "all": meas,
            "gps": [m for m in meas if m[1] == "gps"],
            "galileo": [m for m in meas if m[1] == "galileo"],
        }
        self.last_solutions = {}
        fix = None
        for name, mm in sets.items():
            if len(mm) < 4:
                continue
            sat_pos = np.asarray([m[3] for m in mm])
            pr = np.asarray([(t_rx - m[2]) * C_LIGHT + m[4] * C_LIGHT
                             for m in mm])
            try:
                pos, bias, rms = solver.solve_ls(sat_pos, pr)
            except (ValueError, np.linalg.LinAlgError):
                continue
            self.last_solutions[name] = dict(
                pos=pos, bias=bias, rms=rms, nsat=len(mm),
                prns=[m[0] for m in mm])
            if name == "all":
                fix = self.ekf.update(sat_pos, pr, dt=2.0)
                # divergence guard: a Kalman filter walked away from
                # the data (bad geometry transient, long-run drift)
                # must not keep reporting its own prior — snap back
                # to the single-point solution (the reference runs
                # LS and EKF side by side for the same reason,
                # `gps/solve.cpp:571-640`)
                if np.linalg.norm(fix - pos) > 5e3:
                    self.ekf.initialized = False
                    fix = self.ekf.update(sat_pos, pr, dt=2.0)
                # clock discipline: solved GPS time of the snapshot
                # instant vs the receiver sample counter
                t_gps = t_rx - bias / C_LIGHT
                self.clock.update(t_gps, self.samples_tracked)
                if self.on_clock is not None and self.clock.locked:
                    self.on_clock(self.adc_clock())
        if fix is None:
            return None
        self.last_fix = fix
        self.fixes += 1
        return fix

    def adc_clock(self) -> float:
        """GPS-corrected ADC clock (Hz): the measured IF-rate error is
        the shared-oscillator error (`init/clk.cpp:117-275`)."""
        return self.adc_clock_nom * (self.clock.adc_clock_hz / self.tp.fs)

    def status(self) -> dict:
        """UI/status summary (`gps/stat.cpp` analogue)."""
        fix_lla = (None if self.last_fix is None
                   else solver.lla_from_ecef(self.last_fix))
        sats = []
        for ch in self.channels.values():
            e = {"prn": ch.prn, "svid": ch.svid,
                 "con": ch.constellation,
                 "snr": round(ch.acquired_snr, 1),
                 "subframes": ch.asm.subframes,
                 "has_tow": ch.tow_ref is not None}
            if self.last_fix is not None and ch.t_tx_now() is not None:
                eph = self.ephemerides().get(ch.prn)
                if eph is not None:
                    pos, _ = eph.sat_pos(ch.t_tx_now())
                    az, el = solver.az_el(self.last_fix, pos)
                    e["az"], e["el"] = round(az, 1), round(el, 1)
            sats.append(e)
        return dict(
            tracking=len(self.channels),
            prns=sorted(self.channels),
            sats=sats,
            fixes=self.fixes,
            adc_clock=self.adc_clock(),
            clock_ppm=round(self.clock.correction_ppm, 3),
            fix=fix_lla,
            solutions={k: dict(nsat=v["nsat"], rms=round(v["rms"], 1))
                       for k, v in self.last_solutions.items()},
        )
