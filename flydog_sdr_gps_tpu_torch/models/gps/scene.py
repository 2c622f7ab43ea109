"""Synthetic GPS IF scene: a physically consistent multi-satellite
1-bit 16.368 Msps stream.

The reference can replay recorded SiGe front-end captures
(GPS_SAMPLES_FROM_FILE, `gps/search.cpp:361-379`); a TPU deployment
has no RF front end at all, so the equivalent regression input is a
*generated* capture with known truth: receiver position, satellite
ephemerides, SV clock offsets, receiver oscillator error.  Everything
the real sky does to the signal is modeled:

- geometric delay with earth-rotation (Sagnac) correction, iterated
  per chunk and linearly interpolated within it;
- satellite clock offset (af0/af1 + relativistic term) advancing the
  transmitted code/carrier timing;
- receiver oscillator fractional error ``clock_ppm`` scaling both the
  sample clock and the downconversion LO (so the GPS clock-discipline
  loop has something real to measure);
- live LNAV bit stream: subframes 1-5 cycling with correct HOW TOW
  and D29*/D30* parity chaining, so the full frame-sync -> ephemeris
  -> transmit-time pipeline runs end to end.

Port of :mod:`flydog_sdr_gps_tpu.models.gps.scene`: the host parts and
the float64 host path are the reference's; the device path
(``_build_dev`` / ``_next_block_device``) is torch on the scene's
device, returning the block as a tensor there.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ... import _graphs
from ...numerology import (CA_CHIP_RATE, E1B_CODELEN, GALILEO_PRN_BASE,
                           GPS_FC, GPS_FS, L1_CODELEN)
from . import cacode, ephemeris, galileo, solver

F_L1 = 1575.42e6
OMEGA_E = ephemeris.OMEGA_E
C = solver.C_LIGHT


def ecef_from_lla(lat_deg: float, lon_deg: float, alt: float
                  ) -> np.ndarray:
    a, f = 6378137.0, 1 / 298.257223563
    e2 = f * (2 - f)
    lat, lon = math.radians(lat_deg), math.radians(lon_deg)
    n = a / math.sqrt(1 - e2 * math.sin(lat) ** 2)
    return np.array([
        (n + alt) * math.cos(lat) * math.cos(lon),
        (n + alt) * math.cos(lat) * math.sin(lon),
        (n * (1 - e2) + alt) * math.sin(lat)])


def make_ephemeris(prn: int, t0: float, omega0: float, m0: float,
                   af0: float = 0.0, af1: float = 0.0) -> ephemeris.Ephemeris:
    """A clean GPS orbit (a=26560 km, i=55 deg) through (omega0, m0)."""
    e = ephemeris.Ephemeris(prn=prn)
    e.week = 245
    toe = 16.0 * round(t0 / 16.0)
    e.toc = e.toe = toe
    e.af0, e.af1, e.af2 = af0, af1, 0.0
    e.iode = prn
    e.sqrt_a = math.sqrt(26560e3)
    e.e = 0.01
    e.i0 = 0.958
    e.omega0 = omega0
    e.m0 = m0
    e.omega = 0.6
    e.omega_dot = -8.0e-9
    e.idot = 2.0e-10
    e.delta_n = 4.5e-9
    e.crs, e.crc = 20.0, 180.0
    e.cuc, e.cus = 2.0e-6, 7.0e-6
    e.cic, e.cis = 5.0e-8, -6.0e-8
    # round-trip through the LNAV encoder so the scene's truth matches
    # what a receiver can possibly decode (field quantization)
    rt = ephemeris.Ephemeris(prn=prn)
    for sub in (1, 2, 3):
        ephemeris.decode_subframe(ephemeris.encode_subframe(sub, e), rt)
    rt.prn = prn
    return rt


def visible_constellation(rx_ecef: np.ndarray, t0: float,
                          n_sats: int = 8, min_el: float = 15.0,
                          seed: int = 0) -> dict[int, ephemeris.Ephemeris]:
    """Pick ``n_sats`` ephemerides whose satellites are above
    ``min_el`` degrees at ``t0`` from ``rx_ecef``."""
    rng = np.random.default_rng(seed)
    out = {}
    prn = 1
    for plane in range(6):
        for slot in range(8):
            if len(out) >= n_sats or prn > 32:
                return out
            om0 = plane * math.pi / 3 + 0.13
            m0 = slot * math.pi / 4 + 0.41 * plane
            af0 = float(rng.uniform(-2e-5, 2e-5))
            af1 = float(rng.uniform(-1e-11, 1e-11))
            eph = make_ephemeris(prn, t0, om0, m0, af0, af1)
            pos, _ = eph.sat_pos(t0)
            _az, el = solver.az_el(rx_ecef, pos)
            prn += 1
            if el >= min_el:
                out[eph.prn] = eph
    return out


def lnav_bitstream(eph: ephemeris.Ephemeris, t_start: float,
                   duration: float) -> tuple[float, np.ndarray]:
    """LNAV bits covering [t_start, t_start+duration] of SV time.

    Returns (t_bits0, bits +-1): ``t_bits0`` is the SV time of bit 0,
    aligned to a 6 s subframe boundary.  Subframes cycle 1..5 with
    correct HOW TOW and parity chaining (IS-GPS-200 20.3.2).
    """
    sf0 = int(t_start // 6.0) - 1
    nsf = int(duration / 6.0) + 3
    d29 = d30 = 0
    bits = []
    for k in range(nsf):
        sub = (sf0 + k) % 5 + 1
        tow_next = ((sf0 + k + 1) * 6.0) % 604800.0
        words = ephemeris.encode_subframe(sub, eph, tow_next=tow_next)
        for w24 in words:
            word = ephemeris.parity_encode(w24, d29, d30)
            for i in range(29, -1, -1):
                bits.append((word >> i) & 1)
            d29, d30 = (word >> 1) & 1, word & 1
    arr = np.asarray(bits, np.int8)
    return sf0 * 6.0, np.where(arr > 0, 1.0, -1.0).astype(np.float32)


def make_galileo_ephemeris(prn: int, t0: float, omega0: float, m0: float,
                           af0: float = 0.0, af1: float = 0.0
                           ) -> ephemeris.Ephemeris:
    """A clean Galileo orbit (a=29600 km, i=56 deg) through
    (omega0, m0), round-tripped through the I/NAV word codec so the
    scene's truth matches what a receiver can decode."""
    e = ephemeris.Ephemeris(prn=prn)
    e.week = 245
    e.toc = e.toe = 60.0 * round(t0 / 60.0)   # I/NAV toe LSB is 60 s
    e.af0, e.af1, e.af2 = af0, af1, 0.0
    e.iode = prn
    e.sqrt_a = math.sqrt(29600e3)
    e.e = 0.0003
    e.i0 = 0.978                              # ~56 deg
    e.omega0 = omega0
    e.m0 = m0
    e.omega = 0.3
    e.omega_dot = -5.6e-9
    e.idot = 1.5e-10
    e.delta_n = 3.0e-9
    e.crs, e.crc = 15.0, 120.0
    e.cuc, e.cus = 1.5e-6, 6.0e-6
    e.cic, e.cis = 4.0e-8, -5.0e-8
    rt = ephemeris.Ephemeris(prn=prn)
    for wt in (1, 2, 3, 4):
        galileo.decode_word(galileo.encode_word(wt, e), rt)
    rt.prn = prn
    rt.week = e.week
    rt.have = {1, 2, 3}
    return rt


def visible_galileo(rx_ecef: np.ndarray, t0: float, n_sats: int = 6,
                    min_el: float = 15.0, seed: int = 1
                    ) -> dict[int, ephemeris.Ephemeris]:
    """Pick ``n_sats`` Galileo ephemerides above ``min_el`` at ``t0``
    (keys are E1B SV ids 1..36)."""
    rng = np.random.default_rng(seed)
    out = {}
    prn = 1
    for plane in range(3):
        for slot in range(12):
            if len(out) >= n_sats or prn > 36:
                return out
            om0 = plane * 2 * math.pi / 3 + 0.7
            m0 = slot * math.pi / 6 + 0.9 * plane
            af0 = float(rng.uniform(-2e-5, 2e-5))
            af1 = float(rng.uniform(-1e-11, 1e-11))
            eph = make_galileo_ephemeris(prn, t0, om0, m0, af0, af1)
            pos, _ = eph.sat_pos(t0)
            _az, el = solver.az_el(rx_ecef, pos)
            prn += 1
            if el >= min_el:
                out[eph.prn] = eph
    return out


def inav_symbolstream(eph: ephemeris.Ephemeris, t_start: float,
                      duration: float) -> tuple[float, np.ndarray]:
    """I/NAV symbols (+-1 at 250 sym/s) covering
    [t_start, t_start+duration] of SV time.

    Returns (t_syms0, symbols): ``t_syms0`` is the GST of symbol 0,
    aligned to a 2 s nominal-page boundary.  Pages cycle word types
    1,2,3,4,5,0 (the ephemeris + GST words of the nominal sequence,
    OS SIS ICD 4.3.5); the TOW in words 5/0 dates each page start.
    """
    pg0 = int(t_start // 2.0) - 1
    npg = int(duration / 2.0) + 3
    cycle = (1, 2, 3, 4, 5, 0)
    syms = []
    for k in range(npg):
        t_page = (pg0 + k) * 2.0
        wt = cycle[(pg0 + k) % len(cycle)]
        w = galileo.encode_word(wt, eph, wn=eph.week,
                                tow=t_page % 604800.0)
        bits = galileo.encode_nominal_page(w)
        syms.extend((1.0 - 2.0 * bits).tolist())
    return pg0 * 2.0, np.asarray(syms, np.float32)


@dataclasses.dataclass
class _Sat:
    prn: int
    eph: ephemeris.Ephemeris
    code: np.ndarray
    t_bits0: float
    bits: np.ndarray
    code_len: int = L1_CODELEN
    boc: bool = False
    bit_dur: float = 0.02           # nav bit/symbol duration, s


class GpsScene:
    """Chunked generator of the 1-bit IF stream (a SampleSource for the
    GPS subsystem)."""

    def __init__(self, rx_ecef: np.ndarray,
                 ephemerides: dict[int, ephemeris.Ephemeris],
                 t0_gps: float, duration: float = 60.0,
                 fs: float = GPS_FS, fc: float = GPS_FC,
                 amplitude: float = 0.45, noise: float = 1.0,
                 clock_ppm: float = 0.0, one_bit: bool = True,
                 seed: int = 0,
                 galileo_ephemerides: dict[int, ephemeris.Ephemeris]
                 | None = None,
                 device: str | torch.device = "cuda",
                 use_graphs: bool | None = None):
        # "host": the float64 host path (numpy blocks); a torch device
        # (or its name): the device path there ("cpu" in the tests).
        # use_graphs (the device path; by default on a card): each
        # chunk's synthesis is a program over buffers the scene owns, a
        # CUDA graph per chunk length (the reference jits it); on the CPU
        # True runs the same static-buffer body with nothing captured
        self.device = device
        self._dev = None if device == "host" else torch.device(device)
        self._dev_consts = None
        self._dev_gen = None
        self._use_graphs = (self._dev is not None and self._dev.type == "cuda"
                            if use_graphs is None else use_graphs)
        self._graphs = None
        self._sky: dict[int, dict] = {}     # buffers per epochs a chunk
        self.rx = np.asarray(rx_ecef, float)
        self.fs = fs
        self.fc = fc
        self.t0 = t0_gps
        self.amplitude = amplitude
        self.noise = noise
        self.eps = clock_ppm * 1e-6     # fractional oscillator error
        self.one_bit = one_bit
        self.fs_true = fs * (1.0 + self.eps)
        self._rng = np.random.default_rng(seed)
        self._seed = seed
        self.ticks = 0                  # samples generated
        self.adc_clock = fs             # SampleSource duck-typing
        self.sats = []
        for prn, eph in ephemerides.items():
            t_b0, bits = lnav_bitstream(eph, t0_gps, duration + 2.0)
            self.sats.append(_Sat(
                prn=prn, eph=eph,
                code=cacode.ca_code_any(prn).astype(np.float32),
                t_bits0=t_b0, bits=bits))
        for prn, eph in (galileo_ephemerides or {}).items():
            # keyed internally as GALILEO_PRN_BASE + SV id to keep the
            # PRN namespace collision-free with Navstar 1-32
            t_s0, syms = inav_symbolstream(eph, t0_gps, duration + 4.0)
            self.sats.append(_Sat(
                prn=GALILEO_PRN_BASE + prn, eph=eph,
                code=galileo.e1b_code(prn).astype(np.float32),
                t_bits0=t_s0, bits=syms,
                code_len=E1B_CODELEN, boc=True, bit_dur=0.004))

    # -- truth accessors for assertions ----------------------------------
    def true_delay(self, prn: int, t: float) -> float:
        """Signal flight time (s) at reception GPS time t, including
        the earth-rotation term the solver corrects for."""
        eph = next(s.eph for s in self.sats if s.prn == prn)
        tau = 0.07
        for _ in range(4):
            pos, _clk = eph.sat_pos(t - tau)
            ang = OMEGA_E * tau
            ca, sa = math.cos(ang), math.sin(ang)
            rot = np.array([ca * pos[0] + sa * pos[1],
                            -sa * pos[0] + ca * pos[1], pos[2]])
            tau = float(np.linalg.norm(rot - self.rx)) / C
        return tau

    # -- device synthesis -------------------------------------------------
    # The host-numpy path below costs ~4.4 s of float64 trig per 0.4 s
    # chunk on a small host (measured for the reference) — 11x slower
    # than realtime.  With ``device`` set, the per-sample work runs on
    # that device: the host computes per-EPOCH (1 ms) linear phase/chip
    # coefficients in float64 (vectorized algebra on the same two-point
    # delay interpolation the host path uses), and the device evaluates
    # the f32 ramps, code/bit gathers, BOC sign and noise.  Per-epoch
    # rebasing keeps every f32 quantity small (phase ramp <= ~4.1e3
    # cycles, chip ramp <= 2 code periods), so the f32 error is
    # <= ~1e-3 chip/cycle — far below the scene's own noise floor.
    # Noise comes from a torch.Generator on the device seeded with
    # ``seed``: it cannot reproduce the reference's JAX random bits.
    def _build_dev(self):
        dev = self._dev
        codes = np.zeros((len(self.sats),
                          max(s.code_len for s in self.sats)),
                         np.float32)
        for i, s in enumerate(self.sats):
            codes[i, :s.code_len] = s.code
        lens = torch.as_tensor([s.code_len for s in self.sats],
                               dtype=torch.int64, device=dev)
        self._dev_consts = (torch.as_tensor(codes, device=dev), lens)
        self._dev_gen = torch.Generator(device=dev)
        self._dev_gen.manual_seed(self._seed)
        if self._use_graphs:
            self._graphs = _graphs.GraphSet(dev, generators=(self._dev_gen,))

    @property
    def graphs(self) -> dict:
        """The compiled sky's graphs ({} on the CPU or eager)."""
        return {} if self._graphs is None else self._graphs.graphs

    def _synth_compiled(self, epoch: int, coeffs: list[np.ndarray],
                        words: list[np.ndarray]) -> torch.Tensor:
        """The chunk as a program over buffers (one set a chunk length):
        the five float32 coefficient arrays ``coeffs`` (ph0, dph, flip_s,
        bit_a, bit_b) and the two int64 ``words`` (i0, s0) written into
        one of two pinned buffers and copied without blocking on the
        current stream, then :meth:`_synth` into the output buffer."""
        n_ep, ns = coeffs[0].shape
        dev = self._dev
        b = self._sky.get(n_ep)
        if b is None:
            pin = dev.type == "cuda"
            b = self._sky[n_ep] = dict(
                f=torch.zeros((5, n_ep, ns), dtype=torch.float32, device=dev),
                i=torch.zeros((2, n_ep, ns), dtype=torch.int64, device=dev),
                out=torch.zeros(n_ep * epoch, dtype=torch.float32,
                                device=dev),
                host=[[torch.zeros((5, n_ep, ns), dtype=torch.float32,
                                   pin_memory=pin),
                       torch.zeros((2, n_ep, ns), dtype=torch.int64,
                                   pin_memory=pin), None]
                      for _ in range(2)],
                turn=0)
        entry = b["host"][b["turn"]]
        b["turn"] ^= 1
        if entry[2] is not None:
            entry[2].synchronize()      # the card has read this buffer
        entry[0].numpy()[:] = np.stack([np.asarray(a, np.float32)
                                        for a in coeffs])
        entry[1].numpy()[:] = np.stack([np.asarray(a, np.int64)
                                        for a in words])
        b["f"].copy_(entry[0], non_blocking=True)
        b["i"].copy_(entry[1], non_blocking=True)
        if dev.type == "cuda":
            entry[2] = torch.cuda.Event()
            entry[2].record(torch.cuda.current_stream(dev))
        f, i = b["f"], b["i"]

        def body():
            b["out"].copy_(self._synth(epoch, f[0], f[1], i[0], i[1], f[2],
                                       f[3], f[4]))
        self._graphs.run(("sky", n_ep), body)
        return b["out"]

    def _synth(self, epoch: int, ph0, dph, i0, s0, flip_s, bit_a,
               bit_b) -> torch.Tensor:
        """The block from per-epoch coefficients (n_ep, n_sat) tensors:
        for each satellite the chip-window gather, the chip of sample j
        of an epoch as window[(16 + s0 + j) >> 4] (exactly 16 samples a
        chip: the reference's repeat(16) + dynamic_slice), BOC sign,
        the nav bit switched at its sample offset, times the cosine of
        the IF phase; summed, scaled, plus noise, hard-limited."""
        dev = self._dev
        codes, lens = self._dev_consts
        k = torch.arange(epoch, dtype=torch.float32, device=dev)
        k64 = k.double()
        jj = torch.arange(epoch, dtype=torch.int64, device=dev)
        nw = torch.arange(1027, dtype=torch.int64, device=dev)  # 1 ms + margin
        two_pi = np.float32(2 * np.pi)
        x = None
        for si, s in enumerate(self.sats):
            # one rounding of the ramp, the fused multiply-add the
            # reference's compiler makes of it (exact in float64 first)
            ph = (dph[:, si, None].double() * k64
                  + ph0[:, si, None].double()).float()
            ph = ph - torch.floor(ph)
            widx = torch.remainder(i0[:, si, None] - 1 + nw[None, :],
                                   lens[si])
            win = codes[si][widx]                        # (n_ep, 1027)
            pos = (16 + s0[:, si, None]) + jj[None, :]   # (n_ep, epoch)
            code = torch.gather(win, 1, pos >> 4)
            if s.boc:
                code = torch.where((pos & 15) < 8, code, -code)
            bit = torch.where(k[None, :] < flip_s[:, si, None],
                              bit_a[:, si, None], bit_b[:, si, None])
            term = code * bit * torch.cos(two_pi * ph)
            x = term if x is None else x + term
        x = np.float32(self.amplitude) * x
        if self.noise:
            x = x + np.float32(self.noise) * torch.randn(
                x.shape, generator=self._dev_gen, device=dev)
        x = x.reshape(-1)
        return torch.sign(x) if self.one_bit else x

    def _next_block_device(self, n: int) -> torch.Tensor:
        epoch = 16368                     # 1 ms at 16.368 Msps
        assert n % epoch == 0, "device scene needs whole-ms blocks"
        n_ep = n // epoch
        if self._dev_consts is None:
            self._build_dev()
        ns = len(self.sats)
        ph0 = np.zeros((n_ep, ns)); dph = np.zeros((n_ep, ns))
        i0 = np.zeros((n_ep, ns), np.int32)
        s0 = np.zeros((n_ep, ns), np.int32)
        bit_a = np.ones((n_ep, ns)); bit_b = np.ones((n_ep, ns))
        flip_s = np.full((n_ep, ns), 1e9)
        k0 = self.ticks + np.arange(n_ep, dtype=np.float64) * epoch
        t_e = self.t0 + k0 / self.fs_true     # epoch-start times (f64)
        t_a = float(t_e[0])
        t_b = self.t0 + (self.ticks + n - 1) / self.fs_true
        lo_rate = (F_L1 - self.fc) * (1.0 + self.eps)
        f_if = F_L1 - lo_rate
        span = max(t_b - t_a, 1e-12)
        for si, s in enumerate(self.sats):
            tau_a = self.true_delay(s.prn, t_a)
            tau_b = self.true_delay(s.prn, t_b)
            dtau_dt = (tau_b - tau_a) / span
            _pos, clk = s.eph.sat_pos(t_a - tau_a)
            tau_e = tau_a + (t_e - t_a) * dtau_dt
            tsv_e = t_e - tau_e + clk         # epoch-start SV time
            dtsv = (1.0 - dtau_dt) / self.fs_true   # d t_sv / sample
            ph_e = f_if * (t_e - self.t0) + F_L1 * (clk - tau_e)
            ph0[:, si] = np.mod(ph_e, 1.0)
            dph[:, si] = f_if / self.fs_true - F_L1 * dtau_dt \
                / self.fs_true
            chips_e = np.mod(tsv_e * CA_CHIP_RATE, float(s.code_len))
            i0[:, si] = np.floor(chips_e).astype(np.int32)
            s0[:, si] = np.round(
                (chips_e - np.floor(chips_e)) * 16.0).astype(np.int32)
            # nav bit per epoch; a flip mid-epoch switches at its
            # SAMPLE offset (exactly 16 samples per chip)
            bidx = np.floor((tsv_e - s.t_bits0) / s.bit_dur
                            ).astype(np.int64)
            bidx_end = np.floor(
                (tsv_e + epoch * dtsv - s.t_bits0) / s.bit_dur
            ).astype(np.int64)
            bi = np.clip(bidx, 0, len(s.bits) - 1)
            be = np.clip(bidx_end, 0, len(s.bits) - 1)
            bit_a[:, si] = s.bits[bi]
            bit_b[:, si] = s.bits[be]
            has_flip = bidx_end > bidx
            t_flip = s.t_bits0 + bidx_end * s.bit_dur
            flip_s[:, si] = np.where(
                has_flip, (t_flip - tsv_e) / dtsv, 1e9)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self._dev)

        def i64(a):
            return torch.as_tensor(np.asarray(a, np.int64),
                                   device=self._dev)
        if self._graphs is None:
            out = self._synth(epoch, f32(ph0), f32(dph), i64(i0), i64(s0),
                              f32(flip_s), f32(bit_a), f32(bit_b))
        else:
            out = self._synth_compiled(epoch, [ph0, dph, flip_s, bit_a,
                                               bit_b], [i0, s0])
        self.ticks += n
        # returned as a DEVICE tensor: the tracking kernel consumes it
        # in place, so the IF stream never crosses the host link; the
        # search path fetches a capture only when a search is due.  The
        # compiled sky's is its output buffer: the next chunk overwrites
        # it
        return out

    def next_block(self, n: int) -> np.ndarray:
        """Generate n IF samples (float32; hard-limited when one_bit)."""
        if self._dev is not None:
            return self._next_block_device(n)
        k = self.ticks + np.arange(n, dtype=np.float64)
        t = self.t0 + k / self.fs_true        # true GPS reception time
        x = (self.noise * self._rng.standard_normal(n)
             if self.noise else np.zeros(n))
        t_a, t_b = float(t[0]), float(t[-1])
        frac = (t - t_a) / max(t_b - t_a, 1e-12)
        lo_rate = (F_L1 - self.fc) * (1.0 + self.eps)
        for s in self.sats:
            tau_a = self.true_delay(s.prn, t_a)
            tau_b = self.true_delay(s.prn, t_b)
            tau = tau_a + (tau_b - tau_a) * frac
            _pos, clk = s.eph.sat_pos(t_a - tau_a)
            t_sv = t - tau + clk              # SV-clock transmit time
            chips = t_sv * CA_CHIP_RATE
            chip_idx = np.floor(chips).astype(np.int64)
            code = s.code[chip_idx % s.code_len]
            if s.boc:
                # BOC(1,1): +1 first half-chip, -1 second half-chip
                code = code * np.where(chips - chip_idx < 0.5, 1.0, -1.0)
            bidx = np.floor((t_sv - s.t_bits0) / s.bit_dur
                            ).astype(np.int64)
            bit = s.bits[np.clip(bidx, 0, len(s.bits) - 1)]
            # IF phase: RF phase minus the (oscillator-scaled) LO
            # phase, rebased to t0 so float64 keeps sub-cycle
            # precision at GPS week times (~3e5 s):
            #   F_L1*t_sv - lo_rate*t
            #     = (F_L1-lo_rate)*(t-t0) + F_L1*(clk-tau) + const
            f_if = F_L1 - lo_rate
            ph = f_if * (t - self.t0) + F_L1 * (clk - tau)
            x += self.amplitude * code * bit * np.cos(
                2 * np.pi * (ph - np.floor(ph)))
        self.ticks += n
        if self.one_bit:
            return np.sign(x).astype(np.float32)
        return x.astype(np.float32)
