"""Demodulators: AM / SAM / SSB / CW / NBFM / IQ, channel-vectorized.

Port of :mod:`flydog_sdr_gps_tpu.ops.demod` (`rx/rx_sound.cpp:707-987`).
Everything is elementwise over (N, C) blocks except the SAM PLL, which
is sequential in time: the reference runs it as a ``lax.scan``
(`demod.py:183-195`); here it is :func:`sam_pll`, the CUDA kernel
``sam_pll_c64`` (``csrc/scans.cu``, one thread per channel) for a CUDA
tensor and its plain PyTorch loop for a tensor on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _build
from . import iir
from .smeter import abs2

# mode ids (wire-compatible naming with the reference's mode strings,
# `rx/rx_cmd.cpp` "SET mod=")
MODE_AM, MODE_AMN, MODE_USB, MODE_LSB, MODE_CW, MODE_CWN = range(6)
MODE_NBFM, MODE_IQ, MODE_DRM, MODE_SAM, MODE_SAL, MODE_SAU, MODE_SAS = \
    range(6, 13)

SSB_LIKE = (MODE_USB, MODE_LSB, MODE_CW, MODE_CWN)

MODE_NAMES = {
    "am": MODE_AM, "amn": MODE_AMN, "usb": MODE_USB, "lsb": MODE_LSB,
    "cw": MODE_CW, "cwn": MODE_CWN, "nbfm": MODE_NBFM, "iq": MODE_IQ,
    "drm": MODE_DRM, "sam": MODE_SAM, "sal": MODE_SAL, "sau": MODE_SAU,
    "sas": MODE_SAS,
}
MODE_IDS = {v: k for k, v in MODE_NAMES.items()}


def am_demod(z: torch.Tensor, dc_state: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Envelope detector + DC removal.  z: (N, C) complex64."""
    return iir.dc_blocker(torch.sqrt(abs2(z)), dc_state)


def ssb_demod(z: torch.Tensor) -> torch.Tensor:
    """Sideband selection happened in the passband filter; the demod is
    the real part (`rx_sound.cpp:885-892`)."""
    return z.real


def fm_demod(z: torch.Tensor, last: torch.Tensor, fs: float,
             deviation=2500.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Quadri-correlator discriminator (csdr-style, `rx_sound.cpp:846-871`):
    audio[n] = angle(z[n] * conj(z[n-1])) * fs / (2*pi*deviation).
    ``last``: (C,) carry of the previous block's final sample."""
    zprev = torch.cat([last[None], z[:-1]])
    # same split-complex arithmetic as the reference's Cplx multiply
    dr = z.real * zprev.real + z.imag * zprev.imag
    di = z.imag * zprev.real - z.real * zprev.imag
    scale = fs / (2.0 * np.pi) / deviation
    return torch.atan2(di, dr) * scale, z[-1]


@dataclasses.dataclass
class SquelchState:
    noise: torch.Tensor   # (C,) float32 smoothed ultrasonic noise power
    open_: torch.Tensor   # (C,) bool gate state
    tail: torch.Tensor    # (C,) int32 tail countdown (blocks)


def init_squelch_state(num_channels: int,
                       device: torch.device | str) -> SquelchState:
    return SquelchState(
        noise=torch.ones(num_channels, dtype=torch.float32, device=device),
        open_=torch.zeros(num_channels, dtype=torch.bool, device=device),
        tail=torch.zeros(num_channels, dtype=torch.int32, device=device),
    )


def fm_squelch(audio: torch.Tensor, state: SquelchState,
               threshold: torch.Tensor, tail_blocks: int = 12
               ) -> tuple[torch.Tensor, SquelchState]:
    """FM noise squelch (`rx/CuteSDR/squelch.cpp`): smoothed power of the
    first difference, gated with a tail; ``threshold`` <= 0 is open."""
    hf = audio[1:] - audio[:-1]
    noise = 0.8 * state.noise + 0.2 * torch.mean(hf * hf, dim=0)
    opening = (noise < threshold) | (threshold <= 0.0)
    tail = torch.where(opening, tail_blocks,
                       torch.clamp(state.tail - 1, min=0)).to(torch.int32)
    open_now = opening | (tail > 0)
    y = torch.where(open_now[None, :], audio, 0.0)
    return y, SquelchState(noise=noise, open_=open_now, tail=tail)


# ---------------------------------------------------------------------------
# SAM (synchronous AM) — PLL carrier recovery
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class SamParams:
    """2nd-order PLL loop constants (wdsp `SAM_demod.cpp` zeta/omegaN)."""
    fs: float = 12_000.0
    bandwidth_hz: float = 100.0     # loop natural frequency
    zeta: float = 0.707
    fmax_hz: float = 1_000.0        # carrier pull-in limit

    @property
    def g1(self) -> float:
        wn = 2 * np.pi * self.bandwidth_hz
        return float(2 * self.zeta * wn / self.fs)

    @property
    def g2(self) -> float:
        wn = 2 * np.pi * self.bandwidth_hz
        return float(wn * wn / (self.fs * self.fs))

    @property
    def fmax(self) -> float:
        """Pull-in limit in rad/sample."""
        return float(2 * np.pi * self.fmax_hz / self.fs)


@dataclasses.dataclass
class SamState:
    phase: torch.Tensor   # (C,) float32 radians
    freq: torch.Tensor    # (C,) float32 rad/sample
    dc: torch.Tensor      # (2, C) float32 dc-blocker state


def init_sam_state(num_channels: int,
                   device: torch.device | str) -> SamState:
    return SamState(
        phase=torch.zeros(num_channels, dtype=torch.float32, device=device),
        freq=torch.zeros(num_channels, dtype=torch.float32, device=device),
        dc=torch.zeros((2, num_channels), dtype=torch.float32,
                       device=device),
    )


def sam_pll_plain(params: SamParams, z: torch.Tensor, phase: torch.Tensor,
                  freq: torch.Tensor):
    """Plain version: the reference scan step as a loop over samples."""
    g1 = torch.tensor(params.g1, dtype=torch.float32, device=z.device)
    g2 = torch.tensor(params.g2, dtype=torch.float32, device=z.device)
    fmax = float(np.float32(params.fmax))
    pi, two_pi = float(np.float32(np.pi)), float(np.float32(2 * np.pi))
    zr, zi = z.real, z.imag
    v = torch.empty_like(z)
    for n in range(z.shape[0]):
        c, s = torch.cos(phase), -torch.sin(phase)
        vr = zr[n] * c - zi[n] * s
        vi = zr[n] * s + zi[n] * c
        err = torch.atan2(vi, vr)
        freq = torch.clamp(freq + g2 * err, -fmax, fmax)
        p2 = phase + freq + g1 * err
        phase = torch.where(p2 > pi, p2 - two_pi,
                            torch.where(p2 < -pi, p2 + two_pi, p2))
        v[n] = torch.complex(vr, vi)
    return v, phase, freq


def sam_pll(params: SamParams, z: torch.Tensor, phase0: torch.Tensor,
            freq0: torch.Tensor):
    """Per-sample PLL over (N, C) complex64; returns the carrier-locked
    baseband v (N, C) and the final (phase, freq) (C,)."""
    if z.device.type == "cpu":
        return sam_pll_plain(params, z, phase0, freq0)
    _build.require_cuda(z, "sam_pll")
    z = z.contiguous()
    n, c = z.shape
    v = torch.empty_like(z)
    phase = phase0.to(torch.float32).clone()
    freq = freq0.to(torch.float32).clone()
    stream = torch.cuda.current_stream(z.device).cuda_stream
    err = _build.lib().sam_pll_c64(
        z.data_ptr(), v.data_ptr(), phase.data_ptr(), freq.data_ptr(), n, c,
        params.g1, params.g2, params.fmax, stream)
    _build.check(err, "sam_pll_c64")
    sam_pll.launches += 1
    return v, phase, freq


sam_pll.launches = 0


def sam_demod(params: SamParams, z: torch.Tensor, state: SamState
              ) -> tuple[torch.Tensor, torch.Tensor, SamState]:
    """Carrier-locked AM demod: (audio (N, C) — the DC-blocked in-phase
    envelope, the locked baseband v (N, C), new state)."""
    v, phase, freq = sam_pll(params, z, state.phase, state.freq)
    audio, new_dc = iir.dc_blocker(v.real, state.dc)
    return audio, v, SamState(phase=phase, freq=freq, dc=new_dc)


# ---------------------------------------------------------------------------
# all-mode RSSI squelch (`rx/rx_sound.cpp:951-987`)
# ---------------------------------------------------------------------------

N_RSSI = 65                     # rx/rx_sound.cpp:291; odd, so the lower
                                # median torch.median returns is THE median


@dataclasses.dataclass
class RssiSquelchState:
    ring: torch.Tensor    # (N_RSSI, C) float32 RSSI noise-floor samples
    count: torch.Tensor   # () int32 samples collected
    open_: torch.Tensor   # (C,) bool gate state
    tail: torch.Tensor    # (C,) int32 tail countdown (blocks)


def init_rssi_squelch(num_channels: int,
                      device: torch.device | str) -> RssiSquelchState:
    return RssiSquelchState(
        ring=torch.zeros((N_RSSI, num_channels), dtype=torch.float32,
                         device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
        open_=torch.zeros(num_channels, dtype=torch.bool, device=device),
        tail=torch.zeros(num_channels, dtype=torch.int32, device=device),
    )


def rssi_squelch(audio: torch.Tensor, smeter_dbm: torch.Tensor,
                 state: RssiSquelchState, squelch_db: torch.Tensor,
                 tail_blocks: int = 12
                 ) -> tuple[torch.Tensor, RssiSquelchState]:
    """Non-NBFM squelch: the floor is the median of recent block RSSI
    values (collected while closed); open at median + squelch_db with
    6 dB hysteresis and a tail.  squelch_db <= 0 disables (open).
    Device-side throughout: no host sync."""
    active = squelch_db > 0.0
    idx = (state.count % N_RSSI).to(torch.int64).reshape(1)
    newrow = torch.where(state.open_ & active,
                         state.ring.index_select(0, idx)[0], smeter_dbm)
    ring = state.ring.index_copy(0, idx, newrow[None])
    count = state.count + 1
    med = torch.median(ring, dim=0).values
    thresh = med + squelch_db - torch.where(state.open_, 6.0, 0.0)
    green = smeter_dbm >= thresh
    tail = torch.where(green, tail_blocks,
                       torch.clamp(state.tail - 1, min=0)).to(torch.int32)
    open_now = (count >= N_RSSI) & (green | (tail > 0))
    y = torch.where((~active | open_now)[None, :], audio, 0.0)
    return y, RssiSquelchState(ring=ring, count=count,
                               open_=open_now & active, tail=tail)
