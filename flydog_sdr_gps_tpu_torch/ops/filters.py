"""FIR filter design (host-side, float64) for the signal chain.

The port's own copy of the designers it calls from
:mod:`flydog_sdr_gps_tpu.ops.filters` (numpy, scipy and the standard
library only; the port imports nothing of the reference package).  The
arithmetic is the reference's line for line, so the taps are bit-equal.

The reference gets from 125 Msps to 12 kHz with a CIC cascade
(multiplier-free integrator/comb stages, `verilog/rx/rx.v:72-140`) plus
a compensation FIR that undoes CIC passband droop
(`verilog/rx/fir_iq.sv`, coefficients from `tools/FIR.m`).  CICs exist
because FPGA multipliers are scarce; on an accelerator multipliers are
the *cheapest* resource, so this design uses true lowpass
polyphase FIR stages — flatter passband, better alias rejection, no
droop compensation needed.

Design rules follow standard multistage decimation: stage ``i`` with
output rate ``fs_i`` only needs to attenuate the bands that alias into
the final passband, i.e. its stopband starts at ``fs_i - f_stop_final``.
That keeps early (high-rate) stages short.

CuteSDR's windowed-sinc designer (`rx/CuteSDR/fir.cpp:41-196`) computes
Kaiser-windowed lowpass taps from (atten, f_pass, f_stop); we keep those
exact semantics in :func:`kaiser_lowpass` so user-facing passband
filters behave identically.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
from scipy import signal as sp_signal


def kaiser_beta(atten_db: float) -> float:
    """Kaiser beta for a given stopband attenuation (same rule as
    CuteSDR `rx/CuteSDR/fir.cpp:86-93` and Kaiser's published formula)."""
    if atten_db > 50.0:
        return 0.1102 * (atten_db - 8.7)
    if atten_db >= 21.0:
        return 0.5842 * (atten_db - 21.0) ** 0.4 + 0.07886 * (atten_db - 21.0)
    return 0.0


def kaiser_numtaps(atten_db: float, transition_hz: float, fs: float) -> int:
    """Kaiser tap estimate: N ~= (A - 7.95) / (2.285 * 2*pi*dF/fs)."""
    dw = 2.0 * math.pi * transition_hz / fs
    n = int(math.ceil((max(atten_db, 21.0) - 7.95) / (2.285 * dw))) + 1
    return max(n, 9)


def kaiser_lowpass(fs: float, f_pass: float, f_stop: float,
                   atten_db: float, numtaps: int | None = None,
                   odd: bool = False) -> np.ndarray:
    """Kaiser-window lowpass, unity DC gain, float64 taps.

    Cutoff placed mid-transition, as CuteSDR does
    (`rx/CuteSDR/fir.cpp:100-110`).
    """
    if numtaps is None:
        numtaps = kaiser_numtaps(atten_db, f_stop - f_pass, fs)
    if odd and numtaps % 2 == 0:
        numtaps += 1
    beta = kaiser_beta(atten_db)
    cutoff = 0.5 * (f_pass + f_stop)
    h = sp_signal.firwin(numtaps, cutoff, window=("kaiser", beta), fs=fs)
    return h / np.sum(h)


def complex_bandpass(fs: float, f_lo: float, f_hi: float, atten_db: float,
                     numtaps: int) -> np.ndarray:
    """Complex (analytic) bandpass by frequency-shifting a lowpass.

    Same construction as CuteSDR's passband filter generator
    (`rx/CuteSDR/fir.cpp:198-255`): design a real lowpass of half the
    passband width, then heterodyne it to the passband center.
    """
    bw = f_hi - f_lo
    if bw <= 0:
        raise ValueError("f_hi must exceed f_lo")
    center = 0.5 * (f_lo + f_hi)
    # transition width: make it a fraction of bandwidth, floor of 100 Hz
    trans = max(0.1 * bw, 100.0)
    # clamp below Nyquist (a full-band passband like NBFM's +-6 kHz at
    # a 12 kHz rate would otherwise land the cutoff exactly on fs/2)
    pass_edge = min(bw / 2.0, 0.47 * fs)
    stop_edge = min(bw / 2.0 + trans, 0.495 * fs)
    h = kaiser_lowpass(fs, pass_edge, stop_edge, atten_db,
                       numtaps=numtaps, odd=True)
    n = np.arange(numtaps) - (numtaps - 1) / 2.0
    return h * np.exp(2j * np.pi * center * n / fs)


def design_decimation_stages(fs: float, decims: Sequence[int],
                             f_protect: float,
                             atten_db: float = 90.0,
                             taps_mult: Sequence[int] | None = None,
                             ) -> list[np.ndarray]:
    """Design the multistage decimation chain.

    ``f_protect`` is the alias-protected band edge: every stage's
    stopband starts at ``out_rate_i - f_protect`` so that nothing folds
    into [0, f_protect] with less than ``atten_db`` rejection.  Energy
    between f_protect and the final Nyquist passes with droop/partial
    aliasing — the same compromise the reference's CIC chain makes near
    its band edge.

    Each stage's tap count is rounded UP to a multiple of its decimation
    factor (the polyphase/framing matmul requires taps = m * D).

    Returns float64 tap arrays, each with unity DC gain.
    """
    taps = []
    rate = fs
    for i, d in enumerate(decims):
        out_rate = rate / d
        stop = out_rate - f_protect     # first alias edge folding to band
        if stop <= f_protect:
            raise ValueError(
                f"stage {i}: output rate {out_rate} too low for "
                f"f_protect={f_protect}")
        n = kaiser_numtaps(atten_db, stop - f_protect, rate)
        m = max(2, math.ceil(n / d))
        if taps_mult is not None:
            m = max(m, taps_mult[i])
        h = kaiser_lowpass(rate, f_protect, stop, atten_db, numtaps=m * d)
        taps.append(h)
        rate = out_rate
    return taps


def halfband(atten_db: float = 90.0, numtaps: int | None = None) -> np.ndarray:
    """Decimate-by-2 halfband lowpass (every other tap zero except center).

    Used by the waterfall zoom cascade (decimation = 2**zoom, reference
    `verilog/rx/waterfall_1cic.v` uses a 1-stage CIC; we use halfbands
    for a flat passband over the displayed 1024 px span).
    """
    if numtaps is None:
        # quarter-band transition: passband to 0.22 fs, stop from 0.28 fs
        numtaps = kaiser_numtaps(atten_db, 0.06, 1.0)
        numtaps |= 1                     # odd
        if numtaps % 4 == 1:
            numtaps += 2                 # N % 4 == 3 gives true halfband
    h = sp_signal.firwin(numtaps, 0.5, window=("kaiser", kaiser_beta(atten_db)))
    # force exact halfband structure: odd taps (except center) to zero
    mid = numtaps // 2
    h2 = np.zeros_like(h)
    h2[::2] = h[::2]
    h2[mid] = 0.5
    return h2 / np.sum(h2)


def fir_freq_response(h: np.ndarray, freqs_hz: np.ndarray, fs: float
                      ) -> np.ndarray:
    """Exact frequency response H(f) of FIR taps at given frequencies."""
    n = np.arange(len(h))
    return np.asarray(h) @ np.exp(-2j * np.pi *
                                  np.outer(n, np.asarray(freqs_hz) / fs))
