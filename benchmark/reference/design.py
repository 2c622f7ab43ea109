"""The receiver's numerology, worked out from a configuration file.

Filter design by the rules the KiwiSDR-style chain states (Kaiser
windowed sinc lowpass stages whose stopbands start where they would
alias into the protected band; CuteSDR's complex passband filter; the
waterfall's decimate-by-4 stage and halfband cascade), the 48-bit tuning
words, and the fixed constants of the audio back half.  Float64 numpy
and scipy only: nothing here is taken from the program under test.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
from scipy import signal as sp_signal

PHASE_BITS = 48
MASK48 = (1 << PHASE_BITS) - 1

# audio back half (firmware defaults: CuteSDR AGC, wdsp SAM PLL, the
# KiwiSDR NR and LMS settings, S-meter attack, impulse blanker, squelch)
AGC = dict(delay=48, attack_ms=2.0, decay_ms=200.0, threshold_db=-100.0,
           slope_db=6.0, max_gain_db=84.0, out_target=0.5)
SAM = dict(bandwidth_hz=100.0, zeta=0.707, fmax_hz=1000.0)
NR = dict(fft=256, hop=128, smooth_alpha=0.3, min_window=8, floor_bias=2.2,
          over_subtract=1.4, gain_floor=0.1)
LMS = dict(taps=64, delay=16, mu=0.01, decay=0.9999)
SMETER_ATTACK = 0.2
SMETER_CAL_DBM = -13.0
NB = dict(gate_mult=4.0, width=7, alpha=0.02)
DC_R = 0.999
SQUELCH_TAIL = 12
N_RSSI = 65
MUTE_OVER_DBM = 20.0
PASSBAND_ATTEN_DB = 70.0

# waterfall
WF_FFT = 8192
WF_PX = 1024
WF_MAX_ZOOM = 14
WF_BASE_DECIM = 4
WF_BASE_TAPS = 32
WF_CAL_DB = -13.0
UI_SRATE = 30.0e6

MODES = {"am": 0, "amn": 1, "usb": 2, "lsb": 3, "cw": 4, "cwn": 5,
         "nbfm": 6, "iq": 7, "drm": 8, "sam": 9, "sal": 10, "sau": 11,
         "sas": 12}


def kaiser_beta(atten_db: float) -> float:
    if atten_db > 50.0:
        return 0.1102 * (atten_db - 8.7)
    if atten_db >= 21.0:
        return 0.5842 * (atten_db - 21.0) ** 0.4 + 0.07886 * (atten_db - 21.0)
    return 0.0


def kaiser_numtaps(atten_db: float, transition_hz: float, fs: float) -> int:
    dw = 2.0 * math.pi * transition_hz / fs
    n = int(math.ceil((max(atten_db, 21.0) - 7.95) / (2.285 * dw))) + 1
    return max(n, 9)


def kaiser_lowpass(fs, f_pass, f_stop, atten_db, numtaps=None, odd=False):
    """Unity-DC-gain Kaiser lowpass, cutoff mid-transition."""
    if numtaps is None:
        numtaps = kaiser_numtaps(atten_db, f_stop - f_pass, fs)
    if odd and numtaps % 2 == 0:
        numtaps += 1
    h = sp_signal.firwin(numtaps, 0.5 * (f_pass + f_stop),
                         window=("kaiser", kaiser_beta(atten_db)), fs=fs)
    return h / np.sum(h)


def decimation_stages(fs, decims, f_protect, atten_db):
    """Each stage's stopband starts at its output rate less the protected
    band edge; tap counts are whole multiples of the decimation."""
    taps, rate = [], fs
    for d in decims:
        out_rate = rate / d
        stop = out_rate - f_protect
        n = kaiser_numtaps(atten_db, stop - f_protect, rate)
        m = max(2, math.ceil(n / d))
        taps.append(kaiser_lowpass(rate, f_protect, stop, atten_db,
                                   numtaps=m * d))
        rate = out_rate
    return taps


def complex_bandpass(fs, f_lo, f_hi, atten_db, numtaps):
    """CuteSDR's passband: a lowpass of half the width, shifted to the
    passband's centre."""
    bw = f_hi - f_lo
    trans = max(0.1 * bw, 100.0)
    h = kaiser_lowpass(fs, min(bw / 2.0, 0.47 * fs),
                       min(bw / 2.0 + trans, 0.495 * fs), atten_db,
                       numtaps=numtaps, odd=True)
    n = np.arange(numtaps) - (numtaps - 1) / 2.0
    return h * np.exp(2j * np.pi * 0.5 * (f_lo + f_hi) * n / fs)


def halfband(atten_db: float = 80.0) -> np.ndarray:
    numtaps = kaiser_numtaps(atten_db, 0.06, 1.0) | 1
    if numtaps % 4 == 1:
        numtaps += 2
    h = sp_signal.firwin(numtaps, 0.5, window=("kaiser", kaiser_beta(atten_db)))
    h2 = np.zeros_like(h)
    h2[::2] = h[::2]
    h2[numtaps // 2] = 0.5
    return h2 / np.sum(h2)


def fcw(freq_hz: float, adc_clock: float) -> int:
    """48-bit frequency control word of a tuning."""
    return round(freq_hz / adc_clock * (1 << PHASE_BITS)) % (1 << PHASE_BITS)


@dataclasses.dataclass(frozen=True)
class Plan:
    """What one configuration file fixes."""
    adc_clock: float
    d1: int
    d2: int
    audio_block: int
    channels: int
    h1: np.ndarray
    h2: np.ndarray
    fft: int                 # passband FastFIR transform
    ntaps: int               # passband FastFIR taps

    @property
    def fs_out(self) -> float:
        return self.adc_clock / (self.d1 * self.d2)

    @property
    def l1(self) -> int:
        return len(self.h1)

    @property
    def l2(self) -> int:
        return len(self.h2)

    @property
    def k1(self) -> int:
        return self.audio_block * self.d2

    @property
    def adc_block(self) -> int:
        return self.k1 * self.d1

    @property
    def tail1(self) -> int:
        return self.l1 - self.d1

    @property
    def tail2(self) -> int:
        return self.l2 - self.d2

    @property
    def hop(self) -> int:
        return self.fft - self.ntaps + 1

    @property
    def block_s(self) -> float:
        return self.adc_block / self.adc_clock


def plan(cfg: dict) -> Plan:
    """The plan of a configuration file; raises where a length the file
    states is not what its rules give."""
    clock = float(cfg["adc_clock_hz"])
    d1, d2 = (int(v) for v in cfg["decims"])
    fs_out = clock / (d1 * d2)
    h1, h2 = decimation_stages(clock, (d1, d2),
                               cfg["f_protect_share"] * fs_out,
                               cfg["atten_db"])
    block = int(cfg["audio_block"])
    fft = 1024
    while fft < 2 * block:
        fft *= 2
    p = Plan(adc_clock=clock, d1=d1, d2=d2, audio_block=block,
             channels=int(cfg["channels"]), h1=h1, h2=h2, fft=fft,
             ntaps=fft - block + 1)
    for key, got in (("l1", p.l1), ("l2", p.l2), ("adc_block", p.adc_block)):
        if key in cfg and int(cfg[key]) != got:
            raise ValueError(f"{cfg.get('name')}: {key} is {got} by the "
                             f"design rules, the file says {cfg[key]}")
    return p


def passband_coef(p: Plan, lo: float, hi: float) -> np.ndarray:
    """(fft,) complex128 frequency-domain passband coefficients."""
    buf = np.zeros(p.fft, np.complex128)
    buf[:p.ntaps] = complex_bandpass(p.fs_out, lo, hi, PASSBAND_ATTEN_DB,
                                     p.ntaps)
    return np.fft.fft(buf)


def bank_column(p: Plan, word: int) -> np.ndarray:
    """(L1,) complex128 stage-1 column: the prototype, doubled (real to
    analytic), mixed down by the tuning word."""
    n = np.arange(p.l1, dtype=np.int64)
    ph = ((n * np.int64(word)) & MASK48).astype(np.float64) / 2.0 ** 48
    return 2.0 * p.h1 * np.exp(-2j * np.pi * ph)


def default_passband(mode: str) -> tuple[float, float]:
    return {"am": (-4900.0, 4900.0), "amn": (-2500.0, 2500.0),
            "usb": (300.0, 2700.0), "lsb": (-2700.0, -300.0),
            "cw": (300.0, 700.0), "cwn": (470.0, 530.0),
            "nbfm": (-5500.0, 5500.0), "iq": (-5000.0, 5000.0),
            "drm": (-5000.0, 5000.0), "sam": (-4900.0, 4900.0)}.get(
        mode, (300.0, 2700.0))


@dataclasses.dataclass(frozen=True)
class WfPlan:
    zoom: int
    adc_clock: float
    h_base: np.ndarray
    h_half: np.ndarray

    @property
    def total_decim(self) -> int:
        return WF_BASE_DECIM << self.zoom

    @property
    def span(self) -> float:
        return UI_SRATE / (1 << self.zoom)

    def ingest_blocks(self, adc_block: int) -> int:
        n = 1
        while (n * adc_block) % self.total_decim:
            n += 1
        return n


def wf_plan(zoom: int, adc_clock: float) -> WfPlan:
    h = kaiser_lowpass(adc_clock, 0.40 * adc_clock / WF_BASE_DECIM,
                       0.50 * adc_clock / WF_BASE_DECIM, 80.0,
                       numtaps=WF_BASE_TAPS)
    return WfPlan(zoom=zoom, adc_clock=adc_clock, h_base=h,
                  h_half=halfband(80.0))


def wf_centre(zoom: int, start_bin: int) -> float:
    """The centre frequency a client's "SET zoom= start=" asks for."""
    span = UI_SRATE / (1 << zoom)
    cf = start_bin * UI_SRATE / (WF_PX << WF_MAX_ZOOM) + span / 2
    return min(max(cf, span / 2), UI_SRATE)


def wf_start_bin(zoom: int, centre_hz: float) -> int:
    """The start bin that centres a view on ``centre_hz``."""
    span = UI_SRATE / (1 << zoom)
    return round((centre_hz - span / 2) / (UI_SRATE / (WF_PX << WF_MAX_ZOOM)))
