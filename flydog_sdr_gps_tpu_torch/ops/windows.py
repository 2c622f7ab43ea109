"""Spectral window functions.

The port's own copy of :mod:`flydog_sdr_gps_tpu.ops.windows` (numpy
only; the port imports nothing of the reference package).

The reference waterfall offers Hanning / Hamming / Blackman-Harris
windows (`rx/rx_waterfall.cpp:144-170`); the audio-FFT tap and WSPR/FT8
front ends use Hanning.  These are periodic (DFT-even) windows computed
host-side in float64 and shipped to the device as float32 constants.
"""

from __future__ import annotations

import numpy as np

HANNING = "hanning"
HAMMING = "hamming"
BLACKMAN_HARRIS = "blackman-harris"
RECTANGULAR = "rectangular"


def window(kind: str, n: int, periodic: bool = True) -> np.ndarray:
    """Return an ``n``-point window as float32 (numpy, host side)."""
    m = n if periodic else n - 1
    k = np.arange(n, dtype=np.float64)
    if kind == RECTANGULAR:
        w = np.ones(n)
    elif kind == HANNING:
        w = 0.5 - 0.5 * np.cos(2 * np.pi * k / m)
    elif kind == HAMMING:
        w = 0.54 - 0.46 * np.cos(2 * np.pi * k / m)
    elif kind == BLACKMAN_HARRIS:
        # 4-term minimum sidelobe (-92 dB), as used by the reference WF
        a = (0.35875, 0.48829, 0.14128, 0.01168)
        w = (a[0]
             - a[1] * np.cos(2 * np.pi * k / m)
             + a[2] * np.cos(4 * np.pi * k / m)
             - a[3] * np.cos(6 * np.pi * k / m))
    else:
        raise ValueError(f"unknown window {kind!r}")
    return w.astype(np.float32)


def coherent_gain(w: np.ndarray) -> float:
    """Sum(w)/N — scale factor for amplitude-accurate spectra."""
    return float(np.mean(np.asarray(w, np.float64)))


def noise_bandwidth(w: np.ndarray) -> float:
    """Equivalent noise bandwidth in bins (for noise-floor calibration)."""
    w = np.asarray(w, np.float64)
    return float(len(w) * np.sum(w * w) / np.sum(w) ** 2)
