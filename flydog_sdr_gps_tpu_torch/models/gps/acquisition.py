"""GPS acquisition: FFT code-Doppler search over (satellite, Doppler).

Port of :mod:`flydog_sdr_gps_tpu.models.gps.acquisition`.  Reference
(`gps/search.cpp:140-498`): 16.368 Msps 1-bit IF samples are
quadrature-mixed by the 4.092 MHz LO, decimated x4 to 4.092 Msps,
forward-FFT'd once (16384 pt = 4 ms); then per satellite the
precomputed conjugate code FFT is multiplied at 41 Doppler shifts
(+-5 kHz in ~250 Hz bins = one FFT bin per step) and inverse-FFT'd;
the peak magnitude vs average gives SNR, the peak index the code
phase.

The JAX package computes the plane with plain XLA (split re/im and a
matmul FFT, because its TPU has neither complex numbers nor an FFT);
here it is complex64 and ``torch.fft`` on the tensor's device: one
batched inverse FFT of the whole (satellite x Doppler) plane.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ...numerology import (GPS_ACQ_FFT, GPS_ACQ_FS, GPS_DOPPLER_MAX,
                           GPS_DOPPLER_STEP, GPS_FC, GPS_FS, L1_CODELEN)
from . import cacode


@dataclasses.dataclass(frozen=True, eq=False)
class AcqParams:
    fs_if: float = GPS_FS            # raw IF sample rate
    fc: float = GPS_FC               # IF center frequency
    fs: float = GPS_ACQ_FS           # decimated rate (fs_if / decim)
    fft_len: int = GPS_ACQ_FFT       # 16384 (4 ms @ 4.092 Msps)
    doppler_max: float = GPS_DOPPLER_MAX
    doppler_step: float = GPS_DOPPLER_STEP

    @property
    def decim(self) -> int:
        return int(round(self.fs_if / self.fs))

    @property
    def n_raw(self) -> int:
        return self.fft_len * self.decim

    @property
    def n_doppler(self) -> int:
        return 2 * int(self.doppler_max / self.doppler_step) + 1


def downsample_if(params: AcqParams, raw: torch.Tensor) -> torch.Tensor:
    """1-bit (+-1) IF samples (n_raw,) float32 -> baseband complex64
    (fft_len,) at fs.

    Mix by exp(-j*2*pi*fc*t) and box-average by ``decim`` — float
    version of the reference's XOR quadrature mix + binary decimator
    (`gps/search.cpp:140-180`).  fc / fs_if = 4.092/16.368 = exactly
    1/4: the LO cycles through (1, -j, -1, j), so each group of four
    samples (x0, x1, x2, x3) sums to (x0 - x2) + j(x3 - x1) — two
    nonzero terms a part, one rounding each, so the result is exactly
    the reference's sum in any order.
    """
    g = raw[:params.n_raw].to(torch.float32).reshape(params.fft_len, 4)
    return torch.complex(g[:, 0] - g[:, 2], g[:, 3] - g[:, 1])


@functools.lru_cache(maxsize=8)
def code_ffts(params: AcqParams, prns: tuple[int, ...]) -> np.ndarray:
    """Host-precomputed conjugated code FFTs, complex64 (nsat, fft_len).

    Mirrors `gps/search.cpp:239-357` (one FFT per PRN at startup).
    """
    out = np.zeros((len(prns), params.fft_len), np.complex64)
    for i, prn in enumerate(prns):
        code = cacode.ca_code_sampled(prn, params.fs, params.fft_len)
        out[i] = np.conj(np.fft.fft(code))
    return out


def acquire_power(params: AcqParams, baseband: torch.Tensor,
                  code_fft: torch.Tensor) -> torch.Tensor:
    """Correlation power plane (nsat, n_doppler, fft_len) float32 for one
    4 ms window (the inner loop of `gps/search.cpp:453-498`).

    baseband: (fft_len,) complex64; code_fft: (nsat, fft_len) complex64.
    """
    nd = params.n_doppler
    half = nd // 2
    n = params.fft_len
    x = torch.fft.fft(baseband)                        # (fft_len,)
    # Doppler shift = circular roll of the DATA spectrum by d bins (bin
    # width fs/fft_len ~= 249.8 Hz ~= doppler_step): row d of xs is
    # roll(x, -(d - half)), i.e. xs[d, k] = x[(k + d - half) mod n]
    k = torch.arange(n, device=x.device)
    d = torch.arange(nd, device=x.device) - half
    xs = x[torch.remainder(k[None, :] + d[:, None], n)]     # (nd, n)
    corr = torch.fft.ifft(xs[None, :, :] * code_fft[:, None, :])
    return corr.real.square() + corr.imag.square()


def peak_from_power(params: AcqParams, power: torch.Tensor,
                    code_period_samples: int | None = None,
                    chips_per_period: int = L1_CODELEN):
    """Reduce a (summed) power plane to per-sat (snr, cp, doppler), each
    a (nsat,) float32 tensor on the plane's device."""
    nd = params.n_doppler
    half = nd // 2
    nsat = power.shape[0]
    # only one code period of lags is distinct; the peak repeats
    samps_per_code = code_period_samples or \
        int(round(params.fs / 1.023e6 * L1_CODELEN))
    p1 = power[:, :, :samps_per_code]
    flat = p1.reshape(nsat, -1)
    peak, arg = torch.max(flat, dim=1)
    mean = power.mean(dim=(1, 2))
    dop_idx = torch.div(arg, samps_per_code, rounding_mode="floor")
    phase_idx = arg % samps_per_code
    snr = peak / torch.clamp(mean, min=1e-20)
    doppler_hz = (dop_idx.to(torch.float32) - half) * \
        np.float32(params.fs / params.fft_len)
    # peak lag tau satisfies data[n] ~ code[n - tau]; the tracking
    # handoff wants cp with data[n] ~ code[cp + n], i.e. cp = -tau
    code_phase = torch.remainder(
        (samps_per_code - phase_idx).to(torch.float32),
        float(samps_per_code)) * np.float32(chips_per_period
                                            / samps_per_code)
    return snr, code_phase, doppler_hz


def acquire(params: AcqParams, baseband: torch.Tensor,
            code_fft: torch.Tensor, code_period_samples: int | None = None,
            chips_per_period: int = L1_CODELEN):
    """Search the (sat, Doppler) plane for one window.

    baseband: (fft_len,) decimated IF block, complex64.
    code_fft: (nsat, fft_len) conjugated code spectra, complex64.
    code_period_samples: lag-search span (one code period); defaults
    to the C/A 1 ms period (4092 samples at 4.092 Msps).  Galileo E1B
    passes its 4 ms period (= the whole window).

    Returns (snr, code_phase, doppler_hz) per satellite, where SNR is
    peak power / mean power (the reference's test statistic,
    `gps/search.cpp:453-498`).
    """
    power = acquire_power(params, baseband, code_fft)
    return peak_from_power(params, power, code_period_samples,
                           chips_per_period)


def acquire_all(params: AcqParams, raw, prns: tuple[int, ...],
                batch: int = 8, device: torch.device | str | None = None):
    """Host convenience: full cold search over ``prns``.

    ``raw`` is a numpy array (uploaded to ``device``, the card unless the
    caller asks for the CPU) or a tensor (searched where it lies).
    Returns list of dicts sorted by SNR.  Batches satellites to bound
    device memory ((batch, 41, 16384) complex64 planes, 43 MB at 8).
    """
    if isinstance(raw, torch.Tensor):
        raw_t = raw.to(device) if device is not None else raw
    else:
        raw_t = torch.as_tensor(np.asarray(raw, np.float32),
                                device=device or "cuda")
    bb = downsample_if(params, raw_t)
    cf_all = code_ffts(params, tuple(prns))
    results = []
    for i in range(0, len(prns), batch):
        cf = torch.as_tensor(cf_all[i:i + batch], device=bb.device)
        snr, cp, dop = (v.cpu().numpy() for v in acquire(params, bb, cf))
        for j in range(cf.shape[0]):
            results.append(dict(
                prn=prns[i + j], snr=float(snr[j]),
                code_phase=float(cp[j]), doppler=float(dop[j])))
    results.sort(key=lambda r: -r["snr"])
    return results
