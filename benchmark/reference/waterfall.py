"""Plain reference of a waterfall row.

A waterfall channel mixes the ADC stream down to its view's centre with
an exact 48-bit NCO, filters and decimates by 4, halves the rate once
per zoom step with a halfband filter, keeps the newest 8192 samples,
and a row is their Hann-windowed FFT, each pixel the mean power of the
bins it covers, in dB.  :func:`row` runs that chain from a zero state
over consecutive ADC blocks; the program's channel started from a zero
state at the stream's first block, and once the ring holds only samples
made after the filters settled, the two rings differ by one constant
phase, which no power spectrum sees.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import design as dz
from .receiver import matmul, ramp_words, rotator


@functools.lru_cache(maxsize=8)
def pixel_members(frac: float) -> tuple[np.ndarray, np.ndarray]:
    """(pixels, most bins) bin indices of each pixel (padded with
    WF_FFT, the index of a zero), and each pixel's bin count."""
    used = dz.WF_FFT * frac
    b0 = (dz.WF_FFT - used) / 2.0
    seg = np.full(dz.WF_FFT, dz.WF_PX, np.int64)
    for px in range(dz.WF_PX):
        lo = b0 + used * px / dz.WF_PX
        hi = b0 + used * (px + 1) / dz.WF_PX
        ilo, ihi = int(np.ceil(lo - 1e-9)), int(np.ceil(hi - 1e-9))
        seg[max(ilo, 0):min(max(ihi, ilo + 1), dz.WF_FFT)] = px
    count = np.bincount(seg, minlength=dz.WF_PX + 1)[:dz.WF_PX]
    members = np.full((dz.WF_PX, max(int(count.max()), 1)), dz.WF_FFT)
    for px in range(dz.WF_PX):
        b = np.flatnonzero(seg == px)
        members[px, :len(b)] = b
    return members, count


def blocks_needed(wp: dz.WfPlan, adc_block: int) -> int:
    """ADC blocks a row's ring spans, with one more for the filters to
    settle, rounded up to whole ingests."""
    need = wp.ingest_blocks(adc_block)
    span = dz.WF_FFT * wp.total_decim
    n = -(-span // adc_block) + 1
    return -(-n // need) * need


def row_db(wp: dz.WfPlan, centre_hz: float, blocks: list[torch.Tensor],
           prec: str = "ref") -> np.ndarray:
    """(1024,) dB row after the chain has consumed ``blocks`` (each one
    ADC block, consecutive, starting at an ingest boundary) from a zero
    state."""
    dev = blocks[0].device
    real = torch.float64 if prec == "ref" else torch.float32
    word = dz.fcw(centre_hz, wp.adc_clock)
    n = np.arange(len(wp.h_base), dtype=np.int64)
    ph = ((n * np.int64(word)) & dz.MASK48).astype(np.float64) / 2.0 ** 48
    bank = torch.as_tensor(wp.h_base * np.exp(-2j * np.pi * ph), device=dev)
    if prec != "ref":
        bank = bank.to(torch.complex64)
    dphi = (word * dz.WF_BASE_DECIM) & dz.MASK48
    d, taps = dz.WF_BASE_DECIM, len(wp.h_base)
    lp = 2 * ((len(wp.h_half) + 1) // 2)
    hh = np.zeros(lp)
    hh[:len(wp.h_half)] = wp.h_half
    hh = torch.as_tensor(hh, device=dev).to(real)[:, None]
    cplx = torch.complex128 if prec == "ref" else torch.complex64
    base_tail = torch.zeros(taps - d, dtype=real, device=dev)
    hb_tails = [torch.zeros(lp - 2, dtype=cplx, device=dev)
                for _ in range(wp.zoom)]
    ring = torch.zeros(dz.WF_FFT, dtype=cplx, device=dev)
    phi = 0
    need = wp.ingest_blocks(blocks[0].shape[0])
    for i in range(0, len(blocks), need):
        x = torch.cat([b.to(real) for b in blocks[i:i + need]])
        x_ext = torch.cat([base_tail, x])
        k = x.shape[0] // d
        fr = x_ext.unfold(0, taps, d)[:k]
        y = torch.complex(matmul(fr, bank.real[:, None], prec),
                          matmul(fr, bank.imag[:, None], prec))[:, 0]
        y = y * rotator(ramp_words(np.array([phi]), np.array([dphi]), k,
                                   dev), prec)[:, 0]
        phi = (phi + k * dphi) & dz.MASK48
        base_tail = x[-(taps - d):]
        for z in range(wp.zoom):
            ext = torch.cat([hb_tails[z], y])
            kz = y.shape[0] // 2
            fz = ext.unfold(0, lp, 2)[:kz]
            y = torch.complex(matmul(fz.real, hh, prec),
                              matmul(fz.imag, hh, prec))[:, 0]
            hb_tails[z] = ext[-(lp - 2):]
        ns = y.shape[0]
        ring = y[-dz.WF_FFT:] if ns >= dz.WF_FFT else torch.cat([ring[ns:], y])
    w = np.hanning(dz.WF_FFT + 1)[:dz.WF_FFT]
    wn = torch.as_tensor(w / w.sum(), device=dev).to(real)
    spec = torch.fft.fftshift(torch.fft.fft(ring * wn)).cpu().numpy()
    power = np.concatenate([spec.real ** 2 + spec.imag ** 2, [0.0]])
    frac = wp.span / (wp.adc_clock / wp.total_decim)
    members, count = pixel_members(float(frac))
    px = power[members].sum(axis=1) / np.maximum(count, 1)
    return 10.0 * np.log10(px + 1e-30)


def row_u8(db: np.ndarray) -> np.ndarray:
    """The wire's bytes: 255 + dB, calibrated, rounded, clamped."""
    return np.clip(np.round(255.0 + db + dz.WF_CAL_DB), 0, 255
                   ).astype(np.uint8)
