"""Waterfall pipeline: zoomable wideband spectrum rows.

Port of :mod:`flydog_sdr_gps_tpu.models.waterfall` (reference firmware:
`rx/rx_waterfall.cpp:246-1651` + `verilog/rx/waterfall_1cic.v`): per
waterfall channel a separate DDC with zoom-programmable decimation
2**zoom (z0-z14) fills a ring of the most recent 8192 complex samples;
a frame request windows the ring, takes an 8192-point FFT, |X|^2, maps
the bins to 1024 pixels (max / min / last / drop / averaging maps,
`:896-926`) and returns dB.

Streaming decimation, as in the reference package: an exact-NCO mix +
decimate-by-4 FIR brings 125 Msps down to 31.25 Msps complex, then
``zoom`` halfband decimate-by-2 stages (flat passband, no CIC droop)
feed the ring.  rate(z) = adc_clock / 2**(z+2); the pixel map scales the
bins to the displayed span ui_srate / 2**z.

What differs from the reference package: samples are complex64, a phase
is one int64 word, the FFT is ``torch.fft.fft``, and there is no
compiled program per zoom (plain functions).  Every decimating FIR is
one matrix product over a blocked view of its input
(:func:`_fir_decimate`): 64 outputs a row against a banded Toeplitz
matrix of the taps, so that the 21-million-sample block of the serving
size is copied once into overlapping rows and no (samples x taps) frame
array is ever built.  The products run in full float32.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..numerology import (ADC_CLOCK_NOM, MAX_ZOOM, PHASE_BITS, UI_SRATE_30M,
                          WF_FFT, WF_OUT_PX)
from ..ops import filters
from ..ops import nco
from ..ops import windows
from ..ops.channelizer import require_full_float32

# outputs a row of the blocked FIR product
FIR_BLOCK = 64


@functools.lru_cache(maxsize=None)
def make_wf_params(zoom: int, adc_clock: float = ADC_CLOCK_NOM,
                   ui_srate: float = UI_SRATE_30M) -> "WfParams":
    """Shared per-zoom build (filters and pixel maps are identical for
    every connection at a zoom: build them once per process)."""
    return WfParams(zoom=zoom, adc_clock=adc_clock, ui_srate=ui_srate)


@dataclasses.dataclass(frozen=True, eq=False)
class WfParams:
    """Static build of one waterfall channel at a given zoom."""
    zoom: int
    adc_clock: float = ADC_CLOCK_NOM
    ui_srate: float = UI_SRATE_30M
    fft_size: int = WF_FFT
    out_px: int = WF_OUT_PX
    base_decim: int = 4            # stage-A decimation (125 -> 31.25 M)
    base_taps_mult: int = 8

    def __post_init__(self):
        if not 0 <= self.zoom <= MAX_ZOOM:
            raise ValueError(f"zoom {self.zoom} out of range")
        h = filters.kaiser_lowpass(
            self.adc_clock,
            0.40 * self.adc_clock / self.base_decim,
            0.50 * self.adc_clock / self.base_decim,
            80.0, numtaps=self.base_taps_mult * self.base_decim)
        object.__setattr__(self, "h_base", h)
        object.__setattr__(self, "h_half", filters.halfband(80.0))

    h_base: np.ndarray = dataclasses.field(init=False)
    h_half: np.ndarray = dataclasses.field(init=False)

    @property
    def total_decim(self) -> int:
        return self.base_decim << self.zoom

    @property
    def wf_rate(self) -> float:
        return self.adc_clock / self.total_decim

    @property
    def span(self) -> float:
        """Displayed span (Hz): ui_srate / 2**zoom."""
        return self.ui_srate / (1 << self.zoom)

    def ingest_blocks(self, adc_block: int) -> int:
        """How many raw ADC blocks to accumulate per ingest call.

        Every halfband stage halves the sample count, so the ingest
        length must be divisible by 2**zoom * base_decim; deep zooms
        accumulate multiple blocks (the runtime stitches them), the
        analogue of the reference's continuous/overlapped sampling mode
        for slow frame fill (`rx_waterfall.cpp:980-1005`).
        """
        need = self.base_decim << self.zoom
        n = 1
        while (n * adc_block) % need:
            n += 1
        return n


@dataclasses.dataclass
class WfState:
    """Streaming carries for one waterfall channel."""
    phi: torch.Tensor             # () int64 NCO phase word
    base_tail: torch.Tensor       # (taps-D,) float32 raw-sample tail
    hb_tails: torch.Tensor        # (max(zoom, 1), hb_tail) complex64
    ring: torch.Tensor            # (fft_size,) complex64, most recent last


def _hb_padded_len(h: np.ndarray) -> int:
    return 2 * ((len(h) + 1) // 2)


def init_state(params: WfParams, device: torch.device | str) -> WfState:
    hb_tail = _hb_padded_len(params.h_half) - 2
    return WfState(
        phi=torch.zeros((), dtype=torch.int64, device=device),
        base_tail=torch.zeros(len(params.h_base) - params.base_decim,
                              dtype=torch.float32, device=device),
        hb_tails=torch.zeros((max(params.zoom, 1), hb_tail),
                             dtype=torch.complex64, device=device),
        ring=torch.zeros(params.fft_size, dtype=torch.complex64,
                         device=device),
    )


def tune(params: WfParams, center_freq_hz: float) -> tuple[np.ndarray, int]:
    """Host-side: (bank, dphi) for the stage-A mix.

    ``bank`` (taps,) complex64 bakes exp(-j*w*n) into the stage-A taps
    exactly like the audio channelizer (one column); ``dphi`` is the
    48-bit phase word one stage-A output advances by.
    """
    fcw = nco.freq_to_fcw(center_freq_hz, params.adc_clock)
    h = np.asarray(params.h_base, np.float64)
    n = np.arange(len(h), dtype=object)
    ph = ((n * fcw) % (1 << PHASE_BITS)).astype(np.float64)
    ang = -2.0 * np.pi * ph * (2.0 ** -PHASE_BITS)
    bank = ((h * np.cos(ang)).astype(np.float32)
            + 1j * (h * np.sin(ang)).astype(np.float32))
    return (bank.astype(np.complex64),
            (fcw * params.base_decim) % (1 << PHASE_BITS))


# ---------------------------------------------------------------------------
# streaming decimator
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _toeplitz_index(taps: int, q: int, p: int, d: int, block: int,
                    device: str):
    """Index tensors that scatter taps ``w[j, a, b]`` into the banded
    matrix ``T[(i*d + j)*q + a, i*p + b]`` for i in [0, block)."""
    i, j, a, b = np.meshgrid(np.arange(block), np.arange(taps),
                             np.arange(q), np.arange(p), indexing="ij")
    rows = ((i * d + j) * q + a).reshape(-1)
    cols = (i * p + b).reshape(-1)
    src = ((j * q + a) * p + b).reshape(-1)
    return tuple(torch.as_tensor(v, dtype=torch.int64, device=device)
                 for v in (rows, cols, src))


def _toeplitz(w: torch.Tensor, d: int, block: int) -> torch.Tensor:
    """The banded matrix of taps ``w`` (taps, q, p) for ``block`` outputs
    at hop ``d``: ((block*d + taps - d) * q, block * p) float32."""
    taps, q, p = w.shape
    rows, cols, src = _toeplitz_index(taps, q, p, d, block, str(w.device))
    t = torch.zeros(((block * d + taps - d) * q, block * p),
                    dtype=torch.float32, device=w.device)
    t.index_put_((rows, cols), w.reshape(-1)[src])
    return t


def _fir_decimate(ext: torch.Tensor, toeplitz, taps: int, q: int, p: int,
                  d: int, k: int) -> torch.Tensor:
    """Decimating FIR as one matrix product: ``y[i] = sum_j w[j] .
    ext[i*d + j]`` for i in [0, k).

    ext: flat float32 sequence of items of q floats; ``toeplitz(block)``
    gives the banded matrix (:func:`_toeplitz`) of the (taps, q, p) taps,
    which map the q floats of an input item to the p floats of an output
    item.  Returns (k * p,) float32.  A row of the product holds
    ``FIR_BLOCK`` outputs: its input span is a row of a strided view of
    ``ext`` (rows overlap by taps - d items).  The last, shorter row is a
    second product of its own.
    """
    require_full_float32(ext, "the waterfall decimator")
    if ext.numel() < ((k - 1) * d + taps) * q:
        raise ValueError("_fir_decimate: input too short for k outputs")
    parts = []
    done = 0
    for block in (FIR_BLOCK, k % FIR_BLOCK):
        nb = (k - done) // block if block else 0
        if nb == 0:
            continue
        span = (block * d + taps - d) * q
        x = ext[done * d * q:].as_strided((nb, span), (block * d * q, 1))
        parts.append((x @ toeplitz(block)).reshape(-1))
        done += nb * block
    return parts[0] if len(parts) == 1 else torch.cat(parts)


@functools.lru_cache(maxsize=64)
def _halfband_toeplitz(h_bytes: bytes, block: int, device: str
                       ) -> torch.Tensor:
    """The halfband stage's banded matrix on ``device`` (the same for
    every stage, slot and block: built once).  Taps are zero-padded to
    an even length and act on re and im alike."""
    h = np.frombuffer(h_bytes, np.float64)
    hh = np.pad(h.astype(np.float32), (0, _hb_padded_len(h) - len(h)))
    w = torch.as_tensor(hh[:, None, None] * np.eye(2, dtype=np.float32),
                        device=device)
    return _toeplitz(w, 2, block)


def _halfband_decim2(h: np.ndarray, x: torch.Tensor, tail: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decimate-by-2 with a halfband FIR; streaming tail.

    x: (N,) complex64, N even; tail: (Lp-2,) complex64, Lp the tap count
    padded to even.  Returns (y (N/2,), new tail).
    """
    lp = _hb_padded_len(h)
    h_bytes = np.asarray(h, np.float64).tobytes()
    ext = torch.cat([tail, x])
    k = x.shape[0] // 2
    y = _fir_decimate(
        torch.view_as_real(ext).reshape(-1),
        lambda block: _halfband_toeplitz(h_bytes, block, str(x.device)),
        lp, 2, 2, 2, k)
    return torch.view_as_complex(y.reshape(k, 2)), ext[-(lp - 2):]


def wf_ingest(params: WfParams, state: WfState, x: torch.Tensor,
              bank: torch.Tensor, dphi: torch.Tensor) -> WfState:
    """Consume one raw ADC block, advance the waterfall stream + ring.

    x: (n,) float32, n a multiple of ``params.total_decim``; bank:
    (taps,) complex64 and dphi: () int64 from :func:`tune`.
    """
    d = params.base_decim
    taps = len(params.h_base)
    if x.shape[0] % params.total_decim:
        raise ValueError(f"wf_ingest: {x.shape[0]} samples are no multiple "
                         f"of the decimation {params.total_decim}")
    x_ext = torch.cat([state.base_tail, x])
    k = x.shape[0] // d
    w = torch.view_as_real(bank).reshape(taps, 1, 2)
    y = torch.view_as_complex(_fir_decimate(
        x_ext, lambda block: _toeplitz(w, d, block), taps, 1, 2, d, k
    ).reshape(k, 2))
    # exact per-output phase rotator (48-bit words)
    ang = (-2.0 * np.pi) * nco.phase_ramp(state.phi, dphi, k)
    y = y * torch.complex(torch.cos(ang), torch.sin(ang))

    hb_tails = []
    for z in range(params.zoom):
        y, t_new = _halfband_decim2(params.h_half, y, state.hb_tails[z])
        hb_tails.append(t_new)
    if params.zoom == 0:
        hb_tails.append(state.hb_tails[0])

    # roll the ring: keep the latest fft_size samples
    nfft = params.fft_size
    ns = y.shape[0]
    if ns >= nfft:
        ring = y[-nfft:].clone()
    else:
        ring = torch.cat([state.ring[ns:], y])
    return WfState(
        phi=nco.advance(state.phi, dphi, k),
        base_tail=x[-(taps - d):].clone(),
        hb_tails=torch.stack(hb_tails),
        ring=ring,
    )


# ---------------------------------------------------------------------------
# frame computation
# ---------------------------------------------------------------------------

# Bin -> pixel reduction modes, matching the reference's interp
# selector (`rx/rx_waterfall.cpp:74` {max, min, last, drop, cma},
# "SET interp=", applied in its per-pixel plot loop `:896-926`).
WF_MODES = ("max", "min", "last", "drop", "cma")


@functools.lru_cache(maxsize=256)
def _pixel_segments(fft_size: int, out_px: int, frac: float
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Segment ids (fft_size,) mapping each (fftshifted) bin to its
    pixel (out_px = out-of-span sentinel), plus per-pixel 'drop'
    (center) and 'last' bin gather indices."""
    used = fft_size * frac
    b0 = (fft_size - used) / 2.0
    seg = np.full((fft_size,), out_px, np.int32)
    drop_idx = np.zeros((out_px,), np.int32)
    last_idx = np.zeros((out_px,), np.int32)
    for p in range(out_px):
        lo = b0 + used * p / out_px
        hi = b0 + used * (p + 1) / out_px
        ilo, ihi = int(np.ceil(lo - 1e-9)), int(np.ceil(hi - 1e-9))
        seg[max(ilo, 0):min(max(ihi, ilo + 1), fft_size)] = p
        drop_idx[p] = int((lo + hi) / 2) % fft_size
        last_idx[p] = min(max(ihi - 1, 0), fft_size - 1)
    return seg, drop_idx, last_idx


@functools.lru_cache(maxsize=64)
def _frame_constants(fft_size: int, out_px: int, frac: float,
                     window_kind: str, device: str):
    """Device constants of :func:`wf_frame`: the normalised window, the
    bin -> pixel segment ids, the bins a pixel averages over, and the
    'drop' and 'last' gather indices."""
    w = windows.window(window_kind, fft_size)
    wn = torch.as_tensor(w, device=device) / float(np.sum(w, dtype=np.float64))
    seg, drop_idx, last_idx = _pixel_segments(fft_size, out_px, frac)
    count = np.bincount(seg, minlength=out_px + 1).astype(np.float32)

    def dev(a):
        return torch.as_tensor(a.astype(np.int64), device=device)
    return (wn, dev(seg), torch.as_tensor(count, device=device),
            dev(drop_idx), dev(last_idx))


def wf_frame(params: WfParams, state: WfState,
             window_kind: str = windows.HANNING,
             mode: str = "cma", mask: torch.Tensor | None = None
             ) -> torch.Tensor:
    """Compute one waterfall row: (out_px,) float32 dBFS.

    ``mode``: bin->pixel reduction (see WF_MODES).  ``mask``: optional
    (out_px,) multiplier applied to linear pixel power; masked
    frequencies go to 0 exactly like the reference zeroing fft_scale
    for DX-masked bands (`rx_waterfall.cpp:905-918`).
    """
    if mode not in WF_MODES:
        raise ValueError(f"unknown wf mode {mode!r}")
    frac = params.span / (params.adc_clock / params.total_decim)
    wn, seg, count, drop_idx, last_idx = _frame_constants(
        params.fft_size, params.out_px, float(frac), window_kind,
        str(state.ring.device))
    spec = torch.fft.fftshift(torch.fft.fft(state.ring * wn))
    power = spec.real * spec.real + spec.imag * spec.imag
    npx = params.out_px
    if mode == "cma":
        s = torch.zeros(npx + 1, dtype=torch.float32, device=power.device)
        s.index_add_(0, seg, power)
        px = (s / torch.clamp(count, min=1.0))[:npx]
    elif mode in ("max", "min"):
        start = float("-inf") if mode == "max" else float("inf")
        s = torch.full((npx + 1,), start, dtype=torch.float32,
                       device=power.device)
        s.scatter_reduce_(0, seg, power,
                          reduce="amax" if mode == "max" else "amin")
        px = s[:npx]
    elif mode == "last":
        px = power[last_idx]
    else:
        px = power[drop_idx]
    if mask is not None:
        px = px * mask
    return 10.0 * torch.log10(px + 1e-30)


class ApertureAuto:
    """Auto-aperture estimation (`rx_waterfall.cpp:1176-1270`
    aperture_auto): per-pixel averaged power (IIR / MMA / EMA
    selectable), then a 5 dB-resolution histogram: the most common
    band is the noise floor (mindb), the highest occupied band the
    signal ceiling (maxdb).  Reported every ``report_s`` while on, or
    once when used single-shot (algo OFF), as "MSG maxdb/mindb".
    Host numpy, as in the reference package.
    """
    OFF, IIR, MMA, EMA = range(4)
    RESOLUTION_DB = 5.0

    def __init__(self, algo: int = MMA, param: float = 8.0,
                 report_s: float = 3.0):
        self.algo = algo
        self.param = param
        self.report_s = report_s if algo != self.OFF else 1.0
        self.avg_pwr: np.ndarray | None = None
        self.last_report = 0.0
        self.pending = True

    def accumulate(self, row_dbm: np.ndarray) -> None:
        row_dbm = np.asarray(row_dbm, np.float64)
        if self.avg_pwr is None:
            self.avg_pwr = row_dbm.copy()
            return
        algo = self.MMA if self.algo == self.OFF else self.algo
        param = 8.0 if self.algo == self.OFF else self.param
        if algo == self.IIR:
            gain = np.maximum(1.0 - np.exp(-param * row_dbm / 255.0),
                              0.01)
            self.avg_pwr += (row_dbm - self.avg_pwr) * gain
        elif algo == self.MMA:
            self.avg_pwr = (self.avg_pwr * (param - 1) + row_dbm) / param
        else:                                   # EMA
            self.avg_pwr += (row_dbm - self.avg_pwr) / param

    def report(self, now: float) -> tuple[int, int] | None:
        """(maxdb, mindb) when due, else None."""
        if self.avg_pwr is None or now < self.last_report + self.report_s:
            return None
        if self.algo == self.OFF and not self.pending:
            return None
        self.last_report = now
        self.pending = False
        r = self.RESOLUTION_DB
        bands = np.floor(self.avg_pwr / r) * r
        bands = bands[bands > -190.0]           # disregard masked areas
        if len(bands) == 0:
            return -110, -120
        vals, counts = np.unique(bands, return_counts=True)
        mindb = int(vals[np.argmax(counts)])    # modal band = noise
        maxdb = int(max(vals.max(), -80.0))     # reference floor at -80
        return maxdb, mindb


def wf_row_u8(row_db: torch.Tensor) -> torch.Tensor:
    """Quantize a dB row to the reference's wire format: u8 = 255 + dB
    (dB <= 0, clamped), `rx/rx_waterfall.cpp compute_frame`."""
    return torch.clamp(torch.round(255.0 + row_db), 0, 255).to(torch.uint8)
