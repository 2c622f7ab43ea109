"""The receiver pipeline: ADC block -> C channels of demodulated audio.

Port of :mod:`flydog_sdr_gps_tpu.models.rx_channel` (the reference's
per-channel audio path, `rx/rx_sound.cpp:222-1287`, plus the DDC):

    ADC 125 Msps
      -> stage-1 filter-bank matmul (all channels, ops/channelizer)
      -> fused NCO rotator + stage-2 decimator (CUDA kernel 1), or the
         rotator then the unfused stage 2 (kernel 2) or the FFT
         correlation (``torch.fft``)
      -> noise blanker, passband FastFIR, S-meter, AGC (kernel 3),
         demods (SAM PLL: kernel 4), NR, squelches, de-emphasis,
         overload mute
      -> (audio_block, C) float32 audio + IQ taps + S-meter

All channels advance together; per-channel differences (mode, passband,
gain) are data.  The reference's ``lax.cond`` gates (NB_WILD, SAM
sidebands, LMS, spectral NR) become Python branches on four booleans
that :func:`with_gates` derives on the host whenever the tuning is
built or changed, so a block never waits on the device to decide.

:func:`jit_rx_block` is the compiled step (the reference's
``jit_rx_block``): the same block program over buffers it owns, captured
in one CUDA graph per gate tuple on a card and replayed.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import Callable, Sequence

import numpy as np
import torch

from .. import _build
from ..numerology import ADC_CLOCK_NOM, AUDIO_BLOCK, SND_RATE_12K
from ..ops import agc as agc_ops
from ..ops import channelizer as chz
from ..ops import demod as demod_ops
from ..ops import fastfir
from ..ops import iir
from ..ops import kernels
from ..ops import nco
from ..ops import noise as noise_ops
from ..ops import smeter as smeter_ops

STAGE2_BRANCHES = ("fused", "unfused", "fft")


@dataclasses.dataclass(frozen=True, eq=False)
class RxParams:
    """Static receiver build (shapes and constants)."""
    num_channels: int
    adc_clock: float = ADC_CLOCK_NOM
    snd_rate: int = SND_RATE_12K
    audio_block: int = AUDIO_BLOCK
    atten_db: float = 90.0
    enable_nr: bool = True          # build the (runtime-gated) NR stages
    enable_nb: bool = True
    # stage-1 matmul precision: validated but has NO effect yet; both
    # values run full float32 (kept for the reference's field set; see
    # ops/channelizer, which refuses TF32 on the card)
    precision: str = "high"
    # stage 2: "fused" = rotator inside the stage-2 kernel (default),
    # "unfused" = exact two-table rotator pass, then stage 2 (kernel 2);
    # "fft" = the same rotator pass, then stage 2 as an FFT correlation
    stage2: str = "fused"

    def __post_init__(self):
        if self.stage2 not in STAGE2_BRANCHES:
            raise ValueError(f"stage2 must be one of {STAGE2_BRANCHES}")
        if self.precision not in ("high", "highest"):
            raise ValueError("precision must be 'high' or 'highest'")
        ddc = chz.make_ddc_plan(self.adc_clock, self.snd_rate,
                                self.audio_block, self.atten_db)
        fir = fastfir.plan_for_block(self.audio_block)
        fs = ddc.fs_out
        edge = 0.97 * fs / 2
        derived = dict(
            ddc=ddc, fir=fir,
            agc=agc_ops.AgcParams(fs=fs),
            sam=demod_ops.SamParams(fs=fs),
            nr=noise_ops.SpectralNRParams(),
            # NR_ORIG/NR_WDSP LMS pair: autonotch then denoiser
            lms_notch_p=noise_ops.LmsParams(notch=True),
            lms_den_p=noise_ops.LmsParams(notch=False),
            # SAM sideband-selection masks on the PLL-locked baseband
            sb_coef_l=fastfir.passband_freq_coef(fs, -edge, -15.0, plan=fir),
            sb_coef_u=fastfir.passband_freq_coef(fs, 15.0, edge, plan=fir),
        )
        for k, v in derived.items():
            object.__setattr__(self, k, v)

    ddc: chz.DDCPlan = dataclasses.field(init=False)
    fir: fastfir.FastFIRPlan = dataclasses.field(init=False)
    agc: agc_ops.AgcParams = dataclasses.field(init=False)
    sam: demod_ops.SamParams = dataclasses.field(init=False)
    nr: noise_ops.SpectralNRParams = dataclasses.field(init=False)
    lms_notch_p: noise_ops.LmsParams = dataclasses.field(init=False)
    lms_den_p: noise_ops.LmsParams = dataclasses.field(init=False)
    sb_coef_l: np.ndarray = dataclasses.field(init=False)
    sb_coef_u: np.ndarray = dataclasses.field(init=False)

    @property
    def fs_out(self) -> float:
        return self.ddc.fs_out

    @classmethod
    def from_config(cls, config, **kwargs) -> "RxParams":
        """Build from a firmware-style RxConfig (rx4/rx8/rx3/rx14,
        `numerology.CONFIGS` — reference `main.cpp:346-395`)."""
        return cls(num_channels=config.rx_chans,
                   snd_rate=config.snd_rate, **kwargs)


@dataclasses.dataclass
class RxTuning:
    """Per-channel dynamic configuration (tensors, updated by the control
    plane).  The reference's ``bank_r``/``bank_i`` pair is one complex64
    ``bank``; ``dphi1`` is one int64 word per channel.  The four ``any_*``
    booleans are host-side gates, kept true by :func:`with_gates`."""
    bank: torch.Tensor           # (L1, C) complex64 stage-1 filter bank
    dphi1: torch.Tensor          # (C,) int64 rotator increment words
    pb_coef: torch.Tensor        # (fft_size, C) complex64 passband
    mode: torch.Tensor           # (C,) int32 demod mode id
    manual_gain_db: torch.Tensor  # (C,) float32, NaN = AGC on
    squelch_thresh: torch.Tensor  # (C,) float32, <=0 = open
    nb_on: torch.Tensor          # (C,) bool noise blanker enable
    nb_wild: torch.Tensor        # (C,) bool: NB_WILD (interp) vs NB_STD
    deemph_on: torch.Tensor      # (C,) bool NBFM/AM de-emphasis
    mute_over_dbm: torch.Tensor  # (C,) float32 overload mute threshold
    nr_on: torch.Tensor          # (C,) bool spectral NR enable
    nr_notch_on: torch.Tensor    # (C,) bool LMS autonotch enable
    nr_den_on: torch.Tensor      # (C,) bool LMS denoiser enable
    fm_deviation: torch.Tensor   # () float32
    any_nb_wild: bool = False    # some channel runs NB_WILD
    any_sideband: bool = False   # some channel is SAL/SAU/SAS
    any_lms: bool = False        # some channel runs an LMS stage
    any_spectral_nr: bool = False  # some channel runs spectral NR


GATE_FIELDS = ("any_nb_wild", "any_sideband", "any_lms", "any_spectral_nr")


def with_gates(t: RxTuning) -> RxTuning:
    """Recompute the host gates from the per-channel tensors.  Call after
    building or changing a tuning (it reads (C,) flags to the host)."""
    flags = torch.stack([
        (t.nb_wild & t.nb_on).any(), (t.mode >= demod_ops.MODE_SAL).any(),
        (t.nr_notch_on | t.nr_den_on).any(), t.nr_on.any()]).tolist()
    return dataclasses.replace(t, **dict(zip(GATE_FIELDS, flags)))


@dataclasses.dataclass
class RxState:
    """All streaming carries for the full multi-channel receiver."""
    ddc: chz.DDCState
    fir_tail: torch.Tensor        # (ntaps-1, C) complex64
    agc: agc_ops.AgcState
    dc: torch.Tensor              # (2, C) AM dc-blocker
    sam: demod_ops.SamState
    fm_last: torch.Tensor         # (C,) complex64
    squelch: demod_ops.SquelchState
    rssi_sq: demod_ops.RssiSquelchState
    nb_mavg: torch.Tensor         # (C,) float32
    nr: noise_ops.SpectralNRState
    lms_notch: noise_ops.LmsState
    lms_den: noise_ops.LmsState
    sb_tail: torch.Tensor         # (ntaps-1, C) sideband-filter carry
    smeter: torch.Tensor          # (C,) float32 filtered power
    deemph: torch.Tensor          # (C,) float32 de-emphasis z1


def init_state(params: RxParams, device: torch.device | str) -> RxState:
    c = params.num_channels
    f32 = dict(dtype=torch.float32, device=device)
    return RxState(
        ddc=chz.init_ddc_state(params.ddc, c, device),
        fir_tail=fastfir.init_state(params.fir, c, device),
        agc=agc_ops.init_state(params.agc, c, device),
        dc=torch.zeros((2, c), **f32),
        sam=demod_ops.init_sam_state(c, device),
        fm_last=torch.ones(c, dtype=torch.complex64, device=device),
        squelch=demod_ops.init_squelch_state(c, device),
        rssi_sq=demod_ops.init_rssi_squelch(c, device),
        nb_mavg=torch.full((c,), 1e-3, **f32),
        nr=noise_ops.init_spectral_nr(params.nr, c, device),
        lms_notch=noise_ops.init_lms(params.lms_notch_p, c, device),
        lms_den=noise_ops.init_lms(params.lms_den_p, c, device),
        sb_tail=fastfir.init_state(params.fir, c, device),
        smeter=torch.zeros(c, **f32),
        deemph=torch.zeros(c, **f32),
    )


def default_tuning(params: RxParams, device: torch.device | str,
                   freqs_hz: Sequence[float] | None = None,
                   modes: Sequence[int] | None = None,
                   passbands: Sequence[tuple[float, float]] | None = None,
                   ) -> RxTuning:
    """Host-side construction of a full tuning set."""
    c = params.num_channels
    if freqs_hz is None:
        freqs_hz = np.linspace(1e6, 29e6, c)
    fcws = [nco.freq_to_fcw(f, params.adc_clock) for f in freqs_hz]
    bank, dphi1 = chz.build_filterbank(params.ddc, fcws)
    if modes is None:
        modes = [demod_ops.MODE_USB] * c
    if passbands is None:
        passbands = [_default_passband(m) for m in modes]
    designed = {pb: fastfir.passband_freq_coef(params.fs_out, *pb,
                                               plan=params.fir)
                for pb in set(map(tuple, passbands))}
    coef = np.stack([designed[tuple(pb)] for pb in passbands], axis=-1)

    def full(v, dtype):
        return torch.full((c,), v, dtype=dtype, device=device)

    return with_gates(RxTuning(
        bank=torch.as_tensor(bank, device=device),
        dphi1=torch.as_tensor(dphi1, device=device),
        pb_coef=torch.as_tensor(coef, device=device),
        mode=torch.as_tensor(np.asarray(modes, np.int32), device=device),
        manual_gain_db=full(float("nan"), torch.float32),
        squelch_thresh=full(0.0, torch.float32),
        nb_on=full(False, torch.bool),
        nb_wild=full(False, torch.bool),
        deemph_on=full(False, torch.bool),
        mute_over_dbm=full(20.0, torch.float32),
        nr_on=full(False, torch.bool),
        nr_notch_on=full(False, torch.bool),
        nr_den_on=full(False, torch.bool),
        fm_deviation=torch.tensor(2500.0, dtype=torch.float32,
                                  device=device),
    ))


def _default_passband(mode: int) -> tuple[float, float]:
    """Reference default passbands per mode (`rx/rx_init.cpp` tables)."""
    d = demod_ops
    return {
        d.MODE_AM: (-4900.0, 4900.0), d.MODE_AMN: (-2500.0, 2500.0),
        d.MODE_USB: (300.0, 2700.0), d.MODE_LSB: (-2700.0, -300.0),
        d.MODE_CW: (300.0, 700.0), d.MODE_CWN: (470.0, 530.0),
        d.MODE_NBFM: (-5500.0, 5500.0), d.MODE_IQ: (-5000.0, 5000.0),
        d.MODE_DRM: (-5000.0, 5000.0), d.MODE_SAM: (-4900.0, 4900.0),
        d.MODE_SAL: (-4900.0, -10.0), d.MODE_SAU: (10.0, 4900.0),
        d.MODE_SAS: (-4900.0, 4900.0),
    }.get(int(mode), (300.0, 2700.0))


# ---------------------------------------------------------------------------
# the block program
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RxTaps:
    """Per-block outputs at the reference's extension tap points."""
    audio: torch.Tensor           # (B, C) float32 demodulated audio
                                  # (stereo SAS: left = LSB)
    audio2: torch.Tensor          # (B, C) float32 stereo right (USB) for
                                  # SAS; equals ``audio`` for mono modes
    iq_pre_fir: torch.Tensor      # (B, C) complex64 DDC output
    iq_post_agc: torch.Tensor     # (B, C) complex64 after passband+AGC
    smeter_dbm: torch.Tensor      # (C,) float32 block peak level


@functools.lru_cache(maxsize=None)
def _sideband_coefs(params: RxParams, device: torch.device
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The SAM sideband masks on ``device``, made once per params and
    device (constants of the block program, not a copy a block)."""
    return (torch.as_tensor(params.sb_coef_l, device=device),
            torch.as_tensor(params.sb_coef_u, device=device))


def audio_back_half(params: RxParams, state: RxState, tuning: RxTuning,
                    iq: torch.Tensor) -> tuple[RxState, RxTaps]:
    """The audio-rate chain after the DDC, for all channels at once.

    Returns ``state.ddc`` unchanged (the caller owns the DDC carry).
    Stage order follows `rx/rx_sound.cpp`: blanker -> passband FIR ->
    S-meter -> AGC -> demod -> NR -> squelch -> de-emphasis -> mute.
    """
    d = demod_ops
    # --- noise blanker on raw IQ: NB_STD zeroes, NB_WILD bridges ---
    nb_iq, nb_mavg = noise_ops.noise_blanker(iq, state.nb_mavg)
    if tuning.any_nb_wild:
        wild = noise_ops.noise_blanker_wild(iq, state.nb_mavg)[0]
        nb_iq = torch.where(tuning.nb_wild[None, :], wild, nb_iq)
    iq_nb = torch.where(tuning.nb_on[None, :], nb_iq, iq)

    # --- passband filter, S-meter, AGC ---
    z, fir_tail = fastfir.fastfir_block(params.fir, iq_nb, state.fir_tail,
                                        tuning.pb_coef)
    _, smeter_peak, smeter_level = smeter_ops.smeter_block(z, state.smeter)
    zg, agc_state = agc_ops.agc_block(params.agc, z, state.agc,
                                      tuning.manual_gain_db)

    # --- demodulators (all computed, selected by mode) ---
    am_audio, dc_state = d.am_demod(zg, state.dc)
    ssb_audio = d.ssb_demod(zg)
    fm_audio, fm_last = d.fm_demod(zg, state.fm_last, params.fs_out,
                                   tuning.fm_deviation)
    sam_audio, v_locked, sam_state = d.sam_demod(params.sam, zg, state.sam)

    # --- SAM sideband selection (SAL/SAU/SAS) on the locked baseband ---
    if tuning.any_sideband:
        coef_l, coef_u = _sideband_coefs(params, iq.device)
        vl, vu, sb_tail = fastfir.fastfir_block2(
            params.fir, v_locked, state.sb_tail, coef_l, coef_u)
        sb_l, sb_u = 2.0 * vl.real, 2.0 * vu.real
    else:
        sb_l = sb_u = torch.zeros_like(sam_audio)
        sb_tail = state.sb_tail

    mode = tuning.mode[None, :]
    # mono SAM lane: SAL -> lower sideband, SAU -> upper, SAS -> left
    sam_sel = torch.where((mode == d.MODE_SAL) | (mode == d.MODE_SAS), sb_l,
                          torch.where(mode == d.MODE_SAU, sb_u, sam_audio))
    audio = torch.where(
        (mode == d.MODE_AM) | (mode == d.MODE_AMN), am_audio,
        torch.where(mode == d.MODE_NBFM, fm_audio,
                    torch.where(mode >= d.MODE_SAM, sam_sel, ssb_audio)))

    # --- NR dispatch (`rx_sound.cpp:922-948`): LMS autonotch -> LMS
    # denoiser -> spectral NR, each gated on the host ---
    nr_state = state.nr
    lms_notch_state, lms_den_state = state.lms_notch, state.lms_den
    if params.enable_nr and tuning.any_lms:
        audio, lms_notch_state, lms_den_state = noise_ops.lms_chain_block(
            params.lms_notch_p, params.lms_den_p, audio, state.lms_notch,
            state.lms_den, tuning.nr_notch_on, tuning.nr_den_on)
    if params.enable_nr and tuning.any_spectral_nr:
        nr_audio, nr_state = noise_ops.spectral_nr_block(params.nr, audio,
                                                         state.nr)
        audio = torch.where(tuning.nr_on[None, :], nr_audio, audio)

    # --- squelch: NBFM noise squelch, median-RSSI squelch otherwise ---
    is_fm = tuning.mode == d.MODE_NBFM
    fm_thresh = torch.where(is_fm, tuning.squelch_thresh, 0.0)
    audio, squelch_state = d.fm_squelch(audio, state.squelch, fm_thresh)
    rssi_thresh = torch.where(is_fm, 0.0, tuning.squelch_thresh)
    audio, rssi_state = d.rssi_squelch(audio, smeter_peak, state.rssi_sq,
                                       rssi_thresh)

    # --- de-emphasis: one-pole 75 us LPF (`rx_sound.cpp:898-908`) ---
    alpha = float(np.float32(1.0 - np.exp(-1.0 / (params.fs_out * 75e-6))))
    de_audio = iir.one_pole_smoother(audio, alpha, state.deemph)
    audio = torch.where(tuning.deemph_on[None, :], de_audio, audio)
    deemph_state = torch.where(tuning.deemph_on, de_audio[-1], state.deemph)

    # --- overload mute (`rx_sound.cpp:989-1014`) ---
    over = (smeter_peak > tuning.mute_over_dbm)[None, :]
    audio = torch.where(over, 0.0, audio)

    # --- stereo right lane (SAS): USB through the same gates ---
    gate = squelch_state.open_ & ((rssi_thresh <= 0.0) | rssi_state.open_)
    audio2 = torch.where(gate[None, :] & ~over, sb_u, 0.0)
    audio2 = torch.where(mode == d.MODE_SAS, audio2, audio)

    new_state = RxState(
        ddc=state.ddc,    # caller replaces with the advanced DDC carry
        fir_tail=fir_tail, agc=agc_state, dc=dc_state,
        sam=sam_state, fm_last=fm_last, squelch=squelch_state,
        rssi_sq=rssi_state, nb_mavg=nb_mavg, nr=nr_state,
        lms_notch=lms_notch_state, lms_den=lms_den_state,
        sb_tail=sb_tail, smeter=smeter_level, deemph=deemph_state,
    )
    taps = RxTaps(audio=audio, audio2=audio2, iq_pre_fir=iq,
                  iq_post_agc=zg, smeter_dbm=smeter_peak)
    return new_state, taps


def rx_block(params: RxParams, state: RxState, tuning: RxTuning,
             x_adc: torch.Tensor) -> tuple[RxState, RxTaps]:
    """Process one ADC block through every channel.

    x_adc: (adc_block,) float32 on the state's device.
    """
    new_ddc, iq = _ddc(params, state, tuning, x_adc)
    new_state, taps = audio_back_half(params, state, tuning, iq)
    return dataclasses.replace(new_state, ddc=new_ddc), taps


def _ddc(params: RxParams, state: RxState, tuning: RxTuning,
         x_adc: torch.Tensor) -> tuple[chz.DDCState, torch.Tensor]:
    plan = params.ddc
    x_ext = torch.cat([state.ddc.x_tail, x_adc])
    k2 = plan.audio_block
    if params.stage2 == "fused":
        # y (and its carry tail) stay UNROTATED: the stage-2 kernel
        # applies exp(-2j*pi*(phi + n*dphi)) to each sample it reads.
        # The carry rows sit tail2 samples BEFORE this block's first
        # stage-1 output, so the ramp starts at phi1 - tail2*dphi.  The
        # matmul writes straight into the rows after the carry.
        c = params.num_channels
        y_ext = torch.empty((plan.tail2 + plan.k1, c), dtype=torch.complex64,
                            device=x_adc.device)
        y_ext[:plan.tail2] = state.ddc.y_tail
        chz.stage1_matmul(plan, x_ext, tuning.bank, out=y_ext[plan.tail2:])
        phi_ext0 = (state.ddc.phi1
                    - nco.mul_mod48(plan.tail2, tuning.dphi1)) & nco.MASK48
        audio_iq = kernels.stage2_rot(y_ext, phi_ext0, tuning.dphi1,
                                      plan.h2, plan.d2, k2)
    else:
        # the tail carries ROTATED stage-1 output in these branches
        y1 = chz.stage1_apply(plan, x_ext, tuning.bank, state.ddc.phi1,
                              tuning.dphi1)
        y_ext = torch.cat([state.ddc.y_tail, y1])
        if params.stage2 == "fft":
            audio_iq = chz.stage2_fft(plan, y_ext)
        else:
            audio_iq = chz.stage2_apply(plan, y_ext)
    new = chz.DDCState(
        x_tail=x_adc[-plan.tail1:].clone(),
        y_tail=y_ext[-plan.tail2:].clone(),
        phi1=nco.advance(state.ddc.phi1, tuning.dphi1, plan.k1),
    )
    return new, audio_iq


# ---------------------------------------------------------------------------
# the compiled block program
# ---------------------------------------------------------------------------

def gates(tuning: RxTuning) -> tuple[bool, bool, bool, bool]:
    """The host gates of a tuning: what a compiled step is keyed by, as a
    jitted function is by its static arguments."""
    return tuple(getattr(tuning, f) for f in GATE_FIELDS)


def copy_into(dst, src) -> None:
    """Copy each tensor of ``src`` into the same field of ``dst`` (a
    tensor or nested dataclasses of tensors; fields that are not tensors
    are left alone).  Shapes and dtypes must agree; a field whose
    tensor already is ``dst``'s is skipped."""
    if isinstance(dst, torch.Tensor):
        if src is dst:
            return
        if not isinstance(src, torch.Tensor) or src.shape != dst.shape \
                or src.dtype != dst.dtype:
            raise ValueError(
                f"cannot copy {getattr(src, 'dtype', type(src))} "
                f"{tuple(getattr(src, 'shape', ()))} into a {dst.dtype} "
                f"{tuple(dst.shape)} buffer")
        dst.copy_(src)
        return
    for f in dataclasses.fields(dst):
        d = getattr(dst, f.name)
        if isinstance(d, torch.Tensor) or dataclasses.is_dataclass(d):
            copy_into(d, getattr(src, f.name))


def empty_taps(params: RxParams, device: torch.device | str) -> RxTaps:
    """Tap buffers of one block (what a compiled step writes its taps
    into)."""
    b, c = params.audio_block, params.num_channels
    f32 = dict(dtype=torch.float32, device=device)
    c64 = dict(dtype=torch.complex64, device=device)
    return RxTaps(audio=torch.zeros((b, c), **f32),
                  audio2=torch.zeros((b, c), **f32),
                  iq_pre_fir=torch.zeros((b, c), **c64),
                  iq_post_agc=torch.zeros((b, c), **c64),
                  smeter_dbm=torch.zeros(c, **f32))


class _Graph:
    """One captured program: its CUDA graph, the launches each wrapper
    made during the capture (credited at every replay, so a replayed
    block counts as an eager one does) and the capture's wall ms."""

    def __init__(self, graph, launches: dict, capture_ms: float):
        self.graph = graph
        self.launches = launches
        self.capture_ms = capture_ms

    def replay(self) -> None:
        self.graph.replay()
        _build.credit(self.launches)


def _warm_blas(device: torch.device) -> None:
    """One tiny float32 matmul on this thread's current stream: it makes
    the thread's cuBLAS handle and that stream's workspace, which must
    not be made inside a capture."""
    a = torch.zeros((8, 8), dtype=torch.float32, device=device)
    torch.matmul(a, a)


class CompiledRxBlock:
    """The block program of one ``RxParams`` on one device, compiled.

    The port's counterpart of the reference's ``jit_rx_block``.  It owns
    the step's buffers: the input block ``x``, the streaming ``state``,
    the ``tuning`` and the ``taps``.  A program (the block step
    :meth:`block`, or a serving program that an engine defines over more
    buffers of its own) reads and writes only buffers.  Control-plane
    changes reach them by copy (:func:`copy_into`), never by rebinding:
    a graph reads fixed addresses.

    On a card each program is captured in a CUDA graph under each gate
    tuple (:func:`gates`; they choose Python branches where the
    reference has ``lax.cond``, so a graph is kept per tuple as
    ``jax.jit`` keeps a program per static argument).  The first run of
    a key runs eagerly on the live buffers (it is that block, and the
    warm-up that makes cuBLAS handles and cuFFT plans, which must exist
    before a capture), then the key is captured; later runs replay it.
    :meth:`prepare` captures a key ahead of time without touching the
    live buffers.  All graphs of one step share one memory pool, and the
    buffers lie outside it, so no graph's temporaries land on what
    another graph reads.  A capture or replay that fails raises; nothing
    runs eagerly in its place.  On the CPU a program runs its body: the
    same static-buffer step, with nothing captured.

    Every block writes the same buffers: a block's taps (and a serving
    program's result) are overwritten by the next block, so whatever
    keeps them longer copies them first.
    """

    def __init__(self, params: RxParams, device: torch.device | str):
        self.params = params
        self.device = torch.device(device)
        self.state = init_state(params, self.device)
        self.tuning = default_tuning(params, self.device)
        self.x = torch.zeros(params.ddc.adc_block, dtype=torch.float32,
                             device=self.device)
        self.taps = empty_taps(params, self.device)
        self.graphs: dict[tuple, _Graph] = {}
        # launches of the warm-ups :meth:`prepare` ran on scratch buffers
        # (real launches, counted as such; {wrapper: n})
        self.warmup_launches: dict = {}
        self._warm: set[tuple] = set()      # gate tuples run eagerly here
        self._failed: dict[tuple, str] = {}  # keys whose capture failed
        self._lock = threading.Lock()       # one capture at a time
        if self.device.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)

    # -- the block step --------------------------------------------------
    def body(self, state: RxState, tuning: RxTuning, x: torch.Tensor,
             taps: RxTaps | None = None) -> RxTaps:
        """One block over buffers: ``rx_block``, then its new state copied
        into ``state`` (and its taps into ``taps``, when given).  Returns
        the block's taps as ``rx_block`` made them."""
        new_state, new_taps = rx_block(self.params, state, tuning, x)
        copy_into(state, new_state)
        if taps is not None:
            copy_into(taps, new_taps)
        return new_taps

    def block(self, x: torch.Tensor) -> RxTaps:
        """One block: ``x`` copied into the input buffer, the step run
        (replayed on a card) for the current gates; returns the taps
        buffers."""
        self.x.copy_(x)
        self.run(("block",), lambda t: self.body(self.state, t, self.x,
                                                 self.taps))
        return self.taps

    # -- programs --------------------------------------------------------
    def run(self, program: tuple, fn: Callable[[RxTuning], object]
            ) -> None:
        """Run ``program`` (a tuple naming it, e.g. ``("block",)``) for
        the current gates: its graph is keyed ``program + gates``.
        ``fn(tuning)`` is its body over the live buffers (``tuning`` is
        the tuning buffers with this run's gates)."""
        tuning = self.tuning
        if self.device.type != "cuda":
            fn(tuning)
            return
        key = program + gates(tuning)
        graph = self.graphs.get(key)
        if graph is None:
            if key in self._failed:         # no eager block in its place
                raise RuntimeError(f"the capture of {key} failed: "
                                   f"{self._failed[key]}")
            with self._lock:
                graph = self.graphs.get(key)
                if graph is None:
                    fn(tuning)              # this block, and the warm-up
                    self._warm.add(gates(tuning))
                    self._capture(key, lambda: fn(tuning))
                    return
        graph.replay()

    def prepare(self, program: tuple, fn: Callable[[RxTuning], object],
                warm: Callable[[RxTuning], object]) -> None:
        """Capture ``program`` for the current gates off the block
        loop (from any thread, beside replays on another).  ``fn`` is as
        for :meth:`run`; ``warm(tuning)`` runs the same program eagerly
        on scratch buffers, and runs only when these gates have not yet
        run here: the live buffers are never touched.

        While it captures, no other thread may synchronize the whole
        device (``torch.cuda.synchronize()``, ``empty_cache()``): CUDA
        refuses a wait on a capturing stream, and the capture fails.
        Wait on a stream or an event instead, as the engine and the
        server do."""
        if self.device.type != "cuda":
            return
        tuning = self.tuning
        key = program + gates(tuning)
        with self._lock:
            if key in self.graphs:
                return
            if key in self._failed:
                raise RuntimeError(f"the capture of {key} failed: "
                                   f"{self._failed[key]}")
            if gates(tuning) not in self._warm:
                with torch.cuda.stream(self._stream), \
                        _build.recording() as launches:
                    warm(tuning)
                _build.credit(launches)
                for wrapper, n in launches.items():
                    self.warmup_launches[wrapper] = \
                        self.warmup_launches.get(wrapper, 0) + n
                self._stream.synchronize()
                self._warm.add(gates(tuning))
            self._capture(key, lambda: fn(tuning))

    def _capture(self, key: tuple, fn: Callable[[], object]) -> None:
        """Record ``fn`` in a CUDA graph on the step's own stream, in this
        thread's capture mode only (other threads go on launching), into
        the step's memory pool."""
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.device(self.device), \
                torch.cuda.stream(self._stream):
            _warm_blas(self.device)
            with _build.recording() as launches:
                graph.capture_begin(pool=self._pool,
                                    capture_error_mode="thread_local")
                recorded = False
                try:
                    fn()
                    recorded = True
                    graph.capture_end()
                except BaseException as e:
                    self._failed[key] = repr(e)
                    if not recorded:        # end the broken capture
                        try:
                            graph.capture_end()
                        except Exception:   # noqa: BLE001 — the first
                            pass            # error is the one to raise
                    raise
        self.graphs[key] = _Graph(graph, dict(launches),
                                  (time.perf_counter() - t0) * 1e3)


def jit_rx_block(params: RxParams, device: torch.device | str = "cuda"
                 ) -> CompiledRxBlock:
    """The compiled block step for this build on ``device`` (the
    reference's ``jit_rx_block``): ``step.block(x)`` advances
    ``step.state`` under ``step.tuning`` and returns ``step.taps``."""
    return CompiledRxBlock(params, device)
