"""Carry the JAX reference's tuning and streaming state into the port.

The reference's ``RxTuning`` and ``RxState`` arrive as numpy arrays —
either a dict of leaves or any object with the reference's attribute
names (e.g. the reference dataclasses after ``np.asarray`` on every
leaf).  They become the port's tensors on a given device:

- ``(..., 3)`` int32 16-bit limb phases become int64 words;
- split re/im ``Cplx`` pairs (``.re``/``.im``, ``{"re", "im"}`` or a
  2-tuple) become complex64; ``bank_r``/``bank_i`` become ``bank``;
- everything else keeps its dtype.

The waterfall's ``WfState`` and its stage-A tuning (``tune``'s
``(bank_r, bank_i, dphi_limbs)``) convert the same way
(:func:`wf_state_from_ref`, :func:`wf_tune_from_ref`).

The server's host state converts too: the control mirrors
(``ChannelCtl``) as the reference server's SET handlers leave them
(:func:`ctl_from_ref`, :func:`load_ctl`) and the per-channel ADPCM
encoder state (:func:`chan_codec_from_ref`), so that a test can put a
server of each package into the same state before the block it
compares.

The GPS subsystem converts as well: a reference ``TrackState``
(:func:`track_state_from_ref`) and a whole ``GpsManager`` — tracking
state, code table, channel bookkeeping with its nav assemblers, counters,
clock discipline (:func:`gps_manager_from_ref`) — so that a test can run
both managers on from one state.

This module imports no jax: the caller converts the reference's arrays
to numpy first (``np.array`` of a reference array leaf does).

The two stage-2 branches carry different ``ddc.y_tail``: the fused
branch keeps it UNROTATED, the unfused one ROTATED.  A converted state
therefore belongs to one branch, which :func:`state_from_ref` is told.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from .models import rx_channel as rx
from .models.gps import clock as gps_clock
from .models.gps import ephemeris as gps_ephemeris
from .models.gps import galileo as gps_galileo
from .models.gps import manager as gps_manager
from .models.gps import solver as gps_solver
from .models.gps import tracking as gps_tracking
from .models import waterfall as wf
from .ops import agc as agc_ops
from .ops import channelizer as chz
from .ops import demod as demod_ops
from .ops import noise as noise_ops
from .ops.nco import words_from_limbs
from .runtime.stream import ChannelCtl, StreamEngine


def _get(obj, name: str):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=device)


def _complex(v, device) -> torch.Tensor:
    """A split re/im pair -> complex64 tensor."""
    if isinstance(v, dict):
        re, im = v["re"], v["im"]
    elif hasattr(v, "re"):
        re, im = v.re, v.im
    else:
        re, im = v
    z = np.asarray(re, np.float32) + 1j * np.asarray(im, np.float32)
    return torch.as_tensor(z.astype(np.complex64), device=device)


def _words(limbs, device) -> torch.Tensor:
    return words_from_limbs(np.array(limbs, np.int32)).to(device)


def tuning_from_ref(src, device: torch.device | str) -> rx.RxTuning:
    """The reference's ``RxTuning`` (numpy leaves) -> port ``RxTuning``."""
    plain = ("mode", "manual_gain_db", "squelch_thresh", "nb_on", "nb_wild",
             "deemph_on", "mute_over_dbm", "nr_on", "nr_notch_on",
             "nr_den_on", "fm_deviation")
    t = rx.RxTuning(
        bank=_complex((_get(src, "bank_r"), _get(src, "bank_i")), device),
        dphi1=_words(_get(src, "dphi1"), device),
        pb_coef=_complex(_get(src, "pb_coef"), device),
        **{k: _tensor(_get(src, k), device) for k in plain})
    return rx.with_gates(t)


def _plain_fields(cls, src, device, **special):
    """Build dataclass ``cls`` from ``src``: tensors for every field not
    given in ``special``."""
    kw = {f.name: _tensor(_get(src, f.name), device)
          for f in dataclasses.fields(cls) if f.name not in special}
    return cls(**kw, **special)


def state_from_ref(src, params: rx.RxParams, branch: str,
                   device: torch.device | str) -> rx.RxState:
    """The reference's ``RxState`` (numpy leaves) -> port ``RxState``.

    ``branch`` names the reference stage-2 branch that produced ``src``
    ("fused" = its Pallas rotator path, "unfused" = poly/pallas after
    the rotator pass, "fft" = its FFT correlation after that pass); it
    must match ``params.stage2``.
    """
    if branch not in rx.STAGE2_BRANCHES:
        raise ValueError(f"branch must be one of {rx.STAGE2_BRANCHES}")
    if branch != params.stage2:
        raise ValueError(
            f"a state from the {branch} branch cannot feed the "
            f"{params.stage2} branch: its ddc.y_tail is "
            f"{'un' if branch == 'fused' else ''}rotated")
    ddc = _get(src, "ddc")
    agc = _get(src, "agc")
    return _plain_fields(
        rx.RxState, src, device,
        ddc=chz.DDCState(x_tail=_tensor(_get(ddc, "x_tail"), device),
                         y_tail=_complex(_get(ddc, "y_tail"), device),
                         phi1=_words(_get(ddc, "phi1"), device)),
        fir_tail=_complex(_get(src, "fir_tail"), device),
        agc=agc_ops.AgcState(delay=_complex(_get(agc, "delay"), device),
                             env_db=_tensor(_get(agc, "env_db"), device),
                             hang=_tensor(_get(agc, "hang"), device)),
        sam=_plain_fields(demod_ops.SamState, _get(src, "sam"), device),
        fm_last=_complex(_get(src, "fm_last"), device),
        squelch=_plain_fields(demod_ops.SquelchState, _get(src, "squelch"),
                              device),
        rssi_sq=_plain_fields(demod_ops.RssiSquelchState,
                              _get(src, "rssi_sq"), device),
        nr=_plain_fields(noise_ops.SpectralNRState, _get(src, "nr"), device),
        lms_notch=_plain_fields(noise_ops.LmsState, _get(src, "lms_notch"),
                                device),
        lms_den=_plain_fields(noise_ops.LmsState, _get(src, "lms_den"),
                              device),
        sb_tail=_complex(_get(src, "sb_tail"), device),
    )


def wf_state_from_ref(src, device: torch.device | str) -> wf.WfState:
    """The reference's waterfall ``WfState`` (numpy leaves) -> port
    ``WfState``."""
    return wf.WfState(
        phi=_words(_get(src, "phi"), device),
        base_tail=_tensor(_get(src, "base_tail"), device),
        hb_tails=_complex(_get(src, "hb_tails"), device),
        ring=_complex(_get(src, "ring"), device))


def wf_tune_from_ref(bank_r, bank_i, dphi_limbs, device: torch.device | str
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``waterfall.tune`` result -> the port's (bank
    (taps,) complex64, dphi () int64)."""
    return _complex((bank_r, bank_i), device), _words(dphi_limbs, device)


def ctl_from_ref(src_ctl) -> list[ChannelCtl]:
    """The reference engine's control mirrors (its ``ChannelCtl``
    objects, or dicts of their fields) -> the port's."""
    out = []
    for c in src_ctl:
        kw = {}
        for f in dataclasses.fields(ChannelCtl):
            v = _get(c, f.name)
            if f.name == "passband" and v is not None:
                v = (float(v[0]), float(v[1]))
            kw[f.name] = v
        out.append(ChannelCtl(**kw))
    return out


def load_ctl(engine: StreamEngine, src_ctl) -> None:
    """Give ``engine`` the reference engine's control mirrors and the
    tuning that the same ``set_channel`` calls would have left."""
    ctl = ctl_from_ref(src_ctl)
    if len(ctl) != engine.params.num_channels:
        raise ValueError(f"{len(ctl)} control mirrors for "
                         f"{engine.params.num_channels} channels")
    engine.ctl = ctl
    engine.tuning = engine._tuning_from_ctl()


def chan_codec_from_ref(src_codec) -> dict[int, np.ndarray]:
    """The reference server's ``_chan_codec`` ({channel: [predictor,
    step index]}) -> a fresh dict of int32 pairs for the port's."""
    out = {}
    for ch, st in src_codec.items():
        st = np.array(st, np.int32)
        if st.shape != (2,):
            raise ValueError(f"channel {ch}: codec state is {st.shape}")
        out[int(ch)] = st
    return out


# ---------------------------------------------------------------------------
# the GPS subsystem
# ---------------------------------------------------------------------------

def track_state_from_ref(src, device: torch.device | str
                         ) -> gps_tracking.TrackState:
    """The reference's tracking ``TrackState`` (numpy or array leaves,
    or a dict of them) -> the port's, on ``device``."""
    return _plain_fields(gps_tracking.TrackState, src, device)


def _host_copy(src, cls):
    """A new ``cls`` holding a deep copy of ``src``'s attributes (the
    reference's host objects: assemblers, ephemerides, the clock and the
    position filter hold numbers, arrays and containers of them); an
    ``eph`` attribute becomes the port's ``Ephemeris``."""
    out = cls.__new__(cls)
    for k, v in vars(src).items():
        if k == "eph":
            v = _host_copy(v, gps_ephemeris.Ephemeris)
        else:
            v = copy.deepcopy(v)
        setattr(out, k, v)
    return out


def gps_channel_from_ref(src) -> gps_manager.GpsChannel:
    """One reference ``GpsChannel`` (host bookkeeping, nav assembler and
    all) -> the port's."""
    kw = {}
    for f in dataclasses.fields(gps_manager.GpsChannel):
        v = getattr(src, f.name)
        if f.name == "asm":
            cls = (gps_galileo.InavAssembler
                   if type(v).__name__ == "InavAssembler"
                   else gps_ephemeris.SubframeAssembler)
            v = _host_copy(v, cls)
        else:
            v = copy.deepcopy(v)
        kw[f.name] = v
    return gps_manager.GpsChannel(**kw)


def gps_manager_from_ref(src, mgr: gps_manager.GpsManager) -> None:
    """Put the port's ``mgr`` into the state of the reference's
    ``GpsManager`` ``src``: the tracking state and code table (onto
    ``mgr.device``), the channels' bookkeeping, the sample counters and
    buffers, the search cadence, the clock discipline and the position
    filter.  Both must have the same capacity."""
    if src.max_chans != mgr.max_chans:
        raise ValueError(f"capacity {src.max_chans} into {mgr.max_chans}")
    mgr._track_state = track_state_from_ref(src._track_state, mgr.device)
    mgr._code_table = _tensor(src._code_table, mgr.device)
    mgr.channels = {prn: gps_channel_from_ref(ch)
                    for prn, ch in src.channels.items()}
    for k in ("ticks", "samples_tracked", "_last_search", "_gal_deferred",
              "search_interval_s", "fixes", "last_fix", "last_solutions",
              "min_snr", "prns", "galileo_prns"):
        setattr(mgr, k, copy.deepcopy(getattr(src, k)))
    mgr._rem = np.array(src._rem, np.float32)
    mgr._sbuf = np.array(src._sbuf, np.float32)
    mgr.clock = _host_copy(src.clock, gps_clock.ClockDiscipline)
    mgr.ekf = _host_copy(src.ekf, gps_solver.EkfSolver)
