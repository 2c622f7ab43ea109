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

This module imports no jax: the caller converts the reference's arrays
to numpy first.

The two stage-2 branches carry different ``ddc.y_tail``: the fused
branch keeps it UNROTATED, the unfused one ROTATED.  A converted state
therefore belongs to one branch, which :func:`state_from_ref` is told.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models import rx_channel as rx
from .models import waterfall as wf
from .ops import agc as agc_ops
from .ops import channelizer as chz
from .ops import demod as demod_ops
from .ops import noise as noise_ops
from .ops.nco import words_from_limbs


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
    the rotator pass); it must match ``params.stage2``.
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
