"""Port parity: the audio back half's ops against the JAX reference (CPU).

The port runs each kernel's plain version here (CPU tensors).
Tolerances, relative to the largest reference magnitude ("scale"):
- host-helper copies: exact;
- linear ops (IIR scans, S-meter, FastFIR, blankers, AM/SSB, squelch
  gates): 1e-5 * scale — float32 sums taken in another order;
- time loops (AGC envelope, SAM PLL, LMS chain), the FM discriminator
  and spectral NR: 1e-4 * scale — a rounding difference in a nonlinear
  step (atan2, log10, the gain rules, adaptation) is carried forward.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flydog_sdr_gps_tpu.models import rx_channel as jrx
from flydog_sdr_gps_tpu.ops import agc as jagc
from flydog_sdr_gps_tpu.ops import cplx as jcplx
from flydog_sdr_gps_tpu.ops import demod as jdemod
from flydog_sdr_gps_tpu.ops import fastfir as jfir
from flydog_sdr_gps_tpu.ops import iir as jiir
from flydog_sdr_gps_tpu.ops import noise as jnoise
from flydog_sdr_gps_tpu.ops import smeter as jsm
from flydog_sdr_gps_tpu_torch.models import rx_channel as trx
from flydog_sdr_gps_tpu_torch.ops import agc as tagc
from flydog_sdr_gps_tpu_torch.ops import demod as tdemod
from flydog_sdr_gps_tpu_torch.ops import fastfir as tfir
from flydog_sdr_gps_tpu_torch.ops import iir as tiir
from flydog_sdr_gps_tpu_torch.ops import noise as tnoise
from flydog_sdr_gps_tpu_torch.ops import smeter as tsm

FS = 12_000.0
LINEAR = 1e-5
LOOP = 1e-4


def close(got, ref, rel, msg="", scale=None):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    if isinstance(ref, jcplx.Cplx):
        ref = np.asarray(ref.re) + 1j * np.asarray(ref.im)
    ref = np.asarray(ref)
    if scale is None:
        scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * scale,
                               err_msg=msg)


def iq(rng, n, c, scale=1.0, tones=True):
    """Complex test IQ: per-channel tones plus noise."""
    t = np.arange(n)[:, None] / FS
    z = scale * 0.05 * (rng.standard_normal((n, c))
                        + 1j * rng.standard_normal((n, c)))
    if tones:
        f = rng.uniform(-3000, 3000, c)[None]
        z = z + scale * rng.uniform(0.1, 1.0, c)[None] * \
            np.exp(2j * np.pi * (f * t + rng.uniform(0, 1, c)[None]))
    return z.astype(np.complex64)


def jc(z):
    return jcplx.from_numpy(z)


def tc(z):
    return torch.from_numpy(np.ascontiguousarray(z))


# ---------------------------------------------------------------------------
# host-helper copies
# ---------------------------------------------------------------------------

def test_host_helper_copies_equal_reference():
    for name in list(jdemod.MODE_NAMES) + ["SSB_LIKE", "MODE_IDS"]:
        key = name if name.isupper() else f"MODE_{name.upper()}"
        assert getattr(tdemod, key) == getattr(jdemod, key), key
    assert tdemod.MODE_NAMES == jdemod.MODE_NAMES
    assert tdemod.N_RSSI == jdemod.N_RSSI and tdemod.N_RSSI % 2 == 1
    for m in range(-1, 14):
        assert trx._default_passband(m) == jrx._default_passband(m)
    for block in (64, 128, 512, 2048):
        assert dataclasses.astuple(tfir.plan_for_block(block)) == \
            dataclasses.astuple(jfir.plan_for_block(block))
    plan = tfir.plan_for_block(128)
    for lo, hi in ((300.0, 2700.0), (-4900.0, 4900.0), (-5500.0, 5500.0)):
        np.testing.assert_array_equal(
            tfir.passband_freq_coef(FS, lo, hi, plan=plan),
            jfir.passband_freq_coef(FS, lo, hi, plan=jfir.plan_for_block(128)))
    pairs = [(tagc.AgcParams(fs=FS), jagc.AgcParams(fs=FS)),
             (tdemod.SamParams(fs=FS), jdemod.SamParams(fs=FS)),
             (tnoise.SpectralNRParams(), jnoise.SpectralNRParams()),
             (tnoise.LmsParams(notch=True), jnoise.LmsParams(notch=True))]
    for tp, jp in pairs:
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    a, b = pairs[0]
    assert (a.attack_alpha, a.decay_alpha, a.hang_samples) == \
        (b.attack_alpha, b.decay_alpha, b.hang_samples)
    a, b = pairs[1]
    assert (a.g1, a.g2) == (b.g1, b.g2)
    tp = trx.RxParams(num_channels=4, audio_block=128)
    jp = jrx.RxParams(num_channels=4, audio_block=128)
    np.testing.assert_array_equal(tp.sb_coef_l, jp.sb_coef_l)
    np.testing.assert_array_equal(tp.sb_coef_u, jp.sb_coef_u)
    assert tp.fs_out == jp.fs_out


# ---------------------------------------------------------------------------
# linear ops
# ---------------------------------------------------------------------------

def test_iir_ops_match_reference():
    rng = np.random.default_rng(0)
    u = rng.standard_normal((200, 6)).astype(np.float32)
    a = rng.uniform(0.5, 0.99, (200, 6)).astype(np.float32)
    y0 = rng.standard_normal(6).astype(np.float32)
    close(tiir.linear_recurrence(tc(a), tc(u), tc(y0)),
          jiir.linear_recurrence(jnp.asarray(a), jnp.asarray(u),
                                 jnp.asarray(y0)), LINEAR)
    st = rng.standard_normal((2, 6)).astype(np.float32)
    y, s = tiir.dc_blocker(tc(u + 3.0), tc(st))
    yr, sr = jiir.dc_blocker(jnp.asarray(u + 3.0), jnp.asarray(st))
    close(y, yr, LINEAR)
    close(s, sr, LINEAR)
    close(tiir.one_pole_smoother(tc(u), 0.2, tc(y0)),
          jiir.one_pole_smoother(jnp.asarray(u), 0.2, jnp.asarray(y0)),
          LINEAR)


def _loop_2(a1, a2, v, y1, y2):
    """y[n] = a1*y[n-1] + a2*y[n-2] + v[n] in float64, one sample at a
    time."""
    y = np.zeros(v.shape)
    for n in range(len(v)):
        y[n] = a1 * y1 + a2 * y2 + v[n]
        y1, y2 = y[n], y1
    return y


def test_linear_recurrence_2_matches_reference_and_loop():
    rng = np.random.default_rng(3)
    v = rng.standard_normal((300, 5)).astype(np.float32)
    y1, y2 = (rng.standard_normal(5).astype(np.float32) for _ in range(2))
    # poles at radius 0.97 (a stable resonator, the biquad's regime)
    a1, a2 = 2 * 0.97 * np.cos(0.3), -0.97 ** 2
    got = tiir.linear_recurrence_2(a1, a2, tc(v), tc(y1), tc(y2))
    ref = jiir.linear_recurrence_2(a1, a2, jnp.asarray(v), jnp.asarray(y1),
                                   jnp.asarray(y2))
    close(got, ref, LINEAR)
    loop = _loop_2(np.float32(a1), np.float32(a2), v.astype(np.float64),
                   y1.astype(np.float64), y2.astype(np.float64))
    close(got, loop, LINEAR)
    # per-sample coefficients as tensors
    a1s = rng.uniform(0.2, 0.8, (300, 5)).astype(np.float32)
    a2s = rng.uniform(-0.1, 0.1, (300, 5)).astype(np.float32)
    close(tiir.linear_recurrence_2(tc(a1s), tc(a2s), tc(v), tc(y1), tc(y2)),
          jiir.linear_recurrence_2(jnp.asarray(a1s), jnp.asarray(a2s),
                                   jnp.asarray(v), jnp.asarray(y1),
                                   jnp.asarray(y2)), LINEAR)


def test_biquad_matches_reference_and_scipy():
    """The reference's own test (``test_audio_ops.py``: against scipy's
    lfilter at rtol 1e-3, atol 1e-4), then the reference itself."""
    from scipy.signal import lfilter
    rng = np.random.default_rng(1)
    x = rng.standard_normal((512, 2)).astype(np.float32)
    b, a = tiir.design_biquad_lowpass(FS, 300.0)
    assert (b, a) == jiir.design_biquad_lowpass(FS, 300.0)
    y, st = tiir.biquad(tc(x), b, a, torch.zeros((4, 2)))
    np.testing.assert_allclose(y.numpy(), lfilter(b, a, x, axis=0),
                               rtol=1e-3, atol=1e-4)
    yr, sr = jiir.biquad(jnp.asarray(x), b, a, jnp.zeros((4, 2), jnp.float32))
    close(y, yr, LINEAR)
    close(st, sr, LINEAR)


def test_biquad_streaming_continuity():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((512, 2)).astype(np.float32)
    b, a = tiir.design_biquad_lowpass(FS, 1000.0)
    s = torch.zeros((4, 2))
    y1, s = tiir.biquad(tc(x[:256]), b, a, s)
    y2, s = tiir.biquad(tc(x[256:]), b, a, s)
    whole, _ = tiir.biquad(tc(x), b, a, torch.zeros((4, 2)))
    got = torch.cat([y1, y2]).numpy()
    np.testing.assert_allclose(got, whole.numpy(), rtol=1e-3, atol=1e-4)
    js = jnp.zeros((4, 2), jnp.float32)
    r1, js = jiir.biquad(jnp.asarray(x[:256]), b, a, js)
    r2, js = jiir.biquad(jnp.asarray(x[256:]), b, a, js)
    close(got, np.concatenate([np.asarray(r1), np.asarray(r2)]), LINEAR)
    close(s, js, LINEAR)


def test_design_biquad_lowpass_equals_reference():
    for fc, q in ((300.0, 0.7071), (1000.0, 0.5), (3000.0, 2.0)):
        assert tiir.design_biquad_lowpass(FS, fc, q) == \
            jiir.design_biquad_lowpass(FS, fc, q)


def test_smeter_wire_matches_reference():
    rng = np.random.default_rng(7)
    dbm = np.concatenate([
        rng.uniform(-140.0, 0.0, 64),
        [-127.0, -200.0, 7000.0, -126.95, -126.85, -120.25, -13.0]]
    ).astype(np.float32)
    got = tsm.smeter_wire(tc(dbm))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jsm.smeter_wire(jnp.asarray(dbm))))


def test_fir_freq_response_and_hop_equal_reference():
    from flydog_sdr_gps_tpu.ops import filters as jfilters
    from flydog_sdr_gps_tpu_torch.ops import filters as tfilters
    rng = np.random.default_rng(8)
    h = rng.standard_normal(31)
    f = np.linspace(-6000.0, 6000.0, 97)
    np.testing.assert_array_equal(tfilters.fir_freq_response(h, f, FS),
                                  jfilters.fir_freq_response(h, f, FS))
    assert tfir.HOP == jfir.HOP == tfir.FastFIRPlan().hop


def test_smeter_matches_reference():
    rng = np.random.default_rng(1)
    z = iq(rng, 128, 8, scale=0.3)
    level = rng.uniform(0, 0.1, 8).astype(np.float32)
    got = tsm.smeter_block(tc(z), tc(level))
    ref = jsm.smeter_block(jc(z), jnp.asarray(level))
    for g, r in zip(got, ref):
        close(g, r, LINEAR)


def test_fastfir_blocks_match_reference():
    plan_t, plan_j = tfir.plan_for_block(128), jfir.plan_for_block(128)
    rng = np.random.default_rng(2)
    c = 6
    coef = np.stack([tfir.passband_freq_coef(FS, -2000.0 + 300 * i,
                                             2500.0, plan=plan_t)
                     for i in range(c)], axis=-1)
    ttail = tfir.init_state(plan_t, c, "cpu")
    jtail = jfir.init_state(plan_j, c)
    sb_a = tfir.passband_freq_coef(FS, -5800.0, -15.0, plan=plan_t)
    sb_b = tfir.passband_freq_coef(FS, 15.0, 5800.0, plan=plan_t)
    ttail2, jtail2 = ttail, jtail
    # the transforms' rounding is relative to the input's level, and the
    # first blocks' outputs (filter warm-up) are far below it
    for blk in range(8):
        x = iq(rng, 128, c)
        scale = float(np.abs(x).max())
        y, ttail = tfir.fastfir_block(plan_t, tc(x), ttail, tc(coef))
        yr, jtail = jfir.fastfir_block(plan_j, jc(x), jtail, jc(coef))
        close(y, yr, LINEAR, f"block {blk}", scale)
        ya, yb, ttail2 = tfir.fastfir_block2(plan_t, tc(x), ttail2,
                                             tc(sb_a), tc(sb_b))
        ra, rb, jtail2 = jfir.fastfir_block2(plan_j, jc(x), jtail2,
                                             jc(sb_a), jc(sb_b))
        close(ya, ra, LINEAR, f"block {blk}", scale)
        close(yb, rb, LINEAR, f"block {blk}", scale)


def test_am_ssb_demod_match_reference():
    rng = np.random.default_rng(3)
    z = iq(rng, 128, 8)
    dc = rng.standard_normal((2, 8)).astype(np.float32)
    a, s = tdemod.am_demod(tc(z), tc(dc))
    ar, sr = jdemod.am_demod(jc(z), jnp.asarray(dc))
    close(a, ar, LINEAR)
    close(s, sr, LINEAR)
    close(tdemod.ssb_demod(tc(z)), jdemod.ssb_demod(jc(z)), 0.0)


def test_noise_blankers_match_reference():
    rng = np.random.default_rng(4)
    z = iq(rng, 128, 8, scale=0.05)
    for ch, pos in ((0, 10), (1, 64), (3, 120), (5, 3), (5, 40)):
        z[pos, ch] += 4.0 - 2.0j
    mavg = np.full(8, 0.05, np.float32)
    for t_fn, j_fn in ((tnoise.noise_blanker, jnoise.noise_blanker),
                       (tnoise.noise_blanker_wild,
                        jnoise.noise_blanker_wild)):
        y, m = t_fn(tc(z), tc(mavg))
        yr, mr = j_fn(jc(z), jnp.asarray(mavg))
        close(y, yr, LINEAR, t_fn.__name__)
        close(m, mr, LINEAR, t_fn.__name__)


def test_squelches_match_reference():
    rng = np.random.default_rng(5)
    c = 6
    thr = jnp.asarray([0.0, 0.3, 5.0, 0.0, 3.0, 20.0], jnp.float32)
    tst, jst = tdemod.init_squelch_state(c, "cpu"), jdemod.init_squelch_state(c)
    trs, jrs = tdemod.init_rssi_squelch(c, "cpu"), jdemod.init_rssi_squelch(c)
    for blk in range(70):               # > N_RSSI: the ring fills
        audio = (rng.standard_normal((16, c))
                 * rng.uniform(0.1, 2, c)).astype(np.float32)
        dbm = (-90 + 30 * (blk % 9 == 0) + rng.standard_normal(c)
               ).astype(np.float32)
        y, tst = tdemod.fm_squelch(tc(audio), tst, tc(np.array(thr)))
        yr, jst = jdemod.fm_squelch(jnp.asarray(audio), jst, thr)
        close(y, yr, LINEAR, f"fm block {blk}")
        assert tst.open_.tolist() == np.asarray(jst.open_).tolist()
        y, trs = tdemod.rssi_squelch(tc(audio), tc(dbm), trs,
                                     tc(np.array(thr)))
        yr, jrs = jdemod.rssi_squelch(jnp.asarray(audio), jnp.asarray(dbm),
                                      jrs, thr)
        close(y, yr, LINEAR, f"rssi block {blk}")
        assert trs.open_.tolist() == np.asarray(jrs.open_).tolist()
    close(trs.ring, jrs.ring, 0.0)


# ---------------------------------------------------------------------------
# time loops and nonlinear ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hang_ms", [0.0, 3.0])
def test_agc_matches_reference(hang_ms):
    tp, jp = tagc.AgcParams(fs=FS, hang_ms=hang_ms), \
        jagc.AgcParams(fs=FS, hang_ms=hang_ms)
    rng = np.random.default_rng(6)
    c = 8
    manual = np.full(c, np.nan, np.float32)
    manual[[2, 5]] = [30.0, -6.0]
    tst, jst = tagc.init_state(tp, c, "cpu"), jagc.init_state(jp, c)
    for blk in range(3):
        scale = 10.0 ** rng.uniform(-4, 0, c)
        x = (iq(rng, 128, c) * scale[None]).astype(np.complex64)
        y, tst = tagc.agc_block(tp, tc(x), tst, tc(manual))
        yr, jst = jagc.agc_block(jp, jc(x), jst, jnp.asarray(manual))
        close(y, yr, LOOP, f"block {blk}")
        close(tst.env_db, jst.env_db, LOOP)
        assert tst.hang.tolist() == np.asarray(jst.hang).tolist()


def test_sam_matches_reference():
    params_t, params_j = tdemod.SamParams(fs=FS), jdemod.SamParams(fs=FS)
    rng = np.random.default_rng(7)
    c = 8
    n = 128
    off = rng.uniform(-60, 60, c)[None]
    tst, jst = tdemod.init_sam_state(c, "cpu"), jdemod.init_sam_state(c)
    for blk in range(3):
        t = (np.arange(n)[:, None] + blk * n) / FS
        mod = 1 + 0.5 * np.sin(2 * np.pi * 400 * t)
        z = (mod * np.exp(2j * np.pi * off * t)
             + 0.02 * rng.standard_normal((n, c))).astype(np.complex64)
        a, v, tst = tdemod.sam_demod(params_t, tc(z), tst)
        ar, vr, jst = jdemod.sam_demod(params_j, jc(z), jst)
        close(a, ar, LOOP, f"block {blk}")
        close(v, vr, LOOP, f"block {blk}")
        close(tst.phase, jst.phase, LOOP)
        close(tst.freq, jst.freq, LOOP)


def sam_special_input(rng, n, c, lane, kind):
    """AM carriers with small offsets plus noise; lane ``lane`` is made
    the case ``kind`` that the CUDA kernel treats apart from the rest."""
    t = np.arange(n)[:, None]
    off = rng.uniform(-0.03, 0.03, c)[None]               # rad/sample
    z = ((1 + 0.5 * np.sin(0.2 * t)) * np.exp(1j * off * t)
         + 0.02 * (rng.standard_normal((n, c))
                   + 1j * rng.standard_normal((n, c)))).astype(np.complex64)
    if kind == "zero":
        z[:, lane] = 0
    elif kind == "negative_zero":
        z[:, lane] = complex(-0.0, 0.0)
    elif kind == "turns_zero":
        z[n // 2:, lane] = 0
    elif kind == "nan":
        z[n // 3, lane] = complex(np.nan, 0.5)
    elif kind == "clamp_hi":
        z[:, lane] = np.exp(0.6j * t[:, 0])
    elif kind == "clamp_lo":
        z[:, lane] = np.exp(-0.6j * t[:, 0])
    else:
        raise ValueError(kind)
    return z


def close_where_finite(got, ref, rel, msg):
    """NaN in the same places, and ``close`` everywhere else."""
    got, ref = np.asarray(got), np.asarray(ref)
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=msg)
    scale = max(float(np.abs(ref[~nan]).max()), 1e-30)
    np.testing.assert_allclose(got[~nan], ref[~nan], rtol=0,
                               atol=rel * scale, err_msg=msg)


@pytest.mark.parametrize("kind", ["zero", "negative_zero", "turns_zero",
                                  "nan", "clamp_hi", "clamp_lo"])
def test_sam_special_lanes_match_reference(kind):
    """The plain PLL loop against the reference scan on the lanes for
    which the CUDA kernel leaves its fast path: an exactly zero sample
    (atan2 of signed zeros: 0 or +-pi by the quadrant of the phase), a
    NaN (poisons the lane from there on) and the +-fmax clamp.  Starts
    from a state with every quadrant of phase; tolerance as
    ``test_sam_matches_reference``."""
    params_t, params_j = tdemod.SamParams(fs=FS), jdemod.SamParams(fs=FS)
    rng = np.random.default_rng(11)
    n, c, lane = 192, 8, 3
    phase0 = rng.uniform(-np.pi, np.pi, c).astype(np.float32)
    freq0 = rng.uniform(-0.05, 0.05, c).astype(np.float32)
    tst = tdemod.SamState(phase=tc(phase0), freq=tc(freq0),
                          dc=torch.zeros((2, c)))
    jst = jdemod.SamState(phase=jnp.asarray(phase0), freq=jnp.asarray(freq0),
                          dc=jnp.zeros((2, c), jnp.float32))
    for blk in range(2):
        z = sam_special_input(rng, n, c, lane, kind)
        a, v, tst = tdemod.sam_demod(params_t, tc(z), tst)
        ar, vr, jst = jdemod.sam_demod(params_j, jc(z), jst)
        vr = np.asarray(vr.re) + 1j * np.asarray(vr.im)
        close_where_finite(a.numpy(), ar, LOOP, f"{kind} audio, block {blk}")
        close_where_finite(v.numpy(), vr, LOOP, f"{kind} v, block {blk}")
        close_where_finite(tst.phase.numpy(), jst.phase, LOOP, f"{kind} phase")
        close_where_finite(tst.freq.numpy(), jst.freq, LOOP, f"{kind} freq")
    freq = tst.freq.numpy()[lane]
    if kind == "nan":
        assert np.isnan(freq) and np.isnan(v.numpy()[-1, lane])
        assert np.isfinite(np.delete(v.numpy(), lane, axis=1)).all()
    elif kind.startswith("clamp"):
        sign = 1.0 if kind == "clamp_hi" else -1.0
        assert freq == np.float32(sign * params_t.fmax)
    elif kind != "turns_zero" or blk:
        assert not v.numpy()[-1, lane]


def test_fm_demod_matches_reference():
    rng = np.random.default_rng(8)
    n, c = 128, 6
    t = np.arange(n)[:, None] / FS
    z = (np.exp(1j * (2 * np.pi * 700 * t
                      + 3.0 * np.sin(2 * np.pi * 500 * t)))
         + 0.01 * rng.standard_normal((n, c))).astype(np.complex64)
    last = np.ones(c, np.complex64)
    a, l = tdemod.fm_demod(tc(z), tc(last), FS, torch.tensor(2500.0))
    ar, lr = jdemod.fm_demod(jc(z), jc(last), FS, jnp.float32(2500.0))
    close(a, ar, LOOP)
    close(l, lr, 0.0)


@pytest.mark.parametrize("rule", ["subtract", "mmse"])
def test_spectral_nr_matches_reference(rule):
    tp = tnoise.SpectralNRParams(gain_rule=rule)
    jp = jnoise.SpectralNRParams(gain_rule=rule)
    rng = np.random.default_rng(9)
    c = 4
    tst, jst = tnoise.init_spectral_nr(tp, c, "cpu"), \
        jnoise.init_spectral_nr(jp, c)
    for blk in range(4):
        t = (np.arange(256)[:, None] + 256 * blk) / FS
        x = (0.5 * np.sin(2 * np.pi * 900 * t) * (blk % 2)
             + 0.1 * rng.standard_normal((256, c))).astype(np.float32)
        y, tst = tnoise.spectral_nr_block(tp, tc(x), tst)
        yr, jst = jnoise.spectral_nr_block(jp, jnp.asarray(x), jst)
        close(y, yr, LOOP, f"block {blk}")
        close(tst.psd_smooth, jst.psd_smooth, LOOP)
        close(tst.xhat2, jst.xhat2, LOOP)
        close(tst.min_ring, jst.min_ring, LOOP)
        close(tst.in_tail, jst.in_tail, LOOP)
        close(tst.out_tail, jst.out_tail, LOOP)


def _nr_spec(rng, nfr, c):
    """One-sided spectra (nfr, 129, c) complex64 of noise with a tone."""
    t = np.arange(256)[:, None] / FS
    frames = (0.4 * np.sin(2 * np.pi * rng.uniform(200, 3000, c)[None] * t)
              [None] + 0.1 * rng.standard_normal((nfr, 256, c)))
    win = np.hanning(257)[:256][None, :, None]
    return torch.as_tensor(np.fft.fft(frames * win, axis=1)[:, :129]
                           .astype(np.complex64))


@pytest.mark.parametrize("rule", ["subtract", "mmse"])
def test_spectral_nr_gains_on_cpu_is_the_plain_version(rule):
    """On CPU tensors the wrapper runs the plain version: every output
    equal, no launch counted; the state it returns is new tensors but
    xhat2 under "subtract", which that rule does not advance."""
    p = tnoise.SpectralNRParams(gain_rule=rule)
    rng = np.random.default_rng(31)
    st = tnoise.init_spectral_nr(p, 5, "cpu")
    st = dataclasses.replace(st, xhat2=torch.as_tensor(
        rng.uniform(0, 1, (129, 5)).astype(np.float32)))
    launches = tnoise.spectral_nr_gains.launches
    for blk in range(2):
        spec = _nr_spec(rng, 16, 5)
        got = tnoise.spectral_nr_gains(p, spec, st)
        ref = tnoise.spectral_nr_gains_plain(p, spec, st)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        assert got[0].shape == (16, 129, 5) and got[2].shape == (8, 129, 5)
        assert (got[3] is st.xhat2) == (rule == "subtract")
        st = dataclasses.replace(st, psd_smooth=got[1], min_ring=got[2],
                                 xhat2=got[3])
    assert tnoise.spectral_nr_gains.launches == launches


def test_spectral_nr_block_on_cpu_goes_through_the_plain_gains(monkeypatch):
    """spectral_nr_block calls the gains once a block, between the two
    FFTs; on the CPU that is the plain version."""
    p = tnoise.SpectralNRParams()
    calls = []
    plain = tnoise.spectral_nr_gains_plain
    monkeypatch.setattr(tnoise, "spectral_nr_gains_plain",
                        lambda *a: calls.append(a[1].shape) or plain(*a))
    st = tnoise.init_spectral_nr(p, 3, "cpu")
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (512, 3)).astype(np.float32))
    for _ in range(2):
        _, st = tnoise.spectral_nr_block(p, x, st)
    assert calls == [(4, 129, 3)] * 2


@pytest.mark.parametrize("nfr", [1, 2, 16])
def test_overlap_add_equals_the_frame_loop(nfr):
    """The two strided slice-adds give the loop over frames' result to
    the bit."""
    rng = np.random.default_rng(nfr)
    frames = torch.as_tensor(rng.standard_normal((nfr, 256, 7))
                             .astype(np.float32))
    y = torch.zeros((nfr * 128 + 128, 7))
    for i in range(nfr):
        y[i * 128:i * 128 + 256] += frames[i]
    assert torch.equal(tnoise.overlap_add(frames, 128), y)


def test_spectral_nr_and_tracking_wrappers_raise_off_cpu():
    """A tensor neither on the CPU nor on a card gets an error from
    kernel 7's and kernel 6's wrappers, not the plain version, and no
    launch is counted."""
    from flydog_sdr_gps_tpu_torch.models.gps import tracking
    meta = dict(device="meta")
    p = tnoise.SpectralNRParams()
    st = tnoise.SpectralNRState(
        in_tail=torch.empty((128, 4), **meta),
        out_tail=torch.empty((128, 4), **meta),
        psd_smooth=torch.empty((129, 4), **meta),
        min_ring=torch.empty((8, 129, 4), **meta),
        xhat2=torch.empty((129, 4), **meta))
    before = (tnoise.spectral_nr_gains.launches,
              tracking.track_epochs.launches)
    with pytest.raises(RuntimeError, match="no kernel"):
        tnoise.spectral_nr_gains(
            p, torch.empty((16, 129, 4), dtype=torch.complex64, **meta), st)
    tp = tracking.TrackParams()
    ts, tab = tracking.empty_track_state(tp, 2, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        tracking.track_epochs(tp, ts, tab, torch.empty((3, tp.epoch), **meta))
    assert before == (tnoise.spectral_nr_gains.launches,
                      tracking.track_epochs.launches)


def test_lms_chain_matches_reference():
    tn, td = tnoise.LmsParams(notch=True), tnoise.LmsParams(notch=False)
    jn, jd = jnoise.LmsParams(notch=True), jnoise.LmsParams(notch=False)
    rng = np.random.default_rng(10)
    c = 4
    en_n = np.array([True, False, True, False])
    en_d = np.array([True, True, False, False])
    tsn, tsd = tnoise.init_lms(tn, c, "cpu"), tnoise.init_lms(td, c, "cpu")
    jsn, jsd = jnoise.init_lms(jn, c), jnoise.init_lms(jd, c)
    for blk in range(2):
        t = (np.arange(128)[:, None] + 128 * blk) / FS
        x = (np.sin(2 * np.pi * 1000 * t)
             + 0.3 * rng.standard_normal((128, c))).astype(np.float32)
        y, tsn, tsd = tnoise.lms_chain_block(tn, td, tc(x), tsn, tsd,
                                             tc(en_n), tc(en_d))
        yr, jsn, jsd = jnoise.lms_chain_block(jn, jd, jnp.asarray(x), jsn,
                                              jsd, jnp.asarray(en_n),
                                              jnp.asarray(en_d))
        close(y, yr, LOOP, f"block {blk}")
        close(tsd.weights, jsd.weights, LOOP)


@pytest.mark.parametrize("on_notch, on_den", [(True, True), (True, False),
                                              (False, True), (False, False)])
def test_lms_plain_version_matches_reference_scan(on_notch, on_den):
    """The plain version of the LMS kernel against the JAX scan, every
    combination of enables beside a channel of the opposite setting, over
    three blocks; a disabled stage passes through and keeps its weights,
    but its delay line advances."""
    tn, td = tnoise.LmsParams(notch=True), tnoise.LmsParams(notch=False)
    jn, jd = jnoise.LmsParams(notch=True), jnoise.LmsParams(notch=False)
    rng = np.random.default_rng(21)
    c, n = 3, 96
    en_n = np.array([on_notch, not on_notch, on_notch])
    en_d = np.array([on_den, not on_den, on_den])
    tsn, tsd = tnoise.init_lms(tn, c, "cpu"), tnoise.init_lms(td, c, "cpu")
    jsn, jsd = jnoise.init_lms(jn, c), jnoise.init_lms(jd, c)
    for blk in range(3):
        t = (np.arange(n)[:, None] + n * blk) / FS
        x = (np.sin(2 * np.pi * np.array([1000.0, 440.0, 2500.0]) * t)
             + 0.3 * rng.standard_normal((n, c))).astype(np.float32)
        y, tsn, tsd = tnoise.lms_chain_block_plain(
            tn, td, tc(x), tsn, tsd, tc(en_n), tc(en_d))
        yr, jsn, jsd = jnoise.lms_chain_block(
            jn, jd, jnp.asarray(x), jsn, jsd, jnp.asarray(en_n),
            jnp.asarray(en_d))
        close(y, yr, LOOP, f"block {blk}")
        for got, ref in ((tsn, jsn), (tsd, jsd)):
            close(got.weights, ref.weights, LOOP, scale=1.0)
            close(got.line, ref.line, LOOP)
        if not on_notch:
            assert not tsn.weights[:, 0].any()
            np.testing.assert_array_equal(tsn.line[-n:, 0].numpy()[-80:],
                                          x[-80:, 0])
        if not (on_notch or on_den):
            np.testing.assert_array_equal(y[:, 0].numpy(), x[:, 0])
    # on the CPU the wrapper is the plain version, and counts no launch
    before = tnoise.lms_chain_block.launches
    y2, _, _ = tnoise.lms_chain_block(tn, td, tc(x), tsn, tsd, tc(en_n),
                                      tc(en_d))
    y3, _, _ = tnoise.lms_chain_block_plain(tn, td, tc(x), tsn, tsd,
                                            tc(en_n), tc(en_d))
    assert torch.equal(y2, y3)
    assert tnoise.lms_chain_block.launches == before


def test_lms_plain_three_blocks_random_enables():
    """Eight channels with seeded random enables a stage, three blocks of
    a length that is no multiple of the kernel's run (16), state carried:
    the plain version against the JAX scan."""
    tn, td = tnoise.LmsParams(notch=True), tnoise.LmsParams(notch=False)
    jn, jd = jnoise.LmsParams(notch=True), jnoise.LmsParams(notch=False)
    rng = np.random.default_rng(5)
    c, n = 8, 100
    en_n, en_d = rng.random(c) < 0.5, rng.random(c) < 0.5
    assert en_n.any() and en_d.any() and not (en_n & en_d).all()
    tsn, tsd = tnoise.init_lms(tn, c, "cpu"), tnoise.init_lms(td, c, "cpu")
    jsn, jsd = jnoise.init_lms(jn, c), jnoise.init_lms(jd, c)
    f = rng.uniform(200.0, 3000.0, c)
    for blk in range(3):
        t = (np.arange(n)[:, None] + n * blk) / FS
        x = (0.5 * np.sin(2 * np.pi * f * t)
             + 0.2 * rng.standard_normal((n, c))).astype(np.float32)
        y, tsn, tsd = tnoise.lms_chain_block_plain(
            tn, td, tc(x), tsn, tsd, tc(en_n), tc(en_d))
        yr, jsn, jsd = jnoise.lms_chain_block(
            jn, jd, jnp.asarray(x), jsn, jsd, jnp.asarray(en_n),
            jnp.asarray(en_d))
        close(y, yr, LOOP, f"block {blk}")
        for got, ref in ((tsn, jsn), (tsd, jsd)):
            close(got.weights, ref.weights, LOOP, scale=1.0)
            close(got.line, ref.line, LOOP)
    both_off = ~(en_n | en_d)
    if both_off.any():
        np.testing.assert_array_equal(y.numpy()[:, both_off], x[:, both_off])
    assert not tsn.weights[:, tc(~en_n)].any()
    assert bool(tsn.weights[:, tc(en_n)].any())


@pytest.mark.parametrize("notch", [True, False])
def test_lms_block_matches_reference(notch):
    """The one-stage line enhancer, notch and denoise modes, against the
    reference's ``lms_block`` scan over two blocks."""
    tp = tnoise.LmsParams(notch=notch)
    jp = jnoise.LmsParams(notch=notch)
    rng = np.random.default_rng(31)
    c, n = 3, 128
    ts, js = tnoise.init_lms(tp, c, "cpu"), jnoise.init_lms(jp, c)
    for blk in range(2):
        t = (np.arange(n)[:, None] + n * blk) / FS
        x = (np.sin(2 * np.pi * np.array([1000.0, 440.0, 2500.0]) * t)
             + 0.3 * rng.standard_normal((n, c))).astype(np.float32)
        y, ts = tnoise.lms_block(tp, tc(x), ts)
        yr, js = jnoise.lms_block(jp, jnp.asarray(x), js)
        close(y, yr, LOOP, f"block {blk}")
        close(ts.weights, js.weights, LOOP, scale=1.0)
        close(ts.line, js.line, LOOP)


@pytest.mark.parametrize("notch", [True, False])
def test_lms_block_is_one_stage_of_the_chain(notch):
    """What the card runs for ``lms_block``: kernel 5's chain with only
    the stage of the mode on.  On the CPU, through the chain's plain
    version, it gives the plain ``lms_block``'s output and state."""
    p = tnoise.LmsParams(notch=notch)
    rng = np.random.default_rng(32)
    c, n = 4, 96
    x = tc((np.sin(2 * np.pi * 700.0 * np.arange(n)[:, None] / FS)
            + 0.2 * rng.standard_normal((n, c))).astype(np.float32))
    st = tnoise.init_lms(p, c, "cpu")
    want, want_st = tnoise.lms_block_plain(p, x, st)
    on, off = torch.ones(c, dtype=torch.bool), torch.zeros(c, dtype=torch.bool)
    spare = tnoise.init_lms(p, c, "cpu")
    if notch:
        y, got, _ = tnoise.lms_chain_block_plain(p, p, x, st, spare, on, off)
    else:
        y, _, got = tnoise.lms_chain_block_plain(p, p, x, spare, st, off, on)
    torch.testing.assert_close(y, want, rtol=0, atol=1e-6)
    torch.testing.assert_close(got.weights, want_st.weights, rtol=0,
                               atol=1e-6)
    assert torch.equal(got.line, want_st.line)


def test_lms_notch_removes_tone():
    """The reference's ``tests/test_audio_ops.py`` case on the port."""
    p = tnoise.LmsParams(taps=32, delay=4, mu=0.05, notch=True)
    n = 4096
    tone = np.sin(2 * np.pi * 1000 * np.arange(n) / FS).astype(np.float32)
    st = tnoise.init_lms(p, 1, "cpu")
    y, st = tnoise.lms_block(p, tc(tone[:, None]), st)
    before = np.mean(tone[-512:] ** 2)
    after = np.mean(y[-512:, 0].numpy() ** 2)
    assert after < before * 0.1, (before, after)
