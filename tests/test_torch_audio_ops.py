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
