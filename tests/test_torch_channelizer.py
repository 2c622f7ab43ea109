"""Port parity: the DDC (plan, bank, stage 1, both stage-2 kernels' plain
versions, the streaming ``ddc_block``) against the JAX reference on CPU.

Tolerances: host copies are exact; stage 1 (a float32 matmul summed in
another order) within 1e-5*max|ref|; the unfused stage 2 within atol
1e-4 on unit-variance input and the fused stage 2 within
2e-4*max|ref| (the reference's own `test_pallas_kernels.py` bounds);
three streamed DDC blocks within 1e-5*max|ref|.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flydog_sdr_gps_tpu.numerology import ADC_CLOCK_NOM, SND_RATE_20K
from flydog_sdr_gps_tpu.ops import channelizer as jchz
from flydog_sdr_gps_tpu.ops import cplx as jcplx
from flydog_sdr_gps_tpu.ops import nco as jnco
from flydog_sdr_gps_tpu.ops import pallas_kernels as pk
from flydog_sdr_gps_tpu.ops.windows import BLACKMAN_HARRIS, window
from flydog_sdr_gps_tpu_torch.ops import channelizer as tchz
from flydog_sdr_gps_tpu_torch.ops import kernels
from flydog_sdr_gps_tpu_torch.ops import nco as tnco

RATES = [12_000, SND_RATE_20K]


def _cplx_np(c):
    return np.asarray(c.re) + 1j * np.asarray(c.im)


def _random_words(rng, n):
    return [int(v) for v in rng.integers(0, 1 << 48, n, dtype=np.uint64)]


@pytest.mark.parametrize("rate", RATES)
def test_plan_and_filterbank_match_reference(rate):
    jp = jchz.make_ddc_plan(snd_rate=rate, audio_block=128)
    tp = tchz.make_ddc_plan(snd_rate=rate, audio_block=128)
    np.testing.assert_array_equal(tp.h1, jp.h1)
    np.testing.assert_array_equal(tp.h2, jp.h2)
    for prop in ("d1", "d2", "m1", "m2", "k1", "adc_block", "tail1",
                 "tail2", "fs_out"):
        assert getattr(tp, prop) == getattr(jp, prop), prop
    fcws = [jnco.freq_to_fcw(f, ADC_CLOCK_NOM) for f in (1e6, 7.1e6, 29e6)]
    br, bi, dphi = jchz.build_filterbank(jp, fcws)
    bank, words = tchz.build_filterbank(tp, fcws)
    np.testing.assert_array_equal(bank.real, br)
    np.testing.assert_array_equal(bank.imag, bi)
    assert words.tolist() == jnco.from_limbs(dphi).tolist()
    col, word = tchz.build_filterbank_column(tp, fcws[1])
    np.testing.assert_array_equal(col, bank[:, 1])
    assert word == words[1]


def test_stage1_apply_matches_reference():
    plan = tchz.make_ddc_plan(audio_block=128)
    jplan = jchz.make_ddc_plan(audio_block=128)
    c = 16
    rng = np.random.default_rng(0)
    x = (0.3 * rng.standard_normal(plan.k1 * plan.d1 + plan.tail1)
         ).astype(np.float32)
    fcws = _random_words(rng, c)
    br, bi, dphi = jchz.build_filterbank(jplan, fcws)
    phi = jnco.to_limbs(_random_words(rng, c))
    ref = _cplx_np(jchz.stage1_apply(jplan, jnp.asarray(x), jnp.asarray(br),
                                     jnp.asarray(bi), jnp.asarray(phi),
                                     jnp.asarray(dphi)))
    bank, words = tchz.build_filterbank(plan, fcws)
    got = tchz.stage1_apply(plan, torch.from_numpy(x),
                            torch.from_numpy(bank),
                            tnco.words_from_limbs(phi),
                            torch.from_numpy(words)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def _unit_noise(rng, kp, c):
    return (rng.standard_normal((kp, c))
            + 1j * rng.standard_normal((kp, c))).astype(np.complex64)


@pytest.mark.parametrize("rate", RATES)
def test_stage2_plain_matches_poly_and_pallas(rate):
    plan = jchz.make_ddc_plan(snd_rate=rate, audio_block=128)
    c = 64
    kp = plan.k1 + plan.tail2
    k2 = plan.audio_block
    y = _unit_noise(np.random.default_rng(1), kp, c)
    yj = jcplx.from_numpy(y)
    got = kernels.stage2(torch.from_numpy(y), plan.h2, plan.d2, k2).numpy()
    ref_poly = _cplx_np(jchz.stage2_apply(plan, yj, method="poly"))
    np.testing.assert_allclose(got, ref_poly, rtol=0, atol=1e-4)
    ref_pallas = _cplx_np(pk.stage2_pallas(yj, plan.h2, plan.d2, k2,
                                           interpret=True))
    np.testing.assert_allclose(got, ref_pallas, rtol=0, atol=1e-4)


def _rotate_then_poly(plan, y, phi0, dphi):
    """The reference composition: exact limb phase ramp, rotate, poly."""
    cyc = jnco.phase_ramp_long(jnp.asarray(jnco.to_limbs(phi0)),
                               jnp.asarray(jnco.to_limbs(dphi)), y.shape[0])
    rot = y * np.exp(-2j * np.pi * np.asarray(cyc, np.float64))
    return _cplx_np(jchz.stage2_apply(plan, jcplx.from_numpy(rot),
                                      method="poly"))


@pytest.mark.parametrize("rate", RATES)
def test_stage2_rot_plain_matches_pallas(rate):
    plan = jchz.make_ddc_plan(snd_rate=rate, audio_block=128)
    c = 64
    kp = plan.k1 + plan.tail2
    k2 = plan.audio_block
    rng = np.random.default_rng(2)
    y = _unit_noise(rng, kp, c)
    phi0, dphi = _random_words(rng, c), _random_words(rng, c)
    got = kernels.stage2_rot(torch.from_numpy(y), torch.tensor(phi0),
                             torch.tensor(dphi), plan.h2, plan.d2, k2).numpy()
    _, tc = pk.stage2_rot_tiles(k2, c, plan.d2, plan.l2)
    ref = _cplx_np(pk.stage2_rot_pallas(
        jchz.pack_cols(jcplx.from_numpy(y), tc),
        jnp.asarray(jnco.to_limbs(phi0)), jnp.asarray(jnco.to_limbs(dphi)),
        plan.h2, plan.d2, k2, interpret=True))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4 * scale)
    ref2 = _rotate_then_poly(plan, y, phi0, dphi)
    np.testing.assert_allclose(got, ref2, rtol=0, atol=2e-4 * scale)


@pytest.mark.parametrize("c", [14, 100])
def test_stage2_ragged_channel_counts(c):
    """Channel counts the TPU tiler refuses (`test_tiling_picker`)."""
    plan = jchz.make_ddc_plan(audio_block=64)
    kp = plan.k1 + plan.tail2
    rng = np.random.default_rng(c)
    y = _unit_noise(rng, kp, c)
    phi0, dphi = _random_words(rng, c), _random_words(rng, c)
    got = kernels.stage2_rot(torch.from_numpy(y), torch.tensor(phi0),
                             torch.tensor(dphi), plan.h2, plan.d2,
                             plan.audio_block).numpy()
    ref = _rotate_then_poly(plan, y, phi0, dphi)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2e-4 * np.abs(ref).max())
    got2 = kernels.stage2(torch.from_numpy(y), plan.h2, plan.d2,
                          plan.audio_block).numpy()
    ref2 = _cplx_np(jchz.stage2_apply(plan, jcplx.from_numpy(y),
                                      method="poly"))
    np.testing.assert_allclose(got2, ref2, rtol=0, atol=1e-4)


def test_ddc_block_three_blocks_match_reference():
    plan = tchz.make_ddc_plan(audio_block=128)
    jplan = jchz.make_ddc_plan(audio_block=128)
    freqs = [3.33e6, 7.0e6, 14.2e6, 21.1e6]
    fcws = [jnco.freq_to_fcw(f, ADC_CLOCK_NOM) for f in freqs]
    br, bi, dphi = jchz.build_filterbank(jplan, fcws)
    bank, words = tchz.build_filterbank(plan, fcws)
    jst = jchz.init_ddc_state(jplan, len(fcws))
    tst = tchz.init_ddc_state(plan, len(fcws), "cpu")
    rng = np.random.default_rng(4)
    for blk in range(3):
        t = np.arange(plan.adc_block) + blk * plan.adc_block
        x = (0.5 * np.cos(2 * np.pi * ((14.2011e6 / ADC_CLOCK_NOM * t) % 1))
             + 0.05 * rng.standard_normal(plan.adc_block)).astype(np.float32)
        jst, ref = jchz.ddc_block(jplan, jst, jnp.asarray(x), jnp.asarray(br),
                                  jnp.asarray(bi), jnp.asarray(dphi))
        tst, got = tchz.ddc_block(plan, tst, torch.from_numpy(x),
                                  torch.from_numpy(bank),
                                  torch.from_numpy(words))
        ref = _cplx_np(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=f"block {blk}")
        assert tst.phi1.tolist() == jnco.from_limbs(
            np.asarray(jst.phi1)).tolist()


def _tone_metrics(audio, fs_out):
    """(freq, amplitude, SINAD dB) of the dominant tone, measured as
    `tests/test_channelizer.py:tone_metrics` does."""
    n = len(audio)
    w = window(BLACKMAN_HARRIS, n).astype(np.float64)
    p = np.abs(np.fft.fft(audio * w)) ** 2
    peak = int(np.argmax(p))
    sig = p[[(peak + d) % n for d in range(-6, 7)]].sum()
    amp = np.sqrt(sig / (n * np.sum(w ** 2)))
    sinad = 10 * np.log10(sig / max(p.sum() - sig, 1e-30))
    return np.fft.fftfreq(n, 1.0 / fs_out)[peak], amp, sinad


def test_ddc_tone_sinad():
    """Full-scale tone 1 kHz above the tuned frequency -> a 1 kHz
    baseband tone, amplitude ~1.0, SINAD >= 80 dB."""
    plan = tchz.make_ddc_plan(audio_block=512)
    f_tuned = 7.040e6
    bank, words = tchz.build_filterbank(
        plan, [tnco.freq_to_fcw(f_tuned, ADC_CLOCK_NOM)])
    st = tchz.init_ddc_state(plan, 1, "cpu")
    outs = []
    for blk in range(3):
        t = np.arange(plan.adc_block, dtype=np.float64) + blk * plan.adc_block
        x = np.cos(2 * np.pi * (((f_tuned + 1000.0) / ADC_CLOCK_NOM * t) % 1)
                   ).astype(np.float32)
        st, a = tchz.ddc_block(plan, st, torch.from_numpy(x),
                               torch.from_numpy(bank),
                               torch.from_numpy(words))
        outs.append(a[:, 0].numpy())
    audio = np.concatenate(outs)[64:]
    f, amp, sinad = _tone_metrics(audio, plan.fs_out)
    assert abs(f - 1000.0) < plan.fs_out / len(audio) * 4, f
    assert abs(amp - 1.0) < 0.01, amp
    assert sinad > 80.0, sinad
