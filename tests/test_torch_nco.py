"""Port parity: 48-bit NCO words (int64) against the reference's limbs.

Tolerance: phase words are bit-exact; float32 cycles agree to 1 ulp.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flydog_sdr_gps_tpu.numerology import ADC_CLOCK_NOM
from flydog_sdr_gps_tpu.ops import nco as jnco
from flydog_sdr_gps_tpu_torch.ops import nco as tnco

M48 = 1 << 48


def _words(ints):
    return torch.tensor([int(v) for v in ints], dtype=torch.int64)


def _random_words(rng, n):
    w = [int(v) for v in rng.integers(0, M48, n, dtype=np.uint64)]
    return w + [0, 1, M48 - 1, M48 - 12345]          # edges


def test_freq_to_fcw_matches_reference():
    for f in (0.0, 1e6, 7.1e6, 14.2018e6, 29.999e6, -1500.0, 62.4e6):
        assert tnco.freq_to_fcw(f, ADC_CLOCK_NOM) == \
            jnco.freq_to_fcw(f, ADC_CLOCK_NOM)


def test_fcw_to_freq_round_trip_matches_reference():
    for f in (0.0, 10e6, 7.1234567e6, -3e6, 62.4e6, -62.5e6, 14.2018e6):
        fcw = tnco.freq_to_fcw(f, ADC_CLOCK_NOM)
        back = tnco.fcw_to_freq(fcw, ADC_CLOCK_NOM)
        assert back == jnco.fcw_to_freq(fcw, ADC_CLOCK_NOM)
        assert abs(back - f) < 1e-6
    for w in (0, 1, M48 // 2 - 1, M48 // 2, M48 - 1, M48 + 5):
        assert tnco.fcw_to_freq(w, ADC_CLOCK_NOM) == \
            jnco.fcw_to_freq(w, ADC_CLOCK_NOM)


def test_tone_matches_reference():
    """Same phase words; cos/sin of float32 cycles that agree to 1 ulp
    (2*pi * 2**-24 rad), so the samples within 2e-6."""
    rng = np.random.default_rng(5)
    phi, dphi = _random_words(rng, 6), _random_words(rng, 6)
    got = tnco.tone(_words(phi), _words(dphi), 300)
    assert got.dtype == torch.complex64 and got.shape == (300, 10)
    ref = jnco.tone(jnco.to_limbs(phi), jnco.to_limbs(dphi), 300)
    np.testing.assert_allclose(got.real.numpy(), np.asarray(ref.real),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(got.imag.numpy(), np.asarray(ref.imag),
                               rtol=0, atol=2e-6)


@pytest.mark.parametrize("num", [1, 129, 16384])
def test_ramp_words_bit_exact(num):
    rng = np.random.default_rng(num)
    phi0 = _random_words(rng, 6)
    dphi = _random_words(rng, 6)
    got = tnco.ramp_words(_words(phi0), _words(dphi), num)
    ref_limbs = jnco.limb_add(
        jnp.asarray(jnco.to_limbs(phi0))[None],
        jnco.limb_scale(jnp.asarray(jnco.to_limbs(dphi))[None],
                        jnp.arange(num, dtype=jnp.int32)[:, None]))
    ref = jnco.from_limbs(np.asarray(ref_limbs))
    assert got.tolist() == ref.tolist()
    # cycles: the same three-term float32 sum
    cyc_ref = np.asarray(jnco.phase_ramp(jnco.to_limbs(phi0),
                                         jnco.to_limbs(dphi), num))
    np.testing.assert_allclose(tnco.to_cycles(got).numpy(), cyc_ref,
                               rtol=0, atol=2.0 ** -24)


@pytest.mark.parametrize("num", [63488, (1 << 25) - 3, 21331968,
                                 (1 << 25) + 7])
def test_advance_overflow_edge(num):
    """n*dphi overflows a signed int64 here; the split product must not."""
    rng = np.random.default_rng(7)
    phi = _random_words(rng, 4)
    dphi = _random_words(rng, 4)
    got = tnco.advance(_words(phi), _words(dphi), num).tolist()
    ref = jnco.from_limbs(np.asarray(jnco.advance(
        jnp.asarray(jnco.to_limbs(phi)), jnp.asarray(jnco.to_limbs(dphi)),
        num)))
    assert got == ref.tolist()
    assert got == [(p + num * d) % M48 for p, d in zip(phi, dphi)]


def test_mul_mod48_full_range():
    rng = np.random.default_rng(3)
    n = _random_words(rng, 64)
    d = _random_words(rng, 64)
    got = tnco.mul_mod48(_words(n), _words(d)).tolist()
    assert got == [(a * b) % M48 for a, b in zip(n, d)]


def test_words_from_limbs_round_trip():
    rng = np.random.default_rng(5)
    w = _random_words(rng, 16)
    assert tnco.words_from_limbs(jnco.to_limbs(w)).tolist() == w


def test_ramp_words_at_the_waterfall_length():
    """One serving block at decimation 4 is a ramp of 5,332,992 rows:
    the reference cuts it into chunks (``phase_ramp_long``) because its
    int32 limb scale is bounded; the port's ``ramp_words`` has no limit.
    A naive int64 ``k * dphi`` overflows here (2**23 * 2**48).  Words
    bit-exact against the limb functions, chunk by chunk."""
    num = 2048 * 10416 // 4
    assert num == 5_332_992
    rng = np.random.default_rng(11)
    phi0 = int(rng.integers(0, M48, dtype=np.uint64))
    dphi = M48 - 12345                         # the largest products
    got = tnco.ramp_words(_words([phi0])[0], _words([dphi])[0], num)
    assert got.shape == (num,) and got.dtype == torch.int64
    got = got.numpy()
    d_limbs = jnp.asarray(jnco.to_limbs([dphi])[0])
    step = jnco.MAX_RAMP
    assert step < num
    for start in list(range(0, num, step))[::8] + [num - num % step]:
        n = min(step, num - start)
        p_limbs = jnp.asarray(
            jnco.to_limbs([(phi0 + start * dphi) % M48])[0])
        ref = jnco.from_limbs(np.asarray(jnco.limb_add(
            p_limbs[None], jnco.limb_scale(
                d_limbs[None], jnp.arange(n, dtype=jnp.int32)[:, None]))))
        assert got[start:start + n].tolist() == \
            np.asarray(ref).reshape(-1).tolist()
    # the float32 cycles are those of the reference's long ramp
    cyc = np.asarray(jnco.phase_ramp_long(
        jnp.asarray(jnco.to_limbs([phi0])[0]), d_limbs, num))
    np.testing.assert_allclose(
        tnco.to_cycles(torch.from_numpy(got)).numpy(), cyc, rtol=0,
        atol=2.0 ** -24)
    assert int(tnco.advance(_words([phi0])[0], _words([dphi])[0], num)) \
        == (phi0 + num * dphi) % M48
