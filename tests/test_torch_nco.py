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
