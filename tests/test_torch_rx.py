"""Port parity: ``rx_block`` over three blocks, both stage-2 branches,
against the JAX reference on CPU — mixed modes (SAS, SAL, SAU, SAM, AM,
NBFM, USB, LSB, CW, IQ) with noise blankers (std and wild), spectral NR,
the LMS chain and de-emphasis switched on in some channels.

Two port runs, tuning and state converted from the reference's
(``convert``; the fused branch carries its stage-1 tail unrotated, the
unfused one rotated, so each branch converts its own):
- run A starts from the reference's ``init_state`` and streams the whole
  scene beside it;
- run B starts from the reference's state after ``WARMUP`` blocks —
  passband FIR filled (it spans 7 blocks at audio_block=128), AGC and
  SAM PLL settled on their carriers — and streams three more blocks.

Tolerance: audio within 2e-4*max|audio| + 5e-5 per block (the bound of
`tests/test_pallas_kernels.py:111`, where two rotator decompositions
differ the same way); the S-meter peak within 1e-3 dB.  Run B holds
every lane to both.  Run A holds the lanes with a linear demod (USB,
LSB, CW, IQ) to the audio bound in every block, and leaves the S-meter
and the FM, AM and SAM-family lanes to run B.  The reason: while the
FIR fills, a lane's level is orders below the ADC's, so the stage-1
float32 rounding (summed in another order than XLA's) is a sizeable
share of it; the AGC lifts that by up to 84 dB, the FM discriminator's
atan2 then jumps by 2*pi where the two runs straddle its branch cut, and
the SAM PLL acquires along a slightly different path — differences of
the reference's own transient, not of the port.  Once settled, the two
agree to ~3e-6 (run B).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from flydog_sdr_gps_tpu.models import rx_channel as jrx
from flydog_sdr_gps_tpu.numerology import ADC_CLOCK_NOM
from flydog_sdr_gps_tpu.ops import demod
from flydog_sdr_gps_tpu_torch import convert
from flydog_sdr_gps_tpu_torch.models import rx_channel as trx

C = 64                      # the reference's fused Pallas path needs C % 64
BLOCK = 128
MODES = [demod.MODE_SAS, demod.MODE_SAL, demod.MODE_SAU, demod.MODE_SAM,
         demod.MODE_AM, demod.MODE_NBFM, demod.MODE_USB, demod.MODE_LSB,
         demod.MODE_CW, demod.MODE_IQ]
JAX_STAGE2 = {"fused": "pallas_rot", "unfused": "poly"}


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _scene(params, nblocks, rng):
    """Carriers (one AM) on some channel frequencies, plus noise."""
    n = params.ddc.adc_block * nblocks
    t = np.arange(n, dtype=np.float64)
    x = 3e-3 * rng.standard_normal(n)
    for f, a in ((FM_CARRIER, 0.2), (7.1135e6, 0.1), (7.2045e6, 0.05)):
        x += a * np.cos(2 * np.pi * ((f / ADC_CLOCK_NOM * t) % 1.0))
    am = 1 + 0.6 * np.sin(2 * np.pi * ((700.0 / ADC_CLOCK_NOM * t) % 1.0))
    x += 0.2 * am * np.cos(2 * np.pi * ((AM_CARRIER / ADC_CLOCK_NOM * t) % 1))
    return x.astype(np.float32).reshape(nblocks, -1)


AM_CARRIER, FM_CARRIER = 7.152e6, 7.1005e6


def _reference_tuning(params):
    modes = [MODES[i % len(MODES)] for i in range(C)]
    # AM/SAM-family lanes within +-160 Hz of the AM carrier, FM lanes
    # near the plain carrier, the rest spread (some on empty spectrum)
    freqs = [AM_CARRIER + 5.0 * (i - C // 2)
             if m in (demod.MODE_AM, demod.MODE_SAM, demod.MODE_SAL,
                      demod.MODE_SAU, demod.MODE_SAS)
             else FM_CARRIER - 300.0 + 7.0 * i if m == demod.MODE_NBFM
             else 7.1e6 + 13e3 * i for i, m in enumerate(modes)]
    t = jrx.default_tuning(params, freqs_hz=freqs, modes=modes)
    idx = np.arange(C)
    flag = lambda mask: jnp.asarray(mask)
    return dataclasses.replace(
        t,
        nb_on=flag(idx % 5 == 1),
        nb_wild=flag(idx % 10 == 1),
        nr_on=flag(idx % 7 == 2),
        nr_notch_on=flag(idx % 9 == 3),
        nr_den_on=flag(idx % 11 == 4),
        deemph_on=flag(idx % 6 == 5),
        squelch_thresh=jnp.asarray(np.where(idx % 8 == 6, 0.5, 0.0)
                                   .astype(np.float32)),
        manual_gain_db=jnp.asarray(np.where(idx % 13 == 7, 20.0, np.nan)
                                   .astype(np.float32)))


WARMUP = 8
LINEAR_MODES = (demod.MODE_USB, demod.MODE_LSB, demod.MODE_CW, demod.MODE_IQ)


def _check(taps, jtaps, lanes, msg, smeter=True):
    ref = np.asarray(jtaps.audio)
    tol = 2e-4 * max(np.abs(ref).max(), 1e-6) + 5e-5
    for got, want in ((taps.audio, ref), (taps.audio2, jtaps.audio2)):
        np.testing.assert_allclose(got.numpy()[:, lanes],
                                   np.asarray(want)[:, lanes], rtol=0,
                                   atol=tol, err_msg=msg)
    if smeter:
        np.testing.assert_allclose(taps.smeter_dbm.numpy()[lanes],
                                   np.asarray(jtaps.smeter_dbm)[lanes],
                                   rtol=0, atol=1e-3, err_msg=msg)


@pytest.mark.parametrize("branch", ["fused", "unfused"])
def test_rx_block_three_blocks_match_reference(branch):
    jp = jrx.RxParams(num_channels=C, audio_block=BLOCK,
                      stage2=JAX_STAGE2[branch])
    tp = trx.RxParams(num_channels=C, audio_block=BLOCK, stage2=branch)
    assert jrx._use_fused_stage2(jp) == (branch == "fused")
    jt = _reference_tuning(jp)
    tt = convert.tuning_from_ref(_numpy_tree(jt), "cpu")
    assert (tt.any_nb_wild, tt.any_sideband, tt.any_lms,
            tt.any_spectral_nr) == (True, True, True, True)
    linear = np.isin(np.asarray(jt.mode), LINEAR_MODES)
    every = np.ones(C, bool)
    js = jrx.init_state(jp)
    run_a = convert.state_from_ref(_numpy_tree(js), tp, branch, "cpu")
    run_b = None
    step = jax.jit(lambda s, x: jrx.rx_block(jp, s, jt, x))
    for blk, x in enumerate(_scene(tp, WARMUP + 3,
                                   np.random.default_rng(11))):
        if blk == WARMUP:
            run_b = convert.state_from_ref(_numpy_tree(js), tp, branch,
                                           "cpu")
        js, jtaps = step(js, jnp.asarray(x))
        run_a, taps = trx.rx_block(tp, run_a, tt, torch.from_numpy(x))
        _check(taps, jtaps, linear, f"run A, block {blk}", smeter=False)
        if run_b is not None:
            run_b, taps = trx.rx_block(tp, run_b, tt, torch.from_numpy(x))
            _check(taps, jtaps, every, f"run B, block {blk}")
    assert np.abs(np.asarray(jtaps.audio)).max() > 0.1   # scene reached it


def test_default_tuning_matches_reference():
    modes = MODES[:8]
    freqs = [3.1e6 + 1.1e6 * i for i in range(8)]
    jt = _numpy_tree(jrx.default_tuning(
        jrx.RxParams(num_channels=8, audio_block=BLOCK), freqs_hz=freqs,
        modes=modes))
    tt = trx.default_tuning(trx.RxParams(num_channels=8, audio_block=BLOCK),
                            "cpu", freqs_hz=freqs, modes=modes)
    ref = convert.tuning_from_ref(jt, "cpu")
    for f in dataclasses.fields(tt):
        a, b = getattr(tt, f.name), getattr(ref, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype, f.name
            assert torch.equal(a.nan_to_num(), b.nan_to_num()), f.name
        else:
            assert a == b, f.name
    assert tt.any_sideband and not tt.any_lms


def test_state_conversion_refuses_the_other_branch():
    tp = trx.RxParams(num_channels=4, audio_block=BLOCK, stage2="unfused")
    js = _numpy_tree(jrx.init_state(jrx.RxParams(num_channels=4,
                                                 audio_block=BLOCK)))
    with pytest.raises(ValueError, match="rotated"):
        convert.state_from_ref(js, tp, "fused", "cpu")
