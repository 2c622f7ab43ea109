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

Also ``RxParams.from_config`` for every firmware configuration, the
full chain at 20.25 kHz (``rx3.wf3``, ``tests/test_rx3_20k.py``'s scene
and assertions) through both engines, and ``tests/test_rx14_mixed.py``'s
14-channel scenario with the wspr, FT8 and CW_decoder extensions on the
port's engine.

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
from flydog_sdr_gps_tpu.numerology import ADC_CLOCK_NOM, CONFIGS
from flydog_sdr_gps_tpu.ops import demod
from flydog_sdr_gps_tpu.runtime import source as jsource
from flydog_sdr_gps_tpu.runtime import stream as jstream
from flydog_sdr_gps_tpu_torch import convert
from flydog_sdr_gps_tpu_torch import extensions as text
from flydog_sdr_gps_tpu_torch import numerology as tnum
from flydog_sdr_gps_tpu_torch.models import rx_channel as trx
from flydog_sdr_gps_tpu_torch.runtime import source as tsource
from flydog_sdr_gps_tpu_torch.runtime import stream as tstream

C = 64                      # the reference's fused Pallas path needs C % 64
BLOCK = 128
MODES = [demod.MODE_SAS, demod.MODE_SAL, demod.MODE_SAU, demod.MODE_SAM,
         demod.MODE_AM, demod.MODE_NBFM, demod.MODE_USB, demod.MODE_LSB,
         demod.MODE_CW, demod.MODE_IQ]
JAX_STAGE2 = {"fused": "pallas_rot", "unfused": "poly", "fft": "fft"}


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


@pytest.mark.parametrize("branch", ["fused", "unfused", "fft"])
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


# -- firmware configurations and the 20.25 kHz chain --------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("block", [256, 2048])
def test_from_config_matches_reference(name, block):
    assert dataclasses.astuple(tnum.CONFIGS[name]) == \
        dataclasses.astuple(CONFIGS[name])
    jp = jrx.RxParams.from_config(CONFIGS[name], audio_block=block)
    tp = trx.RxParams.from_config(tnum.CONFIGS[name], audio_block=block)
    assert tp.num_channels == jp.num_channels == CONFIGS[name].rx_chans
    assert tp.snd_rate == jp.snd_rate and tp.fs_out == jp.fs_out
    assert (tp.ddc.d1, tp.ddc.d2) == (jp.ddc.d1, jp.ddc.d2)
    for taps in ("h1", "h2"):
        assert np.array_equal(getattr(tp.ddc, taps), getattr(jp.ddc, taps))
    assert (tp.ddc.adc_block, tp.ddc.k1, tp.ddc.tail1, tp.ddc.tail2) == \
        (jp.ddc.adc_block, jp.ddc.k1, jp.ddc.tail1, jp.ddc.tail2)
    assert (tp.fir.fft_size, tp.fir.ntaps, tp.fir.hop) == \
        (jp.fir.fft_size, jp.fir.ntaps, jp.fir.hop)
    for part in ("agc", "sam", "nr", "lms_notch_p", "lms_den_p"):
        assert dataclasses.asdict(getattr(tp, part)) == \
            dataclasses.asdict(getattr(jp, part)), part
    for coef in ("sb_coef_l", "sb_coef_u"):
        assert np.array_equal(np.asarray(getattr(tp, coef)),
                              np.asarray(getattr(jp, coef))), coef
    if name == "rx3.wf3":
        assert abs(tp.fs_out - ADC_CLOCK_NOM / 6172) < 1e-9
        assert (tp.ddc.d1, tp.ddc.d2) == (1543, 4)


def _tone(audio, fs, lo=100.0):
    w = np.abs(np.fft.rfft(audio * np.hanning(len(audio))))
    f = np.fft.rfftfreq(len(audio), 1.0 / fs)
    sel = f >= lo
    return f[sel][np.argmax(w[sel])]


def test_rx3_full_chain_20250hz_matches_reference():
    """``test_rx3_20k.py``'s scene through both engines (the port's
    default, fused, stage 2 beside the reference's CPU one): a USB lane
    at +7.2 kHz, an AM lane with 5.5 kHz modulation, an NBFM lane on
    empty spectrum.  USB and AM held to the audio bound in every block
    after the first (block 0 starts from the zero state while the DDC's
    filters fill; see the module docstring for why that transient is
    not compared); the NBFM lane hears only the 5e-4 rms noise, where
    its discriminator's atan2 amplifies rounding, so it is held to its
    level within 1 %, as ``test_torch_stream.py`` holds empty lanes."""
    cfg = CONFIGS["rx3.wf3"]
    f_usb, off_usb = 7.05e6, 7200.0
    f_am, mod_am = 14.2e6, 5500.0

    def tones():
        return ((f_usb + off_usb, 0.4),
                (f_am, 0.4,
                 lambda t: 1 + 0.6 * np.cos(2 * np.pi * mod_am * t)))
    ref = jstream.StreamEngine(jrx.RxParams.from_config(cfg, audio_block=256),
                               jsource.SyntheticSource(tones(), 0.0005))
    port = tstream.StreamEngine(
        trx.RxParams.from_config(tnum.CONFIGS["rx3.wf3"], audio_block=256),
        tsource.SyntheticSource(tones(), 0.0005), device="cpu")
    assert port.params.stage2 == "fused"
    for eng in (ref, port):
        eng.set_channel(0, freq_hz=f_usb, mode=demod.MODE_USB, in_use=True,
                        passband=(200.0, 9000.0))
        eng.set_channel(1, freq_hz=f_am, mode=demod.MODE_AM, in_use=True,
                        passband=(-8000.0, 8000.0))
        eng.set_channel(2, freq_hz=28.3e6, mode=demod.MODE_NBFM,
                        in_use=True)
    rows = []
    for blk in range(8):
        r = np.asarray(ref.run_block().audio)
        g = port.run_block().audio.numpy()
        rows.append(g)
        if blk >= 1:
            tol = 2e-4 * max(np.abs(r).max(), 1e-6) + 5e-5
            np.testing.assert_allclose(g[:, :2], r[:, :2], rtol=0, atol=tol,
                                       err_msg=f"block {blk}")
            np.testing.assert_allclose(np.sqrt((g[:, 2] ** 2).mean()),
                                       np.sqrt((r[:, 2] ** 2).mean()),
                                       rtol=1e-2, err_msg=f"block {blk}")
    # test_rx3_20k's own assertions, on the port
    fs = port.params.fs_out
    audio = np.concatenate(rows)[512:]
    assert audio.shape[1] == 3 and np.all(np.isfinite(audio))
    assert abs(_tone(audio[:, 0], fs) - off_usb) < 40
    assert abs(_tone(audio[:, 1], fs, lo=1000.0) - mod_am) < 40
    cfg_t = tnum.CONFIGS["rx3.wf3"]
    assert cfg_t.wf_chans == 3 and cfg_t.gps_chans > 0


def test_rx14_with_decoder_extensions():
    """``test_rx14_mixed.py`` on the port's engine: 14 channels, a
    wspr, an FT8 and a CW_decoder extension fed the engine's own taps
    (tensors) every block."""
    cfg = tnum.CONFIGS["rx14.wf0"]
    params = trx.RxParams.from_config(cfg, audio_block=128)
    assert params.num_channels == 14
    tones = [(5.0e6 + 2e6 * k + 1000.0, 0.25) for k in range(3)]
    eng = tstream.StreamEngine(params,
                               tsource.SyntheticSource(tones, 0.002),
                               device="cpu")
    for k in range(3):
        eng.set_channel(k, freq_hz=5.0e6 + 2e6 * k, mode=demod.MODE_USB,
                        in_use=True)
    for k in range(3, 14):
        eng.set_channel(k, freq_hz=1.0e6 + 2e6 * k, mode=demod.MODE_AM,
                        in_use=True)
    exts = [text.ext_create("wspr", eng, 0), text.ext_create("FT8", eng, 1),
            text.ext_create("CW_decoder", eng, 2)]
    for e in exts:
        e.start()
    rows = []
    for _ in range(6):
        taps = eng.run_block()
        rows.append(taps.audio.numpy().copy())
        for e in exts:
            e.process_block(taps)          # must not throw / stall
    audio = np.concatenate(rows)[256:]
    assert audio.shape[1] == 14 and np.all(np.isfinite(audio))
    for k in range(3):
        spec = np.abs(np.fft.rfft(audio[:, k] * np.hanning(len(audio))))
        f = np.fft.rfftfreq(len(audio), 1.0 / params.fs_out)
        assert abs(f[np.argmax(spec)] - 1000.0) < 60, k
    # the captures grew by every block, copied out of the taps
    assert exts[0]._samples == exts[1]._samples == 6 * 128
    np.testing.assert_array_equal(
        exts[1]._capture._buf[:6 * 128].numpy(),
        np.concatenate(rows)[:, 1])
