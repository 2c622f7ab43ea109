"""Port parity: the waterfall (``models/waterfall``) and the shared
waterfall subsystem (``server/wf_service``) against the JAX reference on
the CPU, same numpy-seeded input through both.

Tolerances:
- ``tune`` and the converted state: exact;
- the ring after ``wf_ingest``: 2e-5 * max|ring| (float32 FIR sums taken
  in another order: the port's blocked matrix product against the
  reference's framing matmul, and a complex product for the rotator);
- ``wf_frame`` rows: 0.1 dB where the reference row is above -120 dB
  (below it, the row is rounding noise of the FFT, which the two
  packages compute differently: a matmul FFT there, ``torch.fft`` here);
- ``wf_row_u8``: one count; ``ApertureAuto``: exact (host numpy copy);
- a chunked against a whole ingest: 1e-3 dB, as the reference's own test.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flydog_sdr_gps_tpu.models import waterfall as jwf
from flydog_sdr_gps_tpu.numerology import ADC_CLOCK_NOM, UI_SRATE_30M
from flydog_sdr_gps_tpu.server import wf_service as jsvc
from flydog_sdr_gps_tpu_torch import convert
from flydog_sdr_gps_tpu_torch.models import waterfall as twf
from flydog_sdr_gps_tpu_torch.server import wf_service as tsvc

BLOCK = 1 << 16
RING_TOL = 2e-5
ROW_TOL_DB = 0.1


def scene_block(rng, cf, blk, n=BLOCK, noise=0.05):
    """A tone 3 % of the zoom-0 rate above ``cf``, one at cf + 37 Hz
    (inside every zoom's span) and noise."""
    t = (blk * n + np.arange(n)) / ADC_CLOCK_NOM
    x = noise * rng.standard_normal(n)
    for f, a in ((cf + 0.9e6, 0.4), (cf + 37.0, 0.3)):
        x += a * np.cos(2 * np.pi * ((f * t) % 1.0))
    return x.astype(np.float32)


def ref_complex(c):
    return np.asarray(c.re) + 1j * np.asarray(c.im)


def ref_state_numpy(js):
    return dict(phi=np.asarray(js.phi), base_tail=np.asarray(js.base_tail),
                hb_tails=(np.asarray(js.hb_tails.re),
                          np.asarray(js.hb_tails.im)),
                ring=(np.asarray(js.ring.re), np.asarray(js.ring.im)))


def run_both(zoom, nblocks, cf=10.0e6, seed=0):
    """Both packages' states after ``nblocks`` blocks of the scene."""
    jp, tp = jwf.make_wf_params(zoom), twf.make_wf_params(zoom)
    br, bi, dl = jwf.tune(jp, cf)
    bank, dphi = convert.wf_tune_from_ref(br, bi, dl, "cpu")
    js, ts = jwf.init_state(jp), twf.init_state(tp, "cpu")
    rng = np.random.default_rng(seed)
    for blk in range(nblocks):
        x = scene_block(rng, cf, blk)
        js = jwf.wf_ingest(jp, js, jnp.asarray(x), jnp.asarray(br),
                           jnp.asarray(bi), jnp.asarray(dl))
        ts = twf.wf_ingest(tp, ts, torch.from_numpy(x), bank, dphi)
    return jp, tp, js, ts


@pytest.mark.parametrize("zoom", [0, 3, 10])
def test_params_and_tune_equal_reference(zoom):
    jp, tp = jwf.make_wf_params(zoom), twf.make_wf_params(zoom)
    np.testing.assert_array_equal(tp.h_base, jp.h_base)
    np.testing.assert_array_equal(tp.h_half, jp.h_half)
    assert (tp.total_decim, tp.wf_rate, tp.span) == \
        (jp.total_decim, jp.wf_rate, jp.span)
    for blk in (BLOCK, 512 * 10416, 2048 * 10416, 3 * 4096):
        assert tp.ingest_blocks(blk) == jp.ingest_blocks(blk)
    assert twf.make_wf_params(zoom) is tp                  # built once
    for cf in (15.0e6, 7.1e6, 29.99e6):
        br, bi, dl = jwf.tune(jp, cf)
        bank, dphi = twf.tune(tp, cf)
        np.testing.assert_array_equal(bank.real, br)
        np.testing.assert_array_equal(bank.imag, bi)
        cb, cd = convert.wf_tune_from_ref(br, bi, dl, "cpu")
        np.testing.assert_array_equal(cb.numpy(), bank)
        assert int(cd) == dphi


def test_deep_zoom_needs_two_serving_blocks():
    """z14 at the serving block (2048 audio samples) stitches two
    blocks; z13 does not."""
    block = 2048 * 10416
    assert twf.make_wf_params(14).ingest_blocks(block) == 2
    assert twf.make_wf_params(13).ingest_blocks(block) == 1


@pytest.mark.parametrize("zoom", [0, 3, 10])
def test_ingest_ring_matches_reference(zoom):
    nblocks = 3 if zoom < 10 else 40       # z10: 16 samples a block
    jp, tp, js, ts = run_both(zoom, nblocks)
    ring = ref_complex(js.ring)
    scale = np.abs(ring).max()
    assert scale > 0.1
    np.testing.assert_allclose(ts.ring.numpy(), ring, rtol=0,
                               atol=RING_TOL * scale)
    # carries: phase exact, tails within the same bound
    conv = convert.wf_state_from_ref(ref_state_numpy(js), "cpu")
    assert int(ts.phi) == int(conv.phi)
    np.testing.assert_array_equal(ts.base_tail.numpy(),
                                  conv.base_tail.numpy())
    assert ts.hb_tails.shape == conv.hb_tails.shape
    np.testing.assert_allclose(ts.hb_tails.numpy(), conv.hb_tails.numpy(),
                               rtol=0, atol=RING_TOL * max(
                                   float(conv.hb_tails.abs().max()), 1e-6))


def test_converted_state_continues_like_reference():
    """A reference state converted mid-stream, then one more block in
    both packages."""
    zoom, cf = 3, 10.0e6
    jp, tp, js, _ = run_both(zoom, 2)
    ts = convert.wf_state_from_ref(ref_state_numpy(js), "cpu")
    br, bi, dl = jwf.tune(jp, cf)
    bank, dphi = convert.wf_tune_from_ref(br, bi, dl, "cpu")
    x = scene_block(np.random.default_rng(5), cf, 2)
    js = jwf.wf_ingest(jp, js, jnp.asarray(x), jnp.asarray(br),
                       jnp.asarray(bi), jnp.asarray(dl))
    ts = twf.wf_ingest(tp, ts, torch.from_numpy(x), bank, dphi)
    ring = ref_complex(js.ring)
    np.testing.assert_allclose(ts.ring.numpy(), ring, rtol=0,
                               atol=RING_TOL * np.abs(ring).max())


@pytest.fixture(scope="module")
def states_z3():
    return run_both(3, 4)


@pytest.mark.parametrize("mode", twf.WF_MODES)
def test_frame_modes_match_reference(states_z3, mode):
    jp, tp, js, ts = states_z3
    ref = np.asarray(jwf.wf_frame(jp, js, mode=mode))
    got = twf.wf_frame(tp, ts, mode=mode).numpy()
    assert got.shape == ref.shape == (1024,) and got.dtype == np.float32
    seen = ref > -120.0
    assert seen.sum() > 900
    np.testing.assert_allclose(got[seen], ref[seen], rtol=0, atol=ROW_TOL_DB)
    assert np.all(got[~seen] < -120.0 + ROW_TOL_DB)
    assert abs(int(np.argmax(got)) - int(np.argmax(ref))) <= 1


@pytest.mark.parametrize("window", ["hanning", "hamming", "blackman-harris"])
def test_frame_mask_and_windows_match_reference(states_z3, window):
    jp, tp, js, ts = states_z3
    mask = np.ones(1024, np.float32)
    mask[500:530] = 0.0
    ref = np.asarray(jwf.wf_frame(jp, js, window, "cma",
                                  mask=jnp.asarray(mask)))
    got = twf.wf_frame(tp, ts, window, "cma",
                       mask=torch.from_numpy(mask)).numpy()
    seen = ref > -120.0
    np.testing.assert_allclose(got[seen], ref[seen], rtol=0, atol=ROW_TOL_DB)
    np.testing.assert_array_equal(got[500:530], ref[500:530])   # -300 dB
    assert np.all(got[500:530] < -250.0)
    with pytest.raises(ValueError, match="unknown wf mode"):
        twf.wf_frame(tp, ts, mode="median")


def test_row_u8_matches_reference(states_z3):
    jp, tp, js, ts = states_z3
    rows = [np.array(jwf.wf_frame(jp, js)),
            np.array([-300.0, -255.4, -254.6, -100.5, -0.4, 0.0, 3.0],
                     np.float32).copy()]
    for row in rows:
        ref = np.asarray(jwf.wf_row_u8(jnp.asarray(row)))
        got = twf.wf_row_u8(torch.from_numpy(row)).numpy()
        assert got.dtype == np.uint8
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    got = twf.wf_row_u8(twf.wf_frame(tp, ts)).numpy()
    ref = np.asarray(jwf.wf_row_u8(jwf.wf_frame(jp, js)))
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_fir_decimate_equals_direct_sum():
    """The blocked matrix product against the plain double sum, at
    output counts below, at and above a row of the product."""
    rng = np.random.default_rng(2)
    for k in (5, twf.FIR_BLOCK, 3 * twf.FIR_BLOCK + 17):
        taps, d = 32, 4
        ext = rng.standard_normal((k - 1) * d + taps).astype(np.float32)
        w = rng.standard_normal((taps, 1, 2)).astype(np.float32)
        wt = torch.from_numpy(w)
        got = twf._fir_decimate(
            torch.from_numpy(ext), lambda b: twf._toeplitz(wt, d, b), taps,
            1, 2, d, k).numpy().reshape(k, 2)
        ref = np.stack([ext[i * d:i * d + taps].astype(np.float64)
                        @ w[:, 0, :].astype(np.float64) for i in range(k)])
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
    with pytest.raises(ValueError, match="too short"):
        twf._fir_decimate(torch.zeros(10), None, 32, 1, 2, 4, 5)


def test_aperture_auto_equals_reference():
    rng = np.random.default_rng(1)
    for algo in (jwf.ApertureAuto.OFF, jwf.ApertureAuto.IIR,
                 jwf.ApertureAuto.MMA, jwf.ApertureAuto.EMA):
        ja = jwf.ApertureAuto(algo=algo, param=4.0, report_s=0.0)
        ta = twf.ApertureAuto(algo=algo, param=4.0, report_s=0.0)
        for i in range(12):
            row = -100.0 + 1.5 * rng.standard_normal(1024)
            row[100:104] = -60.0
            ja.accumulate(row)
            ta.accumulate(row)
        np.testing.assert_array_equal(ta.avg_pwr, ja.avg_pwr)
        assert ta.report(now=100.0) == ja.report(now=100.0) != None  # noqa: E711
        assert ta.report(now=100.5) == ja.report(now=100.5)


# ---------------------------------------------------------------------------
# the shared subsystem (the reference's tests/test_wf_service.py cases)
# ---------------------------------------------------------------------------

def tone_block(freq_hz, n=BLOCK, amp=0.5, ticks=0):
    t = (ticks + np.arange(n)) / ADC_CLOCK_NOM
    return (amp * np.cos(2 * np.pi * ((freq_hz * t) % 1.0))
            ).astype(np.float32)


def subsystems(**kw):
    return (jsvc.WfSubsystem(ADC_CLOCK_NOM, UI_SRATE_30M, **kw),
            tsvc.WfSubsystem(ADC_CLOCK_NOM, UI_SRATE_30M, device="cpu",
                             **kw))


def test_subsystem_defaults_to_the_card():
    import inspect
    sig = inspect.signature(tsvc.WfSubsystem)
    assert sig.parameters["device"].default == "cuda"


def test_slot_sharing_and_eviction():
    _, wf = subsystems(capacity=4)
    a = wf.attach(2, 1000)
    b = wf.attach(2, 1000)
    assert a is b and a.refs == 2          # same view -> one chain
    c = wf.attach(3, 1000)
    assert c is not a
    assert twf.make_wf_params(2, ADC_CLOCK_NOM, UI_SRATE_30M) is a.params
    wf.detach(b)
    wf.detach(a)
    assert a.refs == 0
    wf.detach(a)
    assert a.refs == 0                     # never negative
    # capacity: fill all slots, next distinct view denied, freed reused
    jw2, wf2 = subsystems(capacity=2)
    for w in (jw2, wf2):
        s1, s2 = w.attach(0, 0), w.attach(1, 0)
        assert s1 and s2
        assert w.attach(2, 0) is None
        w.detach(s2)
        s3 = w.attach(2, 0)
        assert s3 is not None
        assert set(w.slots) == {(0, 0, "cma"), (2, 0, "cma")}
    # the slot's view is the reference's
    for key in ((2, 1000, "cma"), (14, 16_000_000, "max"), (0, 0, "min")):
        js, ts = jw2._make_slot(key), wf2._make_slot(key)
        assert ts.cf == js.cf and ts.interp == js.interp
        np.testing.assert_array_equal(ts.tune[0].numpy().real,
                                      np.asarray(js.tune[0]))
        np.testing.assert_array_equal(ts.tune[0].numpy().imag,
                                      np.asarray(js.tune[1]))


def test_ingest_frame_and_masking_match_reference():
    jw, wf = subsystems(capacity=2)
    js, slot = jw.attach(0, 0), wf.attach(0, 0)     # full span, cf=15 MHz
    f_tone = 10.0e6
    for blk in range(3):
        x = tone_block(f_tone, ticks=blk * BLOCK)
        jw.ingest(jnp.asarray(x))
        wf.ingest(torch.from_numpy(x))
    ref, row = jw.frame(js), wf.frame(slot)
    assert row.shape == (1024,) and isinstance(row, np.ndarray)
    assert wf.frame(slot) is row and slot.row_seq == 1      # computed once
    px = int(np.argmax(row))
    expect_px = int(round((f_tone - (slot.cf - slot.params.span / 2))
                          / slot.params.span * 1024))
    assert abs(px - expect_px) <= 2
    floor_db = np.median(row)
    assert row[px] - floor_db > 40
    seen = ref > -120.0
    np.testing.assert_allclose(row[seen], ref[seen], rtol=0, atol=ROW_TOL_DB)

    # mask the tone's band -> its pixels go to the wire floor
    for w in (jw, wf):
        w.set_masked([(f_tone - 50e3, f_tone + 50e3)])
    ref2, row2 = jw.frame(js), wf.frame(slot)
    assert slot.row_seq == 2
    assert row2[px] < -250.0
    np.testing.assert_array_equal(row2 < -250.0, ref2 < -250.0)
    seen = ref2 > -120.0
    np.testing.assert_allclose(row2[seen], ref2[seen], rtol=0,
                               atol=ROW_TOL_DB)
    np.testing.assert_array_equal(
        wf._pixel_mask(slot.cf, slot.params.span),
        jw._pixel_mask(js.cf, js.params.span))


def test_interp_modes_ordering():
    _, wf = subsystems(capacity=4)
    rows = {}
    for mode in ("max", "cma", "min"):
        slot = wf.attach(1, 0, interp=mode)
    rng = np.random.default_rng(7)
    for _ in range(2):
        wf.ingest(torch.from_numpy(
            rng.standard_normal(BLOCK).astype(np.float32) * 0.1))
    for mode in ("max", "cma", "min"):
        rows[mode] = wf.frame(wf.slots[(1, 0, mode)])
    assert np.all(rows["max"] >= rows["cma"] - 1e-3)
    assert np.all(rows["cma"] >= rows["min"] - 1e-3)
    assert np.mean(rows["max"] - rows["min"]) > 1.0


def test_unreferenced_slot_is_not_advanced():
    _, wf = subsystems(capacity=2)
    slot = wf.attach(0, 0)
    wf.detach(slot)
    wf.ingest(torch.from_numpy(tone_block(10e6)))
    assert not slot.dirty and float(slot.state.ring.abs().max()) == 0.0


def test_two_block_stitch_matches_reference():
    """z14 needs 65536 samples an ingest: at 32768-sample blocks the
    subsystem stitches two, in both packages."""
    jw, wf = subsystems(capacity=1)
    start = int(10.0e6 / (UI_SRATE_30M / (1024 << 14)))
    js, slot = jw.attach(14, start), wf.attach(14, start)
    n = 32768
    assert slot.params.ingest_blocks(n) == 2
    rng = np.random.default_rng(3)
    nblocks = 101         # the 14-stage cascade settles after ~90 blocks
    for blk in range(nblocks):
        x = tone_block(slot.cf + 100.0, n=n, ticks=blk * n) \
            + 0.05 * rng.standard_normal(n).astype(np.float32)
        jw.ingest(jnp.asarray(x))
        wf.ingest(torch.from_numpy(x))
        assert len(slot.acc) == len(js.acc) == (blk + 1) % 2
        assert slot.dirty == js.dirty
    # fifty stitched ingests of 4 samples each reached the ring
    ring = ref_complex(js.state.ring)
    assert not ring[:-4 * (nblocks // 2)].any()
    assert np.abs(ring[-1]) > 0.2
    np.testing.assert_allclose(slot.state.ring.numpy(), ring, rtol=0,
                               atol=RING_TOL * np.abs(ring).max())
    assert int(slot.state.phi) == int(convert.wf_state_from_ref(
        ref_state_numpy(js.state), "cpu").phi)


def test_chunked_ingest_equals_whole():
    """The port's subsystem ingests a block whole, the reference's in
    chunks; the streaming tails make the two equal: ``wf_ingest`` on
    four slices of the block gives the whole ingest's ring and row."""
    z = 3
    jw, wf1 = subsystems(capacity=1)
    s1, js = wf1.attach(z, 5000), jw.attach(z, 5000)
    div = s1.params.total_decim
    n = 8 * div * 64
    x = tone_block(s1.cf + 1e4, n=n)
    jw.WF_CHUNK = n // 4                # the reference in 4 chunks
    state = twf.init_state(s1.params, "cpu")
    for off in range(0, n, n // 4):     # the port in 4 slices
        state = twf.wf_ingest(s1.params, state,
                              torch.from_numpy(x[off:off + n // 4]), *s1.tune)
    wf1.ingest(torch.from_numpy(x))
    jw.ingest(jnp.asarray(x))
    np.testing.assert_allclose(s1.state.ring.numpy(), state.ring.numpy(),
                               rtol=0, atol=RING_TOL * float(
                                   s1.state.ring.abs().max()))
    assert int(state.phi) == int(s1.state.phi)
    r1, ref = wf1.frame(s1), jw.frame(js)
    r2 = twf.wf_frame(s1.params, state, "hanning", s1.interp).numpy()
    np.testing.assert_allclose(r1, r2, atol=1e-3)
    seen = ref > -120.0
    np.testing.assert_allclose(r1[seen], ref[seen], rtol=0, atol=ROW_TOL_DB)
