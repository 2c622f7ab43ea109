"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips unless PyTorch sees an NVIDIA card.  On
the card's machine (which has no jax, so without this repo's conftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances as in the CPU parity tests: the unfused stage 2 within atol
1e-4 on unit-variance input, the fused one within 2e-4*max|ref|, the
AGC, SAM and LMS loops within 1e-4*max|ref| (where the plain version is
finite; its NaN and infinities must be matched exactly); the two stage-2
branches of ``rx_block`` within 2e-4*max|audio| + 5e-5; the served
(gathered) block exactly its own ``run_block`` columns.
"""

import numpy as np
import pytest
import torch

from flydog_sdr_gps_tpu_torch.models import rx_channel as rx
from flydog_sdr_gps_tpu_torch.ops import agc, demod, kernels, noise
from flydog_sdr_gps_tpu_torch.ops.channelizer import make_ddc_plan

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda", 0)


def test_stage1_refuses_tf32(card):
    from flydog_sdr_gps_tpu_torch.ops import channelizer as chz
    plan = make_ddc_plan(audio_block=64)
    x = torch.zeros(plan.k1 * plan.d1 + plan.tail1, device=card)
    bank = torch.zeros((plan.l1, 4), dtype=torch.complex64, device=card)
    assert chz.stage1_matmul(plan, x, bank).shape == (plan.k1, 4)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="full float32"):
            chz.stage1_matmul(plan, x, bank)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def _gen(device, seed):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("rate", [12_000, 20_250])
@pytest.mark.parametrize("c", [14, 100, 256])
def test_stage2_kernels_match_plain(card, rate, c):
    plan = make_ddc_plan(snd_rate=rate, audio_block=256)
    g = _gen(card, c)
    kp, k2 = plan.k1 + plan.tail2, plan.audio_block
    y = torch.complex(torch.randn((kp, c), generator=g, device=card),
                      torch.randn((kp, c), generator=g, device=card))
    w = torch.randint(0, 1 << 48, (2, c), generator=g, device=card)
    n_rot, n_plain = kernels.stage2_rot.launches, kernels.stage2.launches
    got = kernels.stage2_rot(y, w[0], w[1], plan.h2, plan.d2, k2)
    ref = kernels.stage2_rot_plain(y, w[0], w[1], plan.h2, plan.d2, k2)
    assert float((got - ref).abs().max()) <= 2e-4 * float(ref.abs().max())
    got = kernels.stage2(y, plan.h2, plan.d2, k2)
    ref = kernels.stage2_plain(y, plan.h2, plan.d2, k2)
    assert float((got - ref).abs().max()) <= 1e-4
    assert kernels.stage2_rot.launches == n_rot + 1
    assert kernels.stage2.launches == n_plain + 1


def test_scan_kernels_match_plain(card):
    n, c = 256, 300
    g = _gen(card, 5)
    params = agc.AgcParams(fs=12_000.0, hang_ms=3.0)
    mag = (torch.empty((1, c), device=card).uniform_(-120, 0, generator=g)
           + 6 * torch.randn((n, c), generator=g, device=card))
    env0 = torch.full((c,), -160.0, device=card)
    hang0 = torch.zeros(c, dtype=torch.int32, device=card)
    got = agc.envelope_scan(params, mag, env0, hang0)
    ref = agc.envelope_scan_plain(params, mag, env0, hang0)
    scale = float(ref[0].abs().max())
    assert float((got[0] - ref[0]).abs().max()) <= 1e-4 * scale
    assert torch.equal(got[2], ref[2])
    sam = demod.SamParams(fs=12_000.0)
    t = torch.arange(n, device=card, dtype=torch.float32)[:, None]
    off = torch.empty((1, c), device=card).uniform_(-0.03, 0.03, generator=g)
    z = torch.polar(torch.ones(n, c, device=card), off * t)
    zero = torch.zeros(c, device=card)
    got = demod.sam_pll(sam, z, zero, zero)
    ref = demod.sam_pll_plain(sam, z, zero, zero)
    assert float((got[0] - ref[0]).abs().max()) <= 1e-4 * float(
        ref[0].abs().max())


@pytest.mark.parametrize("c, k2", [(13, 256), (13, 200), (129, 75),
                                   (300, 1000)])
def test_stage2_rot_odd_c_and_ragged_run(card, c, k2):
    """Kernel 1 (and 2) at an odd channel count, where rows are only
    8-byte aligned, and at output counts that are no multiple of a
    block's run of outputs or of its row group."""
    plan = make_ddc_plan(audio_block=k2)
    g = _gen(card, 100 * c + k2)
    kp = plan.k1 + plan.tail2
    y = torch.complex(torch.randn((kp, c), generator=g, device=card),
                      torch.randn((kp, c), generator=g, device=card))
    w = torch.randint(0, 1 << 48, (2, c), generator=g, device=card)
    got = kernels.stage2_rot(y, w[0], w[1], plan.h2, plan.d2, k2)
    ref = kernels.stage2_rot_plain(y, w[0], w[1], plan.h2, plan.d2, k2)
    assert got.shape == (k2, c)
    assert float((got - ref).abs().max()) <= 2e-4 * float(ref.abs().max())
    got = kernels.stage2(y, plan.h2, plan.d2, k2)
    ref = kernels.stage2_plain(y, plan.h2, plan.d2, k2)
    assert float((got - ref).abs().max()) <= 1e-4


def _err_where_finite(got, ref):
    """(max |got - ref|, max |ref|) over the elements where ``ref`` is
    finite; elsewhere ``got`` must hold the same NaN or infinity."""
    fin = torch.isfinite(ref)
    a = torch.view_as_real(got) if got.is_complex() else got
    b = torch.view_as_real(ref) if ref.is_complex() else ref
    mask = fin[..., None] if got.is_complex() else fin
    assert torch.allclose(torch.where(mask, 0.0, a), torch.where(mask, 0.0, b),
                          rtol=0.0, atol=0.0, equal_nan=True)
    zero = torch.zeros((), dtype=ref.dtype, device=ref.device)
    g, r = torch.where(fin, got, zero), torch.where(fin, ref, zero)
    return float((g - r).abs().max()), float(r.abs().max())


@pytest.mark.parametrize("kind", ["zero", "negative_zero", "turns_zero",
                                  "nan", "inf", "tiny", "clamp_hi",
                                  "clamp_lo"])
def test_sam_pll_special_lanes_match_plain(card, kind):
    """The lanes for which the kernel leaves its fast path (err = arg(z)
    - phase): exactly zero samples, non-finite and tiny ones, and the
    +-fmax clamp, from a state with every quadrant of phase, over two
    blocks with a ragged last tile and a ragged channel edge."""
    n, c, lane = 200, 45, 7
    g = _gen(card, 9)
    sam = demod.SamParams(fs=12_000.0)
    t = torch.arange(n, device=card, dtype=torch.float32)[:, None]
    off = torch.empty((1, c), device=card).uniform_(-0.03, 0.03, generator=g)
    phase = torch.empty(c, device=card).uniform_(-3.14, 3.14, generator=g)
    freq = torch.empty(c, device=card).uniform_(-0.05, 0.05, generator=g)
    ph_ref, fr_ref = phase, freq
    for blk in range(2):
        z = torch.polar(1 + 0.5 * torch.sin(0.2 * t).expand(n, c), off * t) \
            + 0.02 * torch.complex(
                torch.randn((n, c), generator=g, device=card),
                torch.randn((n, c), generator=g, device=card))
        z = z.to(torch.complex64)
        if kind == "zero":
            z[:, lane] = 0
        elif kind == "negative_zero":
            z[:, lane] = complex(-0.0, 0.0)
        elif kind == "turns_zero":
            z[n // 2:, lane] = 0
        elif kind == "nan":
            z[n // 3, lane] = complex(float("nan"), 0.5)
        elif kind == "inf":
            z[n // 3, lane] = complex(float("inf"), 0.5)
        elif kind == "tiny":
            z[:, lane] *= 1e-36
        else:
            sign = 0.6 if kind == "clamp_hi" else -0.6
            z[:, lane] = torch.polar(torch.ones_like(t), sign * t)[:, 0]
        launches = demod.sam_pll.launches
        v, phase, freq = demod.sam_pll(sam, z, phase, freq)
        v_ref, ph_ref, fr_ref = demod.sam_pll_plain(sam, z, ph_ref, fr_ref)
        assert demod.sam_pll.launches == launches + 1
        err, scale = _err_where_finite(v, v_ref)
        assert err <= 1e-4 * scale
        assert _err_where_finite(freq, fr_ref)[0] <= 1e-4 * sam.fmax
        assert _err_where_finite(phase, ph_ref)[0] <= 1e-4 * np.pi
    if kind == "nan":
        assert bool(torch.isnan(freq[lane]))
    elif kind.startswith("clamp"):
        assert abs(abs(float(freq[lane])) - sam.fmax) < 1e-6


def test_rx_block_branches_agree_on_card(card):
    """Fused and unfused stage 2 over three blocks (the reference's
    `test_rx_block_fused_stage2_matches_default`, on the card)."""
    kw = dict(num_channels=64, audio_block=128)
    pa, pb = rx.RxParams(stage2="fused", **kw), \
        rx.RxParams(stage2="unfused", **kw)
    freqs = [7.1e6 + 13e3 * i for i in range(64)]
    ta = rx.default_tuning(pa, card, freqs_hz=freqs)
    sa, sb = rx.init_state(pa, card), rx.init_state(pb, card)
    g = _gen(card, 2)
    for blk in range(3):
        x = 0.3 * torch.randn(pa.ddc.adc_block, generator=g, device=card)
        sa, taps_a = rx.rx_block(pa, sa, ta, x)
        sb, taps_b = rx.rx_block(pb, sb, ta, x)
        aa, ab = taps_a.audio.cpu().numpy(), taps_b.audio.cpu().numpy()
        tol = 2e-4 * max(np.abs(aa).max(), 1e-6) + 5e-5
        np.testing.assert_allclose(ab, aa, atol=tol, err_msg=f"block {blk}")


@pytest.mark.parametrize("n", [75, 2048])
@pytest.mark.parametrize("c", [13, 100, 4096])
def test_agc_envelope_tiles_and_hang_match_plain(card, c, n):
    """Kernel 3 over ragged tiles (N = 75), ragged channel edges and both
    copy widths (C = 13: 4-byte copies, C = 100, 4096: 16-byte), with a
    hang of 72 samples, longer than a tile of 64 rows, so that a hang
    count is carried across a tile edge; two blocks, state carried.

    With a hang, the step is discontinuous where ``m > env`` is a near
    tie: the kernel's fused multiply-add and the plain version's two
    roundings can then decide differently, one of them restarts the hang
    and the two envelopes part by up to one decay step for its length.
    That is rounding, not a fault of the tiling, and it is rare (a few
    samples in ten million), so a lane in which it happened is set aside:
    there may be at most one in a thousand of them (at least one), and
    every other lane carries the full bound."""
    g = _gen(card, 1000 * c + n)
    params = agc.AgcParams(fs=12_000.0, hang_ms=6.0)
    assert params.hang_samples == 72
    env = torch.full((c,), -160.0, device=card)
    hang = torch.zeros(c, dtype=torch.int32, device=card)
    env_r, hang_r = env, hang
    parted = torch.zeros(c, dtype=torch.bool, device=card)
    for blk in range(2):
        # bursts: a level that drops by 40 dB for stretches of ~100 rows
        lvl = torch.empty((1, c), device=card).uniform_(-120, 0, generator=g)
        t = torch.arange(n, device=card)[:, None] + n * blk
        burst = ((t // 100 + torch.arange(c, device=card)[None]) % 2) * 40.0
        mag = lvl - burst + 3 * torch.randn((n, c), generator=g, device=card)
        launches = agc.envelope_scan.launches
        seq, env, hang = agc.envelope_scan(params, mag, env, hang)
        assert agc.envelope_scan.launches == launches + 1
        seq_r, env_r, hang_r = agc.envelope_scan_plain(params, mag, env_r,
                                                       hang_r)
        scale = float(seq_r.abs().max())
        err = (seq - seq_r).abs().amax(dim=0)
        parted |= (err > 1e-4 * scale) | (hang != hang_r)
        assert int(parted.sum()) <= max(1, c // 1000), parted.nonzero()
        # a parted lane is off by a decay step or two, never by more
        assert float(err.max()) <= 3 * params.decay_alpha * 200.0
        good = ~parted
        assert float((env - env_r).abs()[good].max()) <= 1e-4 * scale
        assert torch.equal(hang[good], hang_r[good])
        assert int(hang_r.max()) > 0                # some lanes are hanging
        env, hang = torch.where(good, env, env_r), torch.where(good, hang,
                                                                hang_r)


@pytest.mark.parametrize("c, n", [(13, 5), (13, 75), (13, 200), (100, 75),
                                  (100, 1000), (4096, 75), (4096, 200)])
def test_lms_chain_matches_plain(card, c, n):
    """Kernel 5 with every combination of enables side by side, at row
    counts that are no multiple of its run (16 samples, after which the
    two stages' warps meet) or of 64, and at one shorter than a run; two
    blocks with the state carried."""
    g = _gen(card, 77 * c + n)
    pn, pd = noise.LmsParams(notch=True), noise.LmsParams(notch=False)
    k = torch.arange(c, device=card)
    en_n, en_d = (k % 4 == 0) | (k % 4 == 1), (k % 4 == 0) | (k % 4 == 2)
    sn, sd = noise.init_lms(pn, c, card), noise.init_lms(pd, c, card)
    rn, rd = sn, sd
    t = torch.arange(2 * n, device=card, dtype=torch.float32)[:, None]
    f = torch.empty((1, c), device=card).uniform_(0.05, 1.0, generator=g)
    xs = 0.3 * torch.sin(f * t) + 0.1 * torch.randn((2 * n, c), generator=g,
                                                    device=card)
    for blk in range(2):
        x = xs[blk * n:(blk + 1) * n]
        launches = noise.lms_chain_block.launches
        y, sn, sd = noise.lms_chain_block(pn, pd, x, sn, sd, en_n, en_d)
        assert noise.lms_chain_block.launches == launches + 1
        yr, rn, rd = noise.lms_chain_block_plain(pn, pd, x, rn, rd, en_n,
                                                 en_d)
        scale = float(yr.abs().max())
        assert float((y - yr).abs().max()) <= 1e-4 * scale
        for got, ref in ((sn, rn), (sd, rd)):
            assert float((got.weights - ref.weights).abs().max()) <= 1e-4
            assert torch.equal(got.line, ref.line) or float(
                (got.line - ref.line).abs().max()) <= 1e-4 * scale
        off = ~(en_n | en_d)
        assert torch.equal(y[:, off], x[:, off])           # a copy
        assert not bool(sn.weights[:, ~en_n].any())
    with pytest.raises(ValueError, match="taps"):
        noise.lms_chain_block(noise.LmsParams(taps=32), pd, x, sn, sd, en_n,
                              en_d)


@pytest.mark.parametrize("which", ["one_lane", "all_on", "notch_only",
                                   "denoiser_only"])
def test_lms_chain_enable_patterns_at_full_width(card, which):
    """Kernel 5 at the main path's shape, (2048, 4096): one lane on (what
    one listener's SET nr gives), every stage on, and one stage alone
    (the other stage's warps only copy)."""
    c, n = 4096, 2048
    g = _gen(card, len(which))
    pn, pd = noise.LmsParams(notch=True), noise.LmsParams(notch=False)
    one = torch.zeros(c, dtype=torch.bool, device=card)
    one[c // 2 + 1] = True
    every = torch.ones(c, dtype=torch.bool, device=card)
    en_n, en_d = {"one_lane": (one, one), "all_on": (every, every),
                  "notch_only": (every, ~every),
                  "denoiser_only": (~every, every)}[which]
    sn, sd = noise.init_lms(pn, c, card), noise.init_lms(pd, c, card)
    t = torch.arange(n, device=card, dtype=torch.float32)[:, None]
    f = torch.empty((1, c), device=card).uniform_(0.05, 1.0, generator=g)
    x = 0.3 * torch.sin(f * t) + 0.1 * torch.randn((n, c), generator=g,
                                                   device=card)
    y, gn, gd = noise.lms_chain_block(pn, pd, x, sn, sd, en_n, en_d)
    yr, rn, rd = noise.lms_chain_block_plain(pn, pd, x, sn, sd, en_n, en_d)
    scale = float(yr.abs().max())
    assert float((y - yr).abs().max()) <= 1e-4 * scale
    for got, ref in ((gn, rn), (gd, rd)):
        assert float((got.weights - ref.weights).abs().max()) <= 1e-4
        assert float((got.line - ref.line).abs().max()) <= 1e-4 * scale
    off = ~(en_n | en_d)
    assert torch.equal(y[:, off], x[:, off])
    assert bool(torch.isfinite(y).all())


def test_served_block_equals_run_block_on_card(card):
    """``run_block_gather`` + the pinned, non-blocking fetch against the
    same columns of ``run_block`` from a second engine with the same
    seed, with one LMS lane and one spectral-NR lane on."""
    from flydog_sdr_gps_tpu_torch.runtime import (DeviceSceneSource,
                                                  StreamEngine)

    def make():
        params = rx.RxParams(num_channels=64, audio_block=256)
        src = DeviceSceneSource(tones=[(7.1e6, 0.3, ("am", 1000.0, 0.6))],
                                noise_rms=1e-3, block=params.ddc.adc_block,
                                device=card, seed=5)
        eng = StreamEngine(params, src, device=card)
        eng.set_channel(3, freq_hz=7.1e6, mode=demod.MODE_AM,
                        nr_notch_on=True, nr_den_on=True)
        eng.set_channel(9, freq_hz=7.0995e6, mode=demod.MODE_USB, nr_on=True)
        return eng

    a, b = make(), make()
    idx = np.array([3, 9, 0, 63], np.int32)
    assert all(buf.is_pinned() and buf.numel() == b.packed_len(64)
               for buf in b._fetch_bufs)
    pending = None
    for blk in range(3):
        taps = a.run_block()
        handle = b.start_fetch(b.run_block_gather(idx))
        if pending is not None:                # one fetch behind the block
            got, want = pending[0].result(), pending[1]
            assert got.shape == (b.packed_len(4),)
            np.testing.assert_array_equal(got, want)
        rows = [t[:, idx].T.reshape(-1) for t in (
            taps.audio, taps.audio2, taps.iq_post_agc.real,
            taps.iq_post_agc.imag)]
        want = torch.cat(rows + [taps.smeter_dbm,
                                 a._last_x.abs().max().reshape(1)])
        pending = (handle, want.cpu().numpy())
    np.testing.assert_array_equal(pending[0].result(), pending[1])
    assert noise.lms_chain_block.launches > 0
