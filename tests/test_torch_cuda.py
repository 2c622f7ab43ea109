"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips unless PyTorch sees an NVIDIA card.  On
the card's machine (which has no jax, so without this repo's conftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances as in the CPU parity tests: the unfused stage 2 within atol
1e-4 on unit-variance input, the fused one within 2e-4*max|ref|, the
AGC, SAM and LMS loops within 1e-4*max|ref| (where the plain version is
finite; its NaN and infinities must be matched exactly); the
spectral-NR recurrences within 1e-6 of each element; the two stage-2
branches of ``rx_block`` within 2e-4*max|audio| + 5e-5; the served
(gathered) block exactly its own ``run_block`` columns; the compiled
step (CUDA graphs) exactly the eager step, taps, served results and
state.
"""

import dataclasses

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


def _kept(taps):
    """A copy of a block's taps that outlives the next block."""
    return rx.RxTaps(**{f.name: getattr(taps, f.name).clone()
                        for f in dataclasses.fields(taps)})


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


# -- kernel 6: the GPS/Galileo tracking bank ---------------------------------

_GPS_IF = {}


def _gps_if(n_ep=400):
    """1-bit IF (n_ep, 16368) of two C/A and two E1B satellites, one of
    each with its code phase at the code-period boundary, so that the
    prompt's split falls inside the first epochs' windows."""
    if n_ep not in _GPS_IF:
        from flydog_sdr_gps_tpu_torch.models.gps import cacode, galileo
        rng = np.random.default_rng(11)
        n = 16368 * n_ep
        t = np.arange(n, dtype=np.float64) / 16.368e6
        x = 0.5 * rng.standard_normal(n)
        for prn, cp, fd, e1b in ((9, 300.0, 1500.0, False),
                                 (14, 1022.9, -2200.0, False),
                                 (3, 2000.25, 800.0, True),
                                 (5, 4091.8, -1200.0, True)):
            chips = cp + t * 1.023e6 * (1 + fd / 1.57542e9)
            idx = np.floor(chips).astype(np.int64)
            if e1b:
                c = galileo.e1b_code(prn).astype(np.float64)[idx % 4092]
                c = c * np.where(chips - idx < 0.5, 1.0, -1.0)
                c = c * np.where((idx // 4092) % 2 == 0, 1.0, -1.0)
            else:
                c = cacode.ca_code_any(prn).astype(np.float64)[idx % 1023]
            x += 0.6 * c * np.cos(2 * np.pi * (4.092e6 + fd) * t)
        _GPS_IF[n_ep] = np.sign(x).astype(np.float32).reshape(n_ep, 16368)
    return _GPS_IF[n_ep]


def _gps_bank(rows, device):
    """Up to 12 rows: C/A, E1B (BOC), an inactive row, the two rows at
    the code-period boundary, then C/A rows of absent PRNs, every third
    of them inactive."""
    from flydog_sdr_gps_tpu_torch.models.gps import galileo, tracking
    tp = tracking.TrackParams()
    st, tab = tracking.empty_track_state(tp, rows, device=device)
    spec = [(9, 300.2, 1530.0, False), (3, 2000.15, 820.0, True),
            (22, 100.0, 0.0, False), (14, 1022.8, -2230.0, False),
            (5, 4091.7, -1180.0, True)]
    spec += [(p, 37.0 * p, 250.0 * (p - 20), False) for p in range(23, 30)]
    for i, (prn, cp, dop, e1b) in enumerate(spec[:rows]):
        tracking.activate_channel(
            tp, st, tab, i, prn, cp, dop,
            code=galileo.e1b_code(prn) if e1b else None, boc=e1b)
        if i == 2 or (i > 5 and i % 3 == 0):
            tracking.deactivate_channel(st, i)
    return tp, st, tab


@pytest.mark.parametrize("n_ep", [1, 7, 400])
@pytest.mark.parametrize("rows", [1, 5, 12])
def test_gps_track_kernel_matches_plain(card, rows, n_ep):
    """Sums within 1e-3 x max|ip|, code phase within 1e-3 chip, carrier
    frequency within 1e-6 relative (the plain version does the kernel's
    arithmetic; only the sums' order differs)."""
    from flydog_sdr_gps_tpu_torch.models.gps import tracking
    tp, st, tab = _gps_bank(rows, card)
    raw = torch.as_tensor(_gps_if()[:n_ep], device=card)
    s_k, s_p = st.clone(), st.clone()
    launches = tracking.track_epochs.launches
    _, o_k = tracking.track_epochs(tp, s_k, tab, raw)
    _, o_p = tracking.track_epochs_plain(tp, s_p, tab, raw)
    torch.cuda.synchronize()
    assert tracking.track_epochs.launches == launches + 1
    scale = float(o_p["ip"].abs().max())
    for k in ("ip", "qp", "ip_pre", "qp_pre"):
        assert float((o_k[k] - o_p[k]).abs().max()) <= 1e-3 * scale, k
    for a, b in ((o_k["code_phase"], o_p["code_phase"]),
                 (s_k.code_phase, s_p.code_phase)):
        assert float((a - b).abs().max()) <= 1e-3
    for a, b in ((o_k["carr_freq"], o_p["carr_freq"]),
                 (s_k.carr_freq, s_p.carr_freq)):
        assert float(((a - b).abs() / b.abs()).max()) <= 1e-6
    for name in ("carr_phase", "code_rate", "ip_prev", "qp_prev"):
        a, b = getattr(s_k, name), getattr(s_p, name)
        tol = 1e-3 * scale if name.endswith("prev") else 1e-5
        assert float((a - b).abs().max()) <= tol, name
    # inactive rows keep their loop state
    idle = ~st.active
    assert torch.equal(s_k.code_phase[idle], st.code_phase[idle])
    assert torch.equal(s_k.carr_freq[idle], st.carr_freq[idle])


def test_gps_track_kernel_refuses_arguments_off_the_card(card):
    """A code table or a state field that is not on the card (or not of
    its dtype) is refused by name before the launch; a misaligned chunk
    is copied, not refused."""
    from flydog_sdr_gps_tpu_torch.models.gps import tracking
    tp, st, tab = _gps_bank(3, card)
    raw = torch.as_tensor(_gps_if()[:2], device=card)
    launches = tracking.track_epochs.launches
    with pytest.raises(ValueError, match="code_table"):
        tracking.track_epochs(tp, st.clone(), tab.cpu(), raw)
    bad = st.clone()
    bad.active = bad.active.to(torch.uint8)
    with pytest.raises(ValueError, match="state.active"):
        tracking.track_epochs(tp, bad, tab, raw)
    bad = st.clone()
    bad.carr_freq = bad.carr_freq.cpu()
    with pytest.raises(ValueError, match="state.carr_freq"):
        tracking.track_epochs(tp, bad, tab, raw)
    assert tracking.track_epochs.launches == launches
    # a misaligned chunk is copied, not refused
    flat = torch.as_tensor(_gps_if()[:3], device=card).reshape(-1)
    s_k, s_p = st.clone(), st.clone()
    mis = flat[1:1 + 2 * 16368].reshape(2, 16368)
    assert mis.data_ptr() % 16
    _, o_k = tracking.track_epochs(tp, s_k, tab, mis)
    _, o_p = tracking.track_epochs_plain(tp, s_p, tab, mis)
    assert float((o_k["ip"] - o_p["ip"]).abs().max()) <= \
        1e-3 * float(o_p["ip"].abs().max())
    assert tracking.track_epochs.launches == launches + 1
    assert tracking.max_active_clusters(12) >= 1


def test_gps_receiver_runs_its_device_work_on_its_own_stream(card):
    """``GpsReceiver`` with a manager on the card: the scene, the search
    and kernel 6 run on the receiver's stream, not the default one the
    engine's block program uses; the sky is still searched and tracked."""
    import asyncio

    from flydog_sdr_gps_tpu_torch.models.gps import manager, scene, tracking
    from flydog_sdr_gps_tpu_torch.runtime import GpsReceiver
    rx_pos = scene.ecef_from_lla(47.37, 8.54, 450.0)
    ephs = scene.visible_constellation(rx_pos, 345603.0, n_sats=3)
    sky = scene.GpsScene(rx_pos, ephs, 345603.0, duration=5.0,
                         clock_ppm=0.4, noise=0.8, amplitude=0.6,
                         device=card)
    mgr = manager.GpsManager(max_chans=4, prns=tuple(ephs), device=card)
    rec = GpsReceiver(sky, mgr, chunk_seconds=0.1)
    seen = []
    for obj, name in ((sky, "next_block"), (mgr, "process")):
        def spy(*a, _fn=getattr(obj, name)):
            seen.append(torch.cuda.current_stream(card))
            return _fn(*a)
        setattr(obj, name, spy)
    launches = tracking.track_epochs.launches

    async def drive():
        task = asyncio.create_task(rec.run())
        while mgr.ticks < 4 * rec.chunk and not task.done():
            await asyncio.sleep(0.01)
        rec.stop()
        await task
    asyncio.run(drive())
    assert rec.errors == 0 and len(seen) >= 8
    assert rec._stream != torch.cuda.default_stream(card)
    assert all(s == rec._stream for s in seen)
    assert set(mgr.channels) == set(ephs)
    assert tracking.track_epochs.launches > launches


def _nr_spectra(card, c, nblocks, seed):
    """One-sided spectra of nblocks chained blocks of audio as
    spectral_nr_block frames them (tones in noise, a tone a channel),
    (16, 129, c) complex64 each, in torch.fft's layout."""
    g = _gen(card, seed)
    p = noise.SpectralNRParams()
    n, hop, fft = 2048, p.hop, p.fft_size
    win = torch.as_tensor(np.hanning(fft + 1)[:fft].astype(np.float32),
                          device=card)
    f = torch.empty((1, c), device=card).uniform_(0.05, 1.0, generator=g)
    out = []
    for blk in range(nblocks):
        t = torch.arange(n + hop, device=card, dtype=torch.float32)[:, None]
        x = 0.3 * (blk % 2) * torch.sin(f * (t + blk * n)) + 0.1 * torch.randn(
            (n + hop, c), generator=g, device=card)
        frames = x.unfold(0, fft, hop).transpose(1, 2)
        out.append(torch.fft.fft(frames * win[None, :, None], dim=1)
                   [:, :fft // 2 + 1])
    return out


@pytest.mark.parametrize("rule", ["subtract", "mmse"])
@pytest.mark.parametrize("c", [1, 37, 4096])
def test_spectral_nr_kernel_matches_plain(card, c, rule):
    """Kernel 7 against its plain version over three chained blocks,
    each version carrying its own state: every element of X * g and of
    every state field within 1e-6 of the plain version's, relative (the
    plain version's operations, rounded as PyTorch rounds them)."""
    p = noise.SpectralNRParams(gain_rule=rule)
    st_k = noise.init_spectral_nr(p, c, card)
    st_p = noise.init_spectral_nr(p, c, card)
    launches = noise.spectral_nr_gains.launches
    for blk, spec in enumerate(_nr_spectra(card, c, 3, c)):
        got = noise.spectral_nr_gains(p, spec, st_k)
        ref = noise.spectral_nr_gains_plain(p, spec, st_p)
        for name, a, b in zip(("spec_g", "psd_smooth", "min_ring", "xhat2"),
                              got, ref):
            assert a.shape == b.shape, name
            off = (a - b).abs() > 1e-6 * b.abs()
            assert not off.any(), (blk, name, int(off.sum()))
        st_k = dataclasses.replace(st_k, psd_smooth=got[1], min_ring=got[2],
                                   xhat2=got[3])
        st_p = dataclasses.replace(st_p, psd_smooth=ref[1], min_ring=ref[2],
                                   xhat2=ref[3])
    assert noise.spectral_nr_gains.launches == launches + 3
    if rule == "subtract":
        assert not st_k.xhat2.any()


def test_spectral_nr_kernel_refuses_state_off_the_card(card):
    """A state field off the card, of the wrong dtype or shape, or a
    spectrum that is not complex64, is refused by name before the
    launch."""
    p = noise.SpectralNRParams()
    spec = _nr_spectra(card, 8, 1, 3)[0]
    st = noise.init_spectral_nr(p, 8, card)
    launches = noise.spectral_nr_gains.launches
    for name, bad in (("psd_smooth", st.psd_smooth.cpu()),
                      ("min_ring", st.min_ring.double()),
                      ("xhat2", st.xhat2[:, :4]),
                      ("min_ring", st.min_ring[1:])):
        with pytest.raises(ValueError, match=f"state.{name}"):
            noise.spectral_nr_gains(p, spec, dataclasses.replace(
                st, **{name: bad}))
    with pytest.raises(ValueError, match="spec"):
        noise.spectral_nr_gains(p, spec.to(torch.complex128), st)
    assert noise.spectral_nr_gains.launches == launches


def test_spectral_nr_block_runs_the_kernel_on_card(card, monkeypatch):
    """spectral_nr_block on the card goes through kernel 7 and no plain
    loop, and stays within 1e-4 x scale of the same block on the CPU."""
    p = noise.SpectralNRParams()
    c = 64
    rng = np.random.default_rng(4)
    st_g = noise.init_spectral_nr(p, c, card)
    st_c = noise.init_spectral_nr(p, c, "cpu")
    launches = noise.spectral_nr_gains.launches
    plain = noise.spectral_nr_gains_plain
    calls = []
    monkeypatch.setattr(noise, "spectral_nr_gains_plain",
                        lambda *a: calls.append(a[1].device.type) or plain(*a))
    for blk in range(3):
        x = (0.1 * rng.standard_normal((2048, c))).astype(np.float32)
        y_g, st_g = noise.spectral_nr_block(p, torch.as_tensor(
            x, device=card), st_g)
        y_c, st_c = noise.spectral_nr_block(p, torch.as_tensor(x), st_c)
        y_c = y_c.to(card)
        assert float((y_g - y_c).abs().max()) <= \
            1e-4 * float(y_c.abs().max()), blk
    assert calls == ["cpu"] * 3
    assert noise.spectral_nr_gains.launches == launches + 3


# -- the decoders' front ends and the 20.25 kHz engine ------------------------

def _audio(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 12000.0
    return (0.3 * np.sin(2 * np.pi * 1520.0 * t)
            + 0.2 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("which", ["wspr", "ft8", "ft4", "fft"])
def test_frontend_on_card_matches_cpu(card, which):
    """Each front end on the card against its CPU run on the same audio,
    within 1e-5 of the plane's max (the CPU bound against the reference:
    cuFFT and MKL sum in other orders)."""
    from flydog_sdr_gps_tpu_torch.extensions import (audio_fft, ft4, ft8,
                                                      wspr)
    if which == "wspr":
        x = torch.from_numpy(_audio(int(wspr.CAPTURE_S * 12000), 31))
        outs = [wspr.frontend(x.to(d)) for d in ("cpu", card)]
    elif which == "fft":
        z = torch.from_numpy(_audio(2 * audio_fft.FFT_N, 32)).view(
            torch.complex64)
        outs = [(audio_fft.spectrum(z.to(d)),) for d in ("cpu", card)]
    else:
        mod = ft8 if which == "ft8" else ft4
        cls = ft8.Ft8Ext if which == "ft8" else ft4.Ft4Ext
        x = torch.from_numpy(_audio(int(cls.CAPTURE_S * 12000), 33))
        outs = [(mod.spectrogram(x.to(d)),) for d in ("cpu", card)]
    for ref, got in zip(*outs):
        assert got.is_cuda and got.dtype == ref.dtype
        assert got.shape == ref.shape
        err = float((got.cpu() - ref).abs().max())
        assert err <= 1e-5 * float(ref.abs().max()), (which, err)


@pytest.mark.parametrize("name", ["FT8", "FFT", "wspr"])
def test_front_end_runs_on_its_own_stream(card, name):
    """Fed the server's ``HostTaps`` while the default stream still has
    a long queue (the next block's step, in the server), an extension's
    front end and the copy of its results to the host do not wait for
    that queue: they run on the extension's own stream.  Steady state:
    a first capture (a spectrum, for FFT) has run before, so the
    stream's buffers are in the allocator's cache (a first allocation
    on a stream calls cudaMalloc, which waits for the card)."""
    from flydog_sdr_gps_tpu_torch import extensions as ext_mod
    from flydog_sdr_gps_tpu_torch.server.kiwi_server import HostTaps

    class Engine:
        device = card
        source = None

        class params:
            fs_out = 12000.0
    e = ext_mod.ext_create(name, Engine(), 0)
    e.start()
    if name != "FFT":
        e.capture_samples = 2048        # a capture a block
    rng = np.random.default_rng(41)
    taps = []
    for _ in range(3):
        r = rng.standard_normal((1, 2048)).astype(np.float32)
        taps.append(HostTaps(r, r, r, r, np.zeros(1, np.float32), {0: 0}))
    e.process_block(taps[0])
    assert e.process_block(taps[1]), name          # the first capture
    torch.cuda.synchronize()
    big = torch.randn(8192, 8192, device=card)
    for _ in range(40):                 # ~1 s of the default stream
        big = big @ big / 8192.0
    queued = torch.cuda.Event()
    queued.record()
    assert e.process_block(taps[2]), name
    assert not queued.query(), "the front end waited for the default stream"
    assert e._side._stream != torch.cuda.default_stream(card)
    torch.cuda.synchronize()


def test_rx3_engine_on_card_matches_cpu(card):
    """``rx3.wf3`` (20.25 kHz, d2=4) at audio_block=2048 on the card and
    on the CPU from one scene, 3 blocks: an AM lane on 7.1 MHz and a USB
    lane 7.2 kHz below the 14.2018 MHz tone.  Their S-meters within 1e-3
    dB in every block; their audio within 2e-4*max|audio| + 5e-5 from
    block 1 on (block 0 starts from the zero state, where the AGC lifts
    float32 sums in another order by up to 84 dB: the CPU tests leave
    that transient out for the same reason)."""
    from flydog_sdr_gps_tpu_torch.numerology import CONFIGS
    from flydog_sdr_gps_tpu_torch.runtime import (DeviceSceneSource,
                                                  StreamEngine)
    params = rx.RxParams.from_config(CONFIGS["rx3.wf3"], audio_block=2048)
    taps = {}
    for dev in ("cpu", card):
        src = DeviceSceneSource(tones=[(7.1e6, 0.3, ("am", 1000.0, 0.6)),
                                       (14.2018e6, 0.15)], noise_rms=3e-4,
                                block=params.ddc.adc_block, device=dev)
        eng = StreamEngine(params, src, device=dev)
        eng.set_channel(0, freq_hz=7.1e6, mode=demod.MODE_AM, in_use=True)
        eng.set_channel(1, freq_hz=14.1946e6, mode=demod.MODE_USB,
                        in_use=True, passband=(200.0, 9000.0))
        # kept past the next block: copied (the card's engine runs the
        # compiled step, whose taps are buffers the next block overwrites)
        taps[str(dev)] = [_kept(eng.run_block()) for _ in range(3)]
    for blk, (ref, got) in enumerate(zip(taps["cpu"], taps[str(card)])):
        assert got.audio.is_cuda and bool(torch.isfinite(got.audio).all())
        sm = (got.smeter_dbm.cpu() - ref.smeter_dbm)[:2]
        assert float(sm.abs().max()) <= 1e-3, blk
        if blk:
            want = ref.audio[:, :2]
            tol = 2e-4 * float(want.abs().max()) + 5e-5
            assert float((got.audio[:, :2].cpu() - want).abs().max()) \
                <= tol, blk


@pytest.mark.parametrize("name", ["S_meter", "IQ_display", "CW_decoder"])
def test_extensions_read_cuda_taps(card, name):
    """Extensions that read one column of a tap (``extensions/taps.py``)
    give on the card's taps, at the main path's (2048, 4096), the
    messages they give on the same taps on the CPU; three blocks, a new
    tap tensor each, channel 1234 keyed with a 500 Hz tone (the CW
    decoder's pitch)."""
    import types
    from flydog_sdr_gps_tpu_torch import extensions as ext_mod
    eng = types.SimpleNamespace(params=types.SimpleNamespace(fs_out=12000.0))
    rng = np.random.default_rng(29)
    B, C, ch = 2048, 4096, 1234
    t = np.arange(3 * B) / 12000.0
    key = (np.arange(3 * B) // 1200) % 2
    msgs = {}
    for dev in ("cpu", card):
        rng = np.random.default_rng(29)
        e = ext_mod.ext_create(name, eng, ch)
        e.start()
        out = []
        for k in range(3):
            audio = 0.05 * rng.standard_normal((B, C)).astype(np.float32)
            sl = slice(k * B, (k + 1) * B)
            audio[:, ch] += (0.5 * key[sl] * np.sin(2 * np.pi * 500.0 * t[sl])
                             ).astype(np.float32)
            iq = (rng.standard_normal((B, C))
                  + 1j * rng.standard_normal((B, C))).astype(np.complex64)
            smeter = rng.uniform(-120.0, -20.0, C).astype(np.float32)
            a = torch.from_numpy(audio).to(dev)
            z = torch.from_numpy(iq).to(dev)
            taps = rx.RxTaps(audio=a, audio2=a, iq_pre_fir=z, iq_post_agc=z,
                             smeter_dbm=torch.from_numpy(smeter).to(dev))
            out.append(e.process_block(taps))
        msgs[str(dev)] = out
    assert msgs[str(card)] == msgs["cpu"]
    assert name == "CW_decoder" or all(msgs["cpu"])


def test_mesh_engine_on_card_matches_unfused(card):
    """The multi-device engine over a (2, 2) mesh of the one card, each
    shard's stage 2 on kernel 2 and its back half on kernels 3 and 4,
    against the unfused single-device engine on the same blocks (the
    reference's bounds: iq 1e-5, audio 3e-3, S-meter 0.1 dB)."""
    from flydog_sdr_gps_tpu_torch import parallel
    from flydog_sdr_gps_tpu_torch.runtime import (DeviceSceneSource,
                                                  ShardedStreamEngine,
                                                  StreamEngine)
    tones = [(7.100e6, 0.30, ("am", 1000.0, 0.6)), (14.2018e6, 0.15)]

    def engine(stage2, mesh=None):
        params = rx.RxParams(num_channels=64, audio_block=256, stage2=stage2)
        src = DeviceSceneSource(tones=tones, noise_rms=3e-4,
                                block=params.ddc.adc_block, device=card)
        eng = (StreamEngine(params, src, device=card) if mesh is None
               else ShardedStreamEngine(params, src, mesh=mesh))
        eng.set_channel(0, freq_hz=7.100e6, mode=demod.MODE_AM)
        eng.set_channel(33, freq_hz=14.200e6, mode=demod.MODE_USB)
        return eng
    mesh = parallel.make_mesh(2, 2, devices=[card] * 4)
    eng, ref = engine("fused", mesh), engine("unfused")
    for blk in range(4):
        n2, n3 = kernels.stage2.launches, agc.envelope_scan.launches
        got = eng.run_block()
        assert kernels.stage2.launches == n2 + 4
        assert agc.envelope_scan.launches == n3 + 4
        want = ref.run_block()
        assert float((got.iq_pre_fir - want.iq_pre_fir).abs().max()) <= 1e-5
        assert float((got.audio - want.audio).abs().max()) <= 3e-3
        assert float((got.smeter_dbm - want.smeter_dbm).abs().max()) <= 0.1
    assert got.audio.device == card


def test_stage2_fft_matches_kernel_2(card):
    """The stage-2 FFT method (torch.fft) against kernel 2 at both plans."""
    from flydog_sdr_gps_tpu_torch.ops import channelizer as chz
    for rate in (12_000, 20_250):
        plan = make_ddc_plan(snd_rate=rate, audio_block=256)
        g = _gen(card, 7)
        kp = plan.k1 + plan.tail2
        y = torch.complex(torch.randn((kp, 300), generator=g, device=card),
                          torch.randn((kp, 300), generator=g, device=card))
        got = chz.stage2_fft(plan, y)
        want = kernels.stage2(y, plan.h2, plan.d2, plan.audio_block)
        assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.parametrize("notch", [True, False])
def test_lms_block_on_card_matches_plain(card, notch):
    """``lms_block`` launches kernel 5 once with one stage on, and equals
    its plain version within 1e-4 of the output's scale."""
    p = noise.LmsParams(notch=notch)
    g = _gen(card, 11)
    n, c = 512, 300
    t = torch.arange(n, device=card, dtype=torch.float32)[:, None]
    x = 0.3 * torch.sin(0.2 * t * torch.rand((1, c), generator=g,
                                             device=card)) \
        + 0.1 * torch.randn((n, c), generator=g, device=card)
    st = noise.init_lms(p, c, card)
    before = noise.lms_chain_block.launches
    y, s = noise.lms_block(p, x, st)
    assert noise.lms_chain_block.launches == before + 1
    yr, sr = noise.lms_block_plain(p, x, st)
    scale = float(yr.abs().max())
    assert float((y - yr).abs().max()) <= 1e-4 * scale
    assert float((s.weights - sr.weights).abs().max()) <= 1e-4
    assert float((s.line - sr.line).abs().max()) <= 1e-4 * scale


# -- the compiled step (CUDA graphs) ------------------------------------------

_GRAPH_TONES = [(7.1e6, 0.3, ("am", 1000.0, 0.6)), (14.2018e6, 0.15)]


def _graph_engine(card, use_graphs, c=64, block=256):
    from flydog_sdr_gps_tpu_torch.runtime import (DeviceSceneSource,
                                                  StreamEngine)
    params = rx.RxParams(num_channels=c, audio_block=block)
    src = DeviceSceneSource(tones=_GRAPH_TONES, noise_rms=1e-3,
                            block=params.ddc.adc_block, device=card, seed=9)
    eng = StreamEngine(params, src, device=card, use_graphs=use_graphs)
    eng.set_channel(0, freq_hz=7.1e6, mode=demod.MODE_AM)
    eng.set_channel(1, freq_hz=14.200e6, mode=demod.MODE_USB)
    return eng


# before block k: a SET that opens a gate, a retune, a reload
_GRAPH_EVENTS = {
    2: dict(ch=5, freq_hz=7.1003e6, mode=demod.MODE_SAS),
    3: dict(ch=6, freq_hz=14.2001e6, nr_notch_on=True, nr_den_on=True),
    4: dict(ch=7, freq_hz=7.0995e6, nr_on=True),
    5: dict(ch=8, nb_on=True, nb_wild=True),
    6: "retune_all",
    7: "load_state",
    8: dict(ch=5, mode=demod.MODE_USB),
}


def test_captured_step_equals_eager_on_card(card, tmp_path):
    """Two engines from one state and one source, one compiled (a graph
    per gate tuple) and one eager, through every gate, a retune and a
    reload: taps and state equal to the bit in every block."""
    from flydog_sdr_gps_tpu_torch.runtime.stream import _state_leaves
    eager, graphs = (_graph_engine(card, False), _graph_engine(card, True))
    assert graphs.compiled is not None and eager.compiled is None
    for blk in range(10):
        ev = _GRAPH_EVENTS.get(blk)
        for eng in (eager, graphs):
            if isinstance(ev, dict):
                kw = dict(ev)
                eng.set_channel(kw.pop("ch"), **kw)
            elif ev == "retune_all":
                eng.retune_all(eng.params.adc_clock * (1 + 4e-7))
            elif ev == "load_state":
                eager.save_state(str(tmp_path / "s.pkl"))
                eng.load_state(str(tmp_path / "s.pkl"))
        want, got = eager.run_block(), graphs.run_block()
        for f in dataclasses.fields(want):
            assert torch.equal(getattr(got, f.name), getattr(want, f.name)), \
                (blk, f.name)
        for i, (g, w) in enumerate(zip(_state_leaves(graphs.state),
                                       _state_leaves(eager.state))):
            assert torch.equal(g, w), (blk, i)
    keys = set(graphs.compiled.graphs)
    assert len(keys) >= 5 and all(k[0] == "block" for k in keys)


def test_launch_counters_credited_on_replay(card):
    """A replayed block counts each wrapper's launches as the eager block
    does; the capture itself counts none."""
    counted = (kernels.stage2_rot, agc.envelope_scan, demod.sam_pll,
               noise.lms_chain_block, noise.spectral_nr_gains)
    per_block = {}
    for use_graphs in (False, True):
        eng = _graph_engine(card, use_graphs)
        eng.set_channel(3, nr_notch_on=True, nr_on=True)
        for fn in counted:
            fn.launches = 0
        for _ in range(5):
            eng.run_block()
        torch.cuda.synchronize()
        per_block[use_graphs] = [fn.launches for fn in counted]
    assert per_block[True] == per_block[False] == [5] * len(counted)


def test_capture_from_a_second_thread_while_the_first_replays(card):
    """``prewarm_gather`` captures a new bucket's program on a thread
    while the first thread goes on serving blocks (replays); the new
    bucket's first block is a replay, and every served result equals the
    eager engine's to the bit."""
    import threading
    eager, graphs = (_graph_engine(card, False), _graph_engine(card, True))
    small = np.array([0, 1, 2, 3], np.int32)
    big = np.array([0, 1, 2, 3, 40, 41, 42, 63], np.int32)
    errors = []

    def prewarm():
        try:
            graphs.prewarm_gather(8)
        except Exception as e:              # noqa: BLE001 — reported below
            errors.append(e)
    warm = None
    for blk in range(8):
        idx = small if blk < 5 else big
        if blk == 1:
            warm = threading.Thread(target=prewarm)
            warm.start()
        if blk == 5:
            warm.join()
            assert not errors, errors
            key = ("gather", 8) + rx.gates(graphs.tuning)
            assert key in graphs.compiled.graphs   # captured off the loop
        got = graphs.fetch(graphs.run_block_gather(idx))
        want = eager.fetch(eager.run_block_gather(idx))
        np.testing.assert_array_equal(got, want, err_msg=f"block {blk}")
    assert len(graphs.compiled.graphs) == 2


def test_prewarm_on_a_cold_engine_warms_on_scratch_buffers(card):
    """``prewarm_gather`` before any block (the server's boot): the
    warm-up runs on scratch buffers (its launches counted apart), the
    live state is untouched, and the first served block is a replay
    equal to the eager engine's."""
    from flydog_sdr_gps_tpu_torch.runtime.stream import _state_leaves
    eager, graphs = (_graph_engine(card, False), _graph_engine(card, True))
    graphs.set_channel(3, nr_notch_on=True, nr_on=True)
    eager.set_channel(3, nr_notch_on=True, nr_on=True)
    before = [t.clone() for t in _state_leaves(graphs.state)]
    n = kernels.stage2_rot.launches
    graphs.prewarm_gather(4)
    torch.cuda.synchronize()
    step = graphs.compiled
    assert all(torch.equal(a, b)
               for a, b in zip(before, _state_leaves(graphs.state)))
    assert step.warmup_launches[kernels.stage2_rot] == 1
    assert step.warmup_launches[noise.lms_chain_block] == 1
    assert kernels.stage2_rot.launches == n + 1
    assert list(step.graphs) == [("gather", 4) + rx.gates(graphs.tuning)]
    idx = np.array([0, 1, 3, 9], np.int32)
    for _ in range(3):
        got = graphs.fetch(graphs.run_block_gather(idx))
        np.testing.assert_array_equal(
            got, eager.fetch(eager.run_block_gather(idx)))
    # the warm-up, three replays, and the eager engine's three blocks
    assert kernels.stage2_rot.launches == n + 1 + 3 + 3
    assert len(step.graphs) == 1


def test_a_failed_capture_raises_and_never_runs_eagerly(card):
    """A program whose capture fails (here: a host read of a device
    value, which a capture refuses) raises, and every later run of that
    key raises at once without running the body eagerly."""
    step = rx.jit_rx_block(rx.RxParams(num_channels=4, audio_block=128),
                           card)
    calls = []

    def body(tuning):
        calls.append(1)
        return float(step.state.smeter.sum())   # a sync: not capturable
    with pytest.raises(RuntimeError):
        step.run(("bad",), body)                # eager block, then capture
    assert len(calls) == 2
    with pytest.raises(RuntimeError, match="capture of"):
        step.run(("bad",), body)
    assert len(calls) == 2 and not step.graphs


# -- the other compiled programs (CUDA graphs) --------------------------------

def _leaves(obj) -> list:
    if obj is None:
        return []
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for x in obj for t in _leaves(x)]
    if not dataclasses.is_dataclass(obj):
        return []
    return [t for f in dataclasses.fields(obj)
            for t in _leaves(getattr(obj, f.name))]


def _all_equal(got, want) -> bool:
    a, b = _leaves(got), _leaves(want)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_captured_scene_source_equals_eager_on_card(card):
    """The scene source as a graph (carrier phases on the card, FSK
    segment tables through pinned buffers, the noise generator registered
    with the graph) against the eager source: every block to the bit."""
    from flydog_sdr_gps_tpu_torch.runtime import DeviceSceneSource
    tones = _GRAPH_TONES + [
        (518.0e3 + 1000.0, 0.05, ("fsk", 3, 170.0, [1, 0, 1, 1, 0], 7)),
        (10.1387e6, 0.1, ("fsk", 20, 1.4648, [0, 1, 2, 3], 6))]
    kw = dict(tones=tones, noise_rms=1e-3, block=64 * 10416, device=card,
              seed=4)
    # the compiled source first: its capture follows its eager first
    # block at once (a capture that overlapped that block corrupted it)
    for pair in range(4):
        graphs = DeviceSceneSource(**kw)
        eager = DeviceSceneSource(**kw, use_graphs=False)
        for blk in range(8 if pair == 0 else 2):
            got, want = graphs.next_block(), eager.next_block()
            assert torch.equal(got, want), (pair, blk)
            assert got is graphs.out
        assert list(graphs.graphs) == [("scene",)]


def test_captured_waterfall_equals_eager_on_card(card):
    """Four slots (one a two-block zoom) on the chains' stream, fed the
    engine's blocks with their ready events: rows equal to the eager
    arithmetic (``wf_ingest``/``wf_frame``) to the bit, through a mask
    change."""
    from flydog_sdr_gps_tpu_torch.models import waterfall as wf_model
    from flydog_sdr_gps_tpu_torch.server.wf_service import WfSubsystem
    eng = _graph_engine(card, True)
    wf = WfSubsystem(eng.params.adc_clock, 30.0e6, capacity=4, device=card)
    keys = [(0, 0, "cma"), (5, 3000, "max"), (9, 9000, "min")]
    block = eng.params.ddc.adc_block
    deep = next(z for z in range(15)
                if wf_model.make_wf_params(z).ingest_blocks(block) == 2)
    keys.append((deep, 20000, "cma"))
    slots = [wf.attach(*k) for k in keys]
    eager = []
    for s in slots:
        eager.append(dict(st=wf_model.init_state(s.params, card), acc=[],
                          tune=(s.tune[0].clone(), s.tune[1].clone())))
    for blk in range(6):
        if blk == 4:
            wf.set_masked([(s.cf - 1e3, s.cf + 1e3) for s in slots])
        eng.run_block()
        wf.ingest(eng._last_x, eng._x_ready)
        for s, e in zip(slots, eager):
            e["acc"].append(eng._last_x.clone())
            if len(e["acc"]) == s.params.ingest_blocks(block):
                e["st"] = wf_model.wf_ingest(s.params, e["st"],
                                             torch.cat(e["acc"]), *e["tune"])
                e["acc"] = []
        for s, e in zip(slots, eager):
            mask = wf._device_mask(s.cf, s.params.span)
            want = wf_model.wf_frame(s.params, e["st"], "hanning", s.interp,
                                     mask=mask).cpu().numpy()
            np.testing.assert_array_equal(wf.frame(s), want,
                                          err_msg=f"{s.key}, block {blk}")
    assert any(k[0] == "ingest" for k in wf.graphs)
    assert any(k[0] == "frame" for k in wf.graphs)


def test_waterfall_control_plane_beside_captures_on_card(card):
    """``attach``, ``detach`` and ``set_masked`` from a second thread
    while the first ingests and reads rows, each new zoom a capture on
    that thread: no capture fails, and a slot that stays attached all
    along gives the eager arithmetic's row to the bit once the second
    thread stops (a control-plane copy recorded into a graph would run
    again at every replay and part them)."""
    import threading

    from flydog_sdr_gps_tpu_torch.models import waterfall as wf_model
    from flydog_sdr_gps_tpu_torch.server.wf_service import WfSubsystem
    eng = _graph_engine(card, True)
    wf = WfSubsystem(eng.params.adc_clock, 30.0e6, capacity=4, device=card)
    keep = wf.attach(0, 0, "cma")
    assert keep.params.ingest_blocks(eng.params.ddc.adc_block) == 1
    twin = dict(st=wf_model.init_state(keep.params, card),
                tune=(keep.tune[0].clone(), keep.tune[1].clone()))
    stop, errors = threading.Event(), []

    def control():
        try:
            z = 1
            while not stop.is_set():
                s = wf.attach(z, 1000 * z, ("max", "min", "cma")[z % 3])
                wf.set_masked([(9.9e6 + z * 1e3, 9.95e6 + z * 1e3)])
                stop.wait(0.002)
                wf.detach(s)
                z = z % 12 + 1
        except Exception as e:              # noqa: BLE001 — reported below
            errors.append(e)

    other = threading.Thread(target=control)
    other.start()
    try:
        for _ in range(24):
            eng.run_block()
            wf.ingest(eng._last_x, eng._x_ready)
            twin["st"] = wf_model.wf_ingest(keep.params, twin["st"],
                                            eng._last_x.clone(),
                                            *twin["tune"])
            for s in list(wf.slots.values()):
                assert np.isfinite(wf.frame(s)).all()
    finally:
        stop.set()
        other.join()
    assert not errors, errors
    assert not wf._graphs._failed
    assert sum(k[0] == "ingest" for k in wf.graphs) > 2
    wf.set_masked([])
    for _ in range(2):
        eng.run_block()
        wf.ingest(eng._last_x, eng._x_ready)
        twin["st"] = wf_model.wf_ingest(keep.params, twin["st"],
                                        eng._last_x.clone(), *twin["tune"])
    want = wf_model.wf_frame(keep.params, twin["st"], "hanning",
                             "cma").cpu().numpy()
    np.testing.assert_array_equal(wf.frame(keep), want)


def test_captured_gps_sky_and_tracking_equal_eager_on_card(card):
    """The sky (noise 0 and noise at the same generator state) and the
    tracking step with its pack, captured, against eager twins: every
    chunk, every channel's chips and prompts, the state, to the bit."""
    from flydog_sdr_gps_tpu_torch.models.gps import manager, scene
    rx_ = scene.ecef_from_lla(47.37, 8.54, 450.0)
    t0 = 345600.0 + 3.0
    ephs = scene.visible_constellation(rx_, t0, n_sats=6)
    for noise_ in (0.0, 0.9):
        skies = [scene.GpsScene(rx_, ephs, t0, duration=30.0, noise=noise_,
                                clock_ppm=0.4, amplitude=0.5, device=card,
                                use_graphs=g) for g in (False, True)]
        mgrs = [manager.GpsManager(prns=tuple(ephs), max_chans=6, device=card,
                                   use_graphs=g) for g in (False, True)]
        for chunk in range(6):
            xs = [s.next_block(16368 * 100) for s in skies]
            assert torch.equal(xs[1], xs[0]), (noise_, chunk)
            for m, x in zip(mgrs, xs):
                m.process(x, search=chunk == 0)
            assert set(mgrs[1].channels) == set(mgrs[0].channels)
            for prn, ch in mgrs[1].channels.items():
                assert ch.chips == mgrs[0].channels[prn].chips
            assert _all_equal(mgrs[1]._track_state, mgrs[0]._track_state)
        assert mgrs[1].channels and skies[1].graphs


def test_captured_mesh_step_equals_eager_on_card(card):
    """The mesh step on a (2, 2) mesh of the card as one graph, against
    the eager mesh step through a SET and a retune: taps and state to the
    bit, kernel 2 credited four times a block."""
    from flydog_sdr_gps_tpu_torch import parallel
    from flydog_sdr_gps_tpu_torch.runtime import (DeviceSceneSource,
                                                  ShardedStreamEngine)

    def engine(use_graphs):
        params = rx.RxParams(num_channels=64, audio_block=256)
        src = DeviceSceneSource(tones=_GRAPH_TONES, noise_rms=3e-4,
                                block=params.ddc.adc_block, device=card)
        eng = ShardedStreamEngine(params, src, use_graphs=use_graphs,
                                  mesh=parallel.make_mesh(
                                      2, 2, devices=[card] * 4))
        eng.set_channel(0, freq_hz=7.100e6, mode=demod.MODE_AM)
        return eng
    eager, graphs = engine(False), engine(True)
    assert graphs.program is not None and graphs.program.whole
    for blk in range(6):
        for e in (eager, graphs):
            if blk == 2:
                e.set_channel(33, freq_hz=14.200e6, mode=demod.MODE_USB,
                              nr_notch_on=True)
            if blk == 4:
                e.retune_all(e.params.adc_clock * (1 + 4e-7))
        n2 = kernels.stage2.launches
        got = graphs.run_block()
        assert kernels.stage2.launches == n2 + 4
        want = eager.run_block()
        assert _all_equal(got, want), blk
        assert _all_equal(graphs.state, eager.state), blk
    assert len(graphs.program._graphs[card].graphs) == 2


def test_staged_blocks_reach_the_card_whole(card):
    """A threaded host source feeding an engine on the card is staged
    (``BlockStage``: two pinned and two device buffers in turns).  Over
    48 served blocks, with a slow step (a spin kernel after it) and the
    waterfall ingesting ``_last_x`` after ``_x_ready``, the block the
    step's stream saw is its host block to the bit, its ticks are
    sample-exact, and the waterfall's rows equal those of a waterfall fed
    plain uploads of the same blocks: no buffer is reused before its
    events."""
    from flydog_sdr_gps_tpu_torch.runtime import StreamEngine, ThreadedSource
    from flydog_sdr_gps_tpu_torch.server.wf_service import WfSubsystem
    params = rx.RxParams(num_channels=64, audio_block=256)
    n = params.ddc.adc_block

    class Replay:
        """Distinct blocks, each from its own seed."""
        adc_clock = params.adc_clock

        def __init__(self):
            self.k = 0

        @staticmethod
        def block(k):
            return 0.1 * np.random.default_rng(k).standard_normal(
                n, dtype=np.float32)

        def next_block(self, _n):
            self.k += 1
            return self.block(self.k - 1)

    src = ThreadedSource(Replay(), block=n, nblocks=8)
    eng = StreamEngine(params, src, device=card)
    eng.set_channel(0, freq_hz=7.1e6, mode=demod.MODE_AM)
    keys = [(0, 0, "cma"), (5, 3000, "max")]
    wf = WfSubsystem(params.adc_clock, 30.0e6, capacity=2, device=card)
    twin = WfSubsystem(params.adc_clock, 30.0e6, capacity=2, device=card)
    slots = [wf.attach(*k) for k in keys]
    twins = [twin.attach(*k) for k in keys]
    idx = np.array([0, 1, 2, 3])
    seen = []
    try:
        assert eng._stage is not None
        for k in range(48):
            eng.run_block_gather(idx)
            torch.cuda._sleep(20_000_000)   # ~10 ms: the stage runs ahead
            seen.append(eng._last_x.clone())
            wf.ingest(eng._last_x, eng._x_ready)
            twin.ingest(torch.from_numpy(Replay.block(k)).to(card))
            assert eng.block_ticks == k * n and eng.seq == k + 1
            for s, t in zip(slots, twins):
                np.testing.assert_array_equal(wf.frame(s), twin.frame(t),
                                              err_msg=f"{s.key}, block {k}")
        assert eng._stage._thread.is_alive()
        for k, x in enumerate(seen):
            assert x.cpu().numpy().tobytes() == Replay.block(k).tobytes(), k
    finally:
        src.close()
    assert not eng._stage._thread.is_alive()


def test_retune_bank_built_on_card_equals_host_build(card):
    """A full retune's stage-1 bank built on the card, (2016, 4096),
    against the host's build of the same words: ``dphi1`` equal, every
    entry within one float32 ulp (the two float64 cos/sin may differ in
    their last bit)."""
    from flydog_sdr_gps_tpu_torch.ops import channelizer as chz
    from flydog_sdr_gps_tpu_torch.ops import nco
    plan = make_ddc_plan()
    rng = np.random.default_rng(5)
    freqs = np.concatenate([[7.1e6, 14.2018e6, 10e6, 0.0, 62.5e6],
                            rng.uniform(0.0, 30e6, 4091)])
    words = nco.freqs_to_fcws(freqs, plan.adc_clock * (1 + 4e-7))
    bank, dphi = chz.build_filterbank(plan, [int(w) for w in words])
    got, got_dphi = chz.build_filterbank_device(plan, words, card)
    assert got.shape == (2016, 4096) and got.dtype == torch.complex64
    np.testing.assert_array_equal(got_dphi.cpu().numpy(), dphi)
    g = got.cpu().numpy()
    for plane in (np.real, np.imag):
        a, b = plane(g), plane(bank)
        big = np.maximum(np.abs(a), np.abs(b)).astype(np.float32)
        ulp = np.abs(a.astype(np.float64) - b) / np.spacing(big)
        assert ulp.max() <= 1.0, ulp.max()
        print(f"{plane.__name__}: {np.sum(a != b)} of {a.size} entries "
              "one ulp off")


class _DeviceBlock:
    """A source of one fixed block on the card."""

    def __init__(self, x):
        self.x = x

    def next_block(self, n):
        return self.x


def _live_engine(card, c=4096):
    from flydog_sdr_gps_tpu_torch.runtime import StreamEngine
    params = rx.RxParams(num_channels=c, audio_block=2048)
    gen = torch.Generator(device=card).manual_seed(11)
    x = 0.1 * torch.randn(params.ddc.adc_block, generator=gen, device=card)
    eng = StreamEngine(params, _DeviceBlock(x), device=card)
    for ch in range(0, c, 97):
        eng.set_channel(ch, freq_hz=1e6 + 7.3e3 * ch, mode=demod.MODE_USB)
    return eng


def _serve_beside(eng, change, blocks, idx, gap):
    """``blocks`` served blocks on a thread, ``change(i)`` on this one
    every ``gap`` s; returns what each change saw of the block count,
    (entered, returned)."""
    import threading
    import time
    done = threading.Event()
    err = []

    def serve():
        try:
            for _ in range(blocks):       # paced as the server's loop is
                eng.fetch(eng.run_block_gather(idx))
        except BaseException as e:      # noqa: BLE001 — raised below
            err.append(e)
        finally:
            done.set()
    th = threading.Thread(target=serve)
    th.start()
    seqs, i = [], 0
    while not done.is_set():
        a = eng.seq
        change(i)
        seqs.append((a, eng.seq))
        i += 1
        time.sleep(gap)
    th.join(timeout=120)
    assert not th.is_alive() and not err, err
    return seqs


def test_retune_during_live_replays_is_read_whole(card):
    """The compiled step at C=4096 serving blocks on a thread while
    ``retune_all`` runs on another, twice over.  A stand-in replay that
    reads the bank, spins the card, then reads the words, all on its
    stream, sees an old or a new pair whole each time.  The real replays:
    each retune returns within a few ms of host time, the last one's bank
    and words are the step's, and every channel's rotator word after the
    run is what blocks read under the old words up to some block in each
    retune's span of blocks and under the new ones after it."""
    import itertools
    import time
    from flydog_sdr_gps_tpu_torch.ops import channelizer as chz
    from flydog_sdr_gps_tpu_torch.ops import nco
    eng = _live_engine(card)
    idx = np.arange(0, 4096, 97)
    clocks = [eng.params.adc_clock * (1 + s * 1e-6) for s in (0.4, -0.3)]
    eng.run_block_gather(idx)               # the first run and capture
    eng.run_block_gather(idx)
    torch.cuda.synchronize()

    # the stand-in: reads on the step's stream with the card spinning
    cols = torch.as_tensor(idx, device=card)
    t = eng.tuning
    pairs = [(t.bank[:, cols].clone(), t.dphi1[cols].clone())]
    for clk in clocks:
        words = nco.freqs_to_fcws([c.freq_hz for c in eng.ctl], clk)
        b, d = chz.build_filterbank_device(eng.params.ddc, words, card)
        pairs.append((b[:, cols], d[cols]))
    seen = []
    real_run = eng.compiled.run

    def replay(program, fn):
        tt = eng.compiled.tuning
        bank = tt.bank[:, cols].clone()
        torch.cuda._sleep(4_000_000)        # ~2 ms with the pair half read
        seen.append((bank, tt.dphi1[cols].clone()))
    eng.compiled.run = replay
    _serve_beside(eng, lambda i: eng.retune_all(clocks[i % 2]), 200, idx,
                  0.02)
    torch.cuda.synchronize()
    got = []
    for bank, dphi in seen:
        k = next((k for k, (b, d) in enumerate(pairs)
                  if torch.equal(d, dphi) and torch.equal(b, bank)), -1)
        got.append(k)
    assert -1 not in got, got
    assert {1, 2} <= set(got), set(got)

    # the real replays
    eng.compiled.run = real_run
    phi0, n0 = eng.state.ddc.phi1.clone(), eng.seq
    dphi0 = eng.tuning.dphi1.clone()
    host_ms = []

    def retune(i):
        t0 = time.monotonic()
        eng.retune_all(clocks[i % 2])
        host_ms.append((time.monotonic() - t0) * 1e3)
    seqs = _serve_beside(eng, retune, 24, idx, 0.15)
    torch.cuda.synchronize()
    last = clocks[(len(seqs) - 1) % 2]
    words = nco.freqs_to_fcws([c.freq_hz for c in eng.ctl], last)
    b, d = chz.build_filterbank_device(eng.params.ddc, words, card)
    assert torch.equal(eng.tuning.bank, b) and torch.equal(
        eng.tuning.dphi1, d)
    print(f"{len(seqs)} retunes beside 24 blocks, host ms "
          f"{sorted(round(v, 2) for v in host_ms)}")
    assert len(seqs) >= 3 and max(host_ms) < 50.0, host_ms
    k1 = eng.params.ddc.k1
    dphis = [dphi0] + [chz.build_filterbank_device(
        eng.params.ddc, nco.freqs_to_fcws([c.freq_hz for c in eng.ctl],
                                          clocks[i % 2]), card)[1]
        for i in range(len(seqs))]
    want = eng.state.ddc.phi1
    n1 = eng.seq
    spans = [range(max(a, n0), min(b, n1) + 1) for a, b in seqs]
    for splits in itertools.product(*spans):
        if list(splits) != sorted(splits):
            continue
        phi = phi0.clone()
        for n in range(n0, n1):
            r = sum(1 for s in splits if s <= n)    # retunes it read
            phi = nco.advance(phi, dphis[r], k1)
        if torch.equal(phi, want):
            return
    raise AssertionError(f"no ordered placement explains the words: {seqs}")
