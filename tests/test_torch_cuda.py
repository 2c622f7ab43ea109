"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips unless PyTorch sees an NVIDIA card.  On
the card's machine (which has no jax, so without this repo's conftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances as in the CPU parity tests: the unfused stage 2 within atol
1e-4 on unit-variance input, the fused one within 2e-4*max|ref|, the
AGC and SAM loops within 1e-4*max|ref|; the two stage-2 branches of
``rx_block`` within 2e-4*max|audio| + 5e-5.
"""

import numpy as np
import pytest
import torch

from flydog_sdr_gps_tpu_torch.models import rx_channel as rx
from flydog_sdr_gps_tpu_torch.ops import agc, demod, kernels
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
