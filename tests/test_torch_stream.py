"""Port parity: the streaming runtime (sources, ``StreamEngine``) against
the JAX reference on CPU, the port's freedom from jax, and its dispatch
rule (a kernel or an error, never a silent fallback).

Tolerances: the device scene within 2e-6 of the reference's (float32
cos of the same exact phase), and each within 1e-6 of the scene in
float64; engine audio of the listened lanes within 2e-4*max|audio| +
5e-5 per block, as for ``rx_block``, from the block on where the
passband FIR has filled (see `test_torch_rx.py` for why the fill
transient is not compared); lanes left empty within 1 % in rms (see
``_check_empty_lanes``).  The retune runs on each stage-2 branch.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flydog_sdr_gps_tpu.models import rx_channel as jrx
from flydog_sdr_gps_tpu.numerology import ADC_CLOCK_NOM
from flydog_sdr_gps_tpu.ops import demod
from flydog_sdr_gps_tpu.ops import nco as jnco
from flydog_sdr_gps_tpu.runtime import source as jsource
from flydog_sdr_gps_tpu.runtime import stream as jstream
from flydog_sdr_gps_tpu_torch import _build
from flydog_sdr_gps_tpu_torch.models import rx_channel as trx
from flydog_sdr_gps_tpu_torch.ops import agc, demod as tdemod, kernels
from flydog_sdr_gps_tpu_torch.runtime import source as tsource
from flydog_sdr_gps_tpu_torch.runtime import stream as tstream

REPO = Path(__file__).resolve().parents[1]
TONES = ((14.201e6, 0.5), (21.0015e6, 0.5))


def _scene_truth(tones, start, n):
    """The scene in float64 from exact 48-bit phases (uint64 products
    wrap mod 2**64, which 2**48 divides)."""
    k = np.arange(start, start + n, dtype=np.uint64)

    def cycles(f):
        w = np.uint64(jnco.freq_to_fcw(f, ADC_CLOCK_NOM))
        return ((k * w) & np.uint64((1 << 48) - 1)).astype(np.float64) \
            / 2.0 ** 48
    x = np.zeros(n)
    for f, amp, *mod in tones:
        carrier = np.cos(2 * np.pi * cycles(f))
        if mod:
            _, mf, depth = mod[0]
            carrier *= 1 + depth * np.sin(2 * np.pi * cycles(mf))
        x += amp * carrier
    return x


def test_device_scene_matches_reference():
    tones = [(7.1e6, 0.3, ("am", 1000.0, 0.6)), (14.2018e6, 0.15),
             (10.0e6, 0.2)]
    block = 8 * 10416
    ref = jsource.DeviceSceneSource(tones=tones, block=block)
    got = tsource.DeviceSceneSource(tones=tones, block=block, device="cpu")
    for blk in range(3):
        r = np.asarray(ref.next_block())
        g = got.next_block().numpy()
        truth = _scene_truth(tones, blk * block, block)
        # each side against the exact scene first, so a failure names
        # the side that drifted (both sit within ~4e-7 of it)
        np.testing.assert_allclose(r, truth, rtol=0, atol=1e-6,
                                   err_msg=f"reference, block {blk}")
        np.testing.assert_allclose(g, truth, rtol=0, atol=1e-6,
                                   err_msg=f"port, block {blk}")
        np.testing.assert_allclose(g, r, rtol=0, atol=2e-6,
                                   err_msg=f"block {blk}")
    assert got.ticks == ref.ticks == 3 * block
    noisy = tsource.DeviceSceneSource(noise_rms=0.1, block=block,
                                      device="cpu", seed=3)
    x = noisy.next_block()
    assert abs(float(x.std()) - 0.1) < 0.002
    again = tsource.DeviceSceneSource(noise_rms=0.1, block=block,
                                      device="cpu", seed=3)
    assert torch.equal(again.next_block(), x)          # seeded


def test_synthetic_source_matches_reference():
    a = jsource.SyntheticSource(tones=TONES, noise_rms=0.01, seed=4)
    b = tsource.SyntheticSource(tones=TONES, noise_rms=0.01, seed=4)
    for _ in range(2):
        np.testing.assert_array_equal(b.next_block(5000),
                                      a.next_block(5000))
    assert a.ticks == b.ticks == 10000


# Each port branch beside the reference branch that computes the same
# thing: at a retune the two differ for one stage-2 span (the fused tail
# is unrotated and so is rotated with the NEW tuning word).  The
# reference's fused Pallas path (interpret mode on CPU) needs C % 64.
BRANCHES = {"unfused": ("poly", 2), "fused": ("pallas_rot", 64)}


def _engines(branch="unfused"):
    jax_stage2, channels = BRANCHES[branch]
    kw = dict(num_channels=channels, audio_block=128)
    ref = jstream.StreamEngine(jrx.RxParams(stage2=jax_stage2, **kw),
                               jsource.SyntheticSource(TONES, 0.001))
    port = tstream.StreamEngine(trx.RxParams(stage2=branch, **kw),
                                tsource.SyntheticSource(TONES, 0.001),
                                device="cpu")
    assert jrx._use_fused_stage2(ref.params) == (branch == "fused")
    for eng in (ref, port):
        eng.set_channel(0, freq_hz=14.200e6, mode=demod.MODE_USB,
                        in_use=True)
        eng.set_channel(1, freq_hz=21.003e6, mode=demod.MODE_LSB,
                        in_use=True)
    return ref, port


def test_engine_retune_mid_stream_matches_reference():
    _retune_mid_stream("unfused")


def test_engine_retune_mid_stream_fused_matches_reference():
    """The default branch: the unrotated y_tail is rotated with the new
    tuning word at the retune, as the reference's fused path does."""
    _retune_mid_stream("fused")


def _retune_mid_stream(branch):
    ref, port = _engines(branch)
    rows = []
    port.subscribers.append(lambda e, taps: rows.append(taps.audio.numpy()))
    filled, retune, nblocks = 8, 10, 16
    for blk in range(nblocks):
        if blk == retune:
            for eng in (ref, port):
                eng.set_channel(0, freq_hz=21.000e6)
        r = np.asarray(ref.run_block().audio)
        port.run_block()
        g = rows[-1]
        tol = 2e-4 * max(np.abs(r[:, :2]).max(), 1e-6) + 5e-5
        if blk >= filled:
            np.testing.assert_allclose(g[:, :2], r[:, :2], rtol=0, atol=tol,
                                       err_msg=f"block {blk}")
            if g.shape[1] > 2:
                _check_empty_lanes(g[:, 2:], r[:, 2:], f"block {blk}")
    assert port.seq == ref.seq == nblocks
    assert port.block_ticks == ref.block_ticks == \
        (nblocks - 1) * port.params.ddc.adc_block
    assert port.tuning.dphi1.tolist() == [
        int(w) for w in jnco.from_limbs(np.asarray(ref.tuning.dphi1))]
    # after the retune, ch0 (USB at 21.000 MHz) hears the 1500 Hz offset
    audio = np.concatenate(rows[retune:])[256:, 0]
    spec = np.abs(np.fft.rfft(audio * np.hanning(len(audio))))
    f = np.fft.rfftfreq(len(audio), 1.0 / port.params.fs_out)
    assert abs(f[np.argmax(spec)] - 1500.0) < 40


def _check_empty_lanes(got, want, msg):
    """Lanes left at the default tuning carry only the 1e-3 rms ADC
    noise, ~80 dB below the tones; the AGC lifts them by up to 84 dB, so
    float32 stage-1 sums in another order than XLA's (a ~1e-7 share of
    full scale) reach ~4e-4 there — the reference's own rounding, not the
    port's (`test_torch_rx.py` says more).  The listened lanes carry the
    sample-level bound; these are held to their level, within 1 %."""
    rms_g, rms_w = np.sqrt((got ** 2).mean(0)), np.sqrt((want ** 2).mean(0))
    np.testing.assert_allclose(rms_g, rms_w, rtol=1e-2, err_msg=msg)


def test_engine_gates_follow_set_channel():
    _, port = _engines()
    assert not port.tuning.any_sideband and not port.tuning.any_lms
    port.set_channel(1, mode=tdemod.MODE_SAS, nr_den_on=True)
    assert port.tuning.any_sideband and port.tuning.any_lms
    assert not port.tuning.any_nb_wild and not port.tuning.any_spectral_nr
    port.set_channel(0, nb_on=True, nb_wild=True, nr_on=True)
    assert port.tuning.any_nb_wild and port.tuning.any_spectral_nr
    port.retune_all(port.params.adc_clock * (1 + 1e-6))
    assert port.tuning.any_nb_wild               # gates survive a retune


def test_port_imports_no_jax():
    """Import the port with `import jax` made to fail, run one block."""
    script = textwrap.dedent("""
        import sys

        class NoJax:
            def find_spec(self, name, path=None, target=None):
                if name == "jax" or name.startswith(("jax.", "jaxlib")):
                    raise ImportError("jax is blocked in this test")

        sys.meta_path.insert(0, NoJax())
        import torch
        from flydog_sdr_gps_tpu_torch import convert  # noqa: F401
        from flydog_sdr_gps_tpu_torch.models import rx_channel as rx
        from flydog_sdr_gps_tpu_torch.runtime import (DeviceSceneSource,
                                                      StreamEngine)
        params = rx.RxParams(num_channels=4, audio_block=64)
        src = DeviceSceneSource(tones=[(7.1e6, 0.3)], noise_rms=1e-3,
                                block=params.ddc.adc_block, device="cpu")
        eng = StreamEngine(params, src, device="cpu")
        eng.set_channel(0, freq_hz=7.0995e6)
        taps = eng.run_block()
        assert taps.audio.shape == (64, 4)
        assert bool(torch.isfinite(taps.audio).all())
        assert not any(m.split(".")[0] in ("jax", "jaxlib")
                       for m in sys.modules)
        print("NO-JAX-OK")
    """)
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "NO-JAX-OK" in res.stdout


def test_wrappers_raise_off_cpu_instead_of_falling_back():
    """A tensor that is neither on the CPU nor on a card gets an error,
    not the plain version (and no launch is counted)."""
    meta = dict(device="meta")
    y = torch.empty(((4 + 24) * 4, 8), dtype=torch.complex64, **meta)
    h2 = np.ones(100)
    w = torch.zeros(8, dtype=torch.int64, **meta)
    before = (kernels.stage2.launches, kernels.stage2_rot.launches,
              agc.envelope_scan.launches, tdemod.sam_pll.launches)
    with pytest.raises(RuntimeError, match="no kernel"):
        kernels.stage2(y, h2, 4, 4)
    with pytest.raises(RuntimeError, match="no kernel"):
        kernels.stage2_rot(y, w, w, h2, 4, 4)
    with pytest.raises(RuntimeError, match="no kernel"):
        agc.envelope_scan(agc.AgcParams(), torch.empty((4, 8), **meta),
                          torch.empty(8, **meta), torch.empty(8, **meta))
    with pytest.raises(RuntimeError, match="no kernel"):
        tdemod.sam_pll(tdemod.SamParams(),
                       torch.empty((4, 8), dtype=torch.complex64, **meta),
                       torch.empty(8, **meta), torch.empty(8, **meta))
    assert before == (kernels.stage2.launches, kernels.stage2_rot.launches,
                      agc.envelope_scan.launches, tdemod.sam_pll.launches)


def test_kernel_library_path_is_keyed_and_ignored():
    path = _build.library_path()
    assert path.parent.name == _build.source_hash()
    assert path.is_relative_to(REPO / "build")          # .gitignore: build/
    assert {p.name for p in _build._sources()} >= {"stage2.cu", "scans.cu"}
