#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA card.

    python3 chip_smoke.py              # from the root of a checkout
    python3 chip_smoke.py --profile    # also a torch.profiler breakdown

What it does, in order (any failed check raises; exit code != 0):

0. Prints torch/CUDA versions, ``nvcc --version`` and the card's name and
   power limit, then builds the CUDA kernels from ``flydog_sdr_gps_tpu_
   torch/csrc`` (plain nvcc, at first use) and prints the build time.
1. Each kernel against its plain PyTorch version on the card: the fused
   rotator + stage 2 (kernel 1) and the unfused stage 2 (kernel 2) at the
   main-path shape (C=4096, audio_block=2048, 12 kHz plan), at the
   20.25 kHz plan (d2=4) and at C=13, C=14 and C=100; the AGC envelope
   (kernel 3) and the SAM PLL (kernel 4) at (2048, 4096), the PLL's
   input with lanes that are all zero, turn to zero, hold one NaN, one
   infinity, or sit at the +-fmax clamp.  Times both, and for kernel 2
   one library call (``conv1d``) that computes the same function.  Each
   kernel's time is held against its bound: the larger of its bytes
   (every input and output once) over 3.35 TB/s and its operations over
   67 TFLOP/s (the H100 SXM's published float32 peak).
2. DDC fidelity: a noise-free full-scale tone through ``ddc_block`` —
   right frequency, amplitude ~1.0, SINAD >= 80 dB (a stage-1 matmul
   that quietly ran in TF32 would fail this).
3. The slice: ``StreamEngine`` at C=4096, audio_block=2048, fed by a
   ``DeviceSceneSource`` (AM 7.100 MHz with 1 kHz, a tone at 14.2018
   MHz, a carrier at 10.000 MHz, noise 3e-4 rms): an AM channel must hear
   1000 Hz, a USB channel 1800 Hz, empty channels stay quiet, S-meters
   plausible, every tap finite; 8 fused blocks and 2 unfused blocks,
   with every kernel's launch counter shown to rise in that run.

The line before the last is a JSON object with each kernel's launches,
error against its plain version, times and bound; the last line is
``{"ok": true, "device": {...}}``.  The script imports no jax.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
PKG = "flydog_sdr_gps_tpu_torch"

SCENE = [(7.100e6, 0.30, ("am", 1000.0, 0.6)), (14.2018e6, 0.15),
         (10.000e6, 0.20)]
EMPTY_FREQS = (5.5e6, 12.3e6, 18.1e6, 25.7e6)
# empty lanes: 3e-4 rms ADC noise is ~3e-6 rms in a 2.4 kHz analytic USB
# lane; the AGC lifts it by at most 84 dB (x15849) to ~0.05 rms.  A lane
# that caught a carrier sits at the AGC target (0.5 peak, ~0.35 rms).
EMPTY_RMS_MAX = 0.15
# published peaks of one H100 SXM: device memory and float32 outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
KERNEL_SOURCES = {
    "stage2_rot": ("csrc/stage2.cu",
                   "flydog_sdr_gps_tpu/ops/pallas_kernels.py:178"),
    "stage2": ("csrc/stage2.cu",
               "flydog_sdr_gps_tpu/ops/pallas_kernels.py:48"),
    "agc_envelope": ("csrc/scans.cu", "flydog_sdr_gps_tpu/ops/agc.py:90"),
    "sam_pll": ("csrc/scans.cu", "flydog_sdr_gps_tpu/ops/demod.py:195"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def run(cmd: list[str]) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed: {res.stderr.strip()}")
    return res.stdout.strip()


class Timer:
    """Milliseconds per call: CUDA events around ``reps`` calls."""

    def __init__(self, torch):
        self.torch = torch

    def __call__(self, fn, reps: int = 5, warmup: int = 1) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps


def max_err(got, ref) -> tuple[float, float]:
    """(max |got - ref|, max |ref|) on the device, as Python floats."""
    return (float((got - ref).abs().max()), float(ref.abs().max()))


def max_err_finite(torch, got, ref, what: str) -> tuple[float, float]:
    """:func:`max_err` over the elements where ``ref`` is finite; where
    it is not, ``got`` must hold the same NaN or infinity."""
    fin = torch.isfinite(ref)
    a = torch.view_as_real(got) if got.is_complex() else got
    b = torch.view_as_real(ref) if ref.is_complex() else ref
    mask = fin[..., None] if got.is_complex() else fin
    check(bool(torch.allclose(torch.where(mask, 0.0, a),
                              torch.where(mask, 0.0, b), rtol=0.0, atol=0.0,
                              equal_nan=True)),
          f"{what}: non-finite elements differ from the plain version")
    zero = torch.zeros((), dtype=ref.dtype, device=ref.device)
    return max_err(torch.where(fin, got, zero), torch.where(fin, ref, zero))


def roofline(nbytes: float, flops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the float32 peak, whichever is larger."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_F32_FLOPS * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bound_bytes_ms=by_bytes, bound_ops_ms=by_ops,
                bytes=nbytes, flops=flops)


def conv1d_library_ms(torch, timer, y, h2, d2: int, k2: int, ref) -> dict:
    """Time one PyTorch call for kernel 2's function: ``conv1d`` with
    stride d2 over the 2C real planes laid out (2C, 1, Kp), TF32 off.
    The layout change before and after is not timed.  If cuDNN refuses
    the shape, ``matmul`` of the taps with a window view is timed."""
    import torch.nn.functional as F
    c = y.shape[1]
    w = torch.as_tensor(np.asarray(h2, np.float32), device=y.device)
    planes = torch.view_as_real(y).permute(1, 2, 0).reshape(2 * c, 1, -1)
    planes = planes.contiguous()
    try:
        fn = lambda: F.conv1d(planes, w[None, None], stride=d2)
        got = fn().reshape(c, 2, k2).permute(2, 0, 1).contiguous()
        call = "conv1d"
    except RuntimeError as exc:
        log(f"  conv1d refused the shape ({str(exc).splitlines()[0]}); "
            "timing matmul over a window view")
        del planes
        flat = torch.view_as_real(y).reshape(-1, 2 * c)
        win = flat.as_strided((k2, len(h2), 2 * c),
                              (d2 * 2 * c, 2 * c, 1))
        fn = lambda: torch.matmul(w[None], win)
        got = fn().reshape(k2, c, 2)
        call = "matmul"
    err = float((torch.view_as_complex(got) - ref).abs().max())
    log(f"  library call for stage2: {call}, max|err| {err:.3e} vs plain "
        "(bound 1.000e-04)")
    check(err <= 1e-4, f"library {call} vs stage2_plain: {err}")
    return dict(library_ms=timer(fn, reps=5), library_call=call)


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------

def phase_kernels(torch, device, timer, c_main: int, block: int,
                  small_cs=(13, 14, 100)) -> dict:
    from flydog_sdr_gps_tpu_torch.ops import agc, demod, kernels
    from flydog_sdr_gps_tpu_torch.ops.channelizer import make_ddc_plan

    gen = torch.Generator(device=device)
    gen.manual_seed(1234)
    out = {}

    def stage2_case(plan, c, name, main):
        kp, k2 = plan.k1 + plan.tail2, plan.audio_block
        y = torch.complex(
            torch.randn((kp, c), generator=gen, device=device),
            torch.randn((kp, c), generator=gen, device=device))
        words = torch.randint(0, 1 << 48, (2, c), generator=gen,
                              device=device, dtype=torch.int64)
        phi0, dphi = words[0], words[1]
        h2, d2 = plan.h2, plan.d2
        cases = (
            ("stage2_rot",
             lambda: kernels.stage2_rot(y, phi0, dphi, h2, d2, k2),
             lambda: kernels.stage2_rot_plain(y, phi0, dphi, h2, d2, k2),
             2e-4, True),
            ("stage2",
             lambda: kernels.stage2(y, h2, d2, k2),
             lambda: kernels.stage2_plain(y, h2, d2, k2),
             1e-4, False),
        )
        for kname, fn, plain, tol, relative in cases:
            got, ref = fn(), plain()
            err, scale = max_err(got, ref)
            bound = tol * scale if relative else tol
            log(f"  {kname:<10} {name:<26} max|err| {err:.3e} "
                f"(bound {bound:.3e})")
            check(err <= bound, f"{kname} {name}: {err} > {bound}")
            if main:
                # y, the taps and (kernel 1) the phase words in, out out;
                # 2 FMAs a tap and output, 6 operations a rotated sample
                nbytes = y.numel() * 8 + len(h2) * 4 + k2 * c * 8
                flops = 4.0 * len(h2) * k2 * c
                if kname == "stage2_rot":
                    nbytes += 2 * c * 8
                    flops += 6.0 * y.numel()
                out[kname] = dict(max_abs_err=err, ms=timer(fn, reps=10),
                                  plain_ms=timer(plain, reps=2),
                                  library_ms=None, **roofline(nbytes, flops))
                if kname == "stage2":
                    out[kname].update(conv1d_library_ms(
                        torch, timer, y, h2, d2, k2, ref))
            del got, ref
        del y

    plan12 = make_ddc_plan(audio_block=block)
    plan20 = make_ddc_plan(snd_rate=20_250, audio_block=block)
    stage2_case(plan12, c_main, f"12k C={c_main}", True)
    stage2_case(plan20, c_main, f"20.25k C={c_main}", False)
    for c in small_cs:
        stage2_case(plan12, c, f"12k C={c}", False)

    # kernel 3: AGC envelope on a realistic spread of levels
    params = agc.AgcParams(fs=plan12.fs_out)
    lvl = torch.empty((1, c_main), device=device).uniform_(
        -140.0, 0.0, generator=gen)
    mag_db = lvl + 6.0 * torch.randn((block, c_main), generator=gen,
                                     device=device)
    env0 = torch.full((c_main,), -160.0, device=device)
    hang0 = torch.zeros(c_main, dtype=torch.int32, device=device)
    fn = lambda: agc.envelope_scan(params, mag_db, env0, hang0)
    plain = lambda: agc.envelope_scan_plain(params, mag_db, env0, hang0)
    (g_seq, g_env, g_hang), (r_seq, r_env, r_hang) = fn(), plain()
    err, scale = max_err(g_seq, r_seq)
    log(f"  agc_envelope ({block}, {c_main}) max|err| {err:.3e} "
        f"(bound {1e-4 * scale:.3e})")
    check(err <= 1e-4 * scale, f"agc envelope: {err}")
    check(max_err(g_env, r_env)[0] <= 1e-4 * scale, "agc final env")
    check(bool(torch.equal(g_hang, r_hang)), "agc hang")
    # mag_db and the state in, the envelope and the state out; a step is
    # a compare, two subtract-multiply-adds and two selects
    out["agc_envelope"] = dict(
        max_abs_err=err, ms=timer(fn, reps=10), plain_ms=timer(plain, reps=1),
        library_ms=None,
        **roofline(2 * mag_db.numel() * 4 + 4 * c_main * 4,
                8.0 * mag_db.numel()))

    # kernel 4: SAM PLL on AM carriers with offsets, plus noise
    sam = demod.SamParams(fs=plan12.fs_out)
    t = torch.arange(block, device=device, dtype=torch.float32)[:, None]
    off = torch.empty((1, c_main), device=device).uniform_(
        -0.03, 0.03, generator=gen)                   # rad/sample
    env = 1 + 0.5 * torch.sin(0.2 * t)
    z = torch.polar(env.expand(block, c_main), off * t) + 0.02 * torch.complex(
        torch.randn((block, c_main), generator=gen, device=device),
        torch.randn((block, c_main), generator=gen, device=device))
    z = z.to(torch.complex64)
    ph0 = torch.zeros(c_main, device=device)
    fr0 = torch.zeros(c_main, device=device)
    ms_ordinary = timer(lambda: demod.sam_pll(sam, z, ph0, fr0), reps=10)
    # lanes the kernel treats apart from the rest: all zero, zero from
    # mid-block on, one NaN, one infinity, a carrier beyond the pull-in
    # limit on either side (freq sits at the +-fmax clamp)
    lanes = dict(zero=5, turns_zero=37, nan=70, inf=101, clamp_hi=133,
                 clamp_lo=165)
    z[:, lanes["zero"]] = 0
    z[block // 2:, lanes["turns_zero"]] = 0
    z[block // 3, lanes["nan"]] = complex(float("nan"), 0.5)
    z[block // 3, lanes["inf"]] = complex(float("inf"), 0.5)
    z[:, lanes["clamp_hi"]] = torch.polar(torch.ones_like(t), 0.6 * t)[:, 0]
    z[:, lanes["clamp_lo"]] = torch.polar(torch.ones_like(t), -0.6 * t)[:, 0]
    fn = lambda: demod.sam_pll(sam, z, ph0, fr0)
    plain = lambda: demod.sam_pll_plain(sam, z, ph0, fr0)
    (g_v, g_ph, g_fr), (r_v, r_ph, r_fr) = fn(), plain()
    err, scale = max_err_finite(torch, g_v, r_v, "sam pll v")
    log(f"  sam_pll ({block}, {c_main}) max|err| {err:.3e} "
        f"(bound {1e-4 * scale:.3e})")
    check(err <= 1e-4 * scale, f"sam pll: {err}")
    check(max_err_finite(torch, g_fr, r_fr, "sam freq")[0]
          <= 1e-4 * float(sam.fmax), "sam freq")
    check(max_err_finite(torch, g_ph, r_ph, "sam phase")[0] <= 1e-4 * math.pi,
          "sam phase")
    check(bool(torch.isnan(r_fr[lanes["nan"]]))
          and abs(float(r_fr[lanes["clamp_hi"]]) - sam.fmax) < 1e-6
          and abs(float(r_fr[lanes["clamp_lo"]]) + sam.fmax) < 1e-6
          and not bool(g_v[:, lanes["zero"]].abs().max() > 0),
          "sam pll: the special lanes are not what they were made to be")
    # z and the state in, v and the state out; a step is a complex
    # product, sin, cos and atan2 (one operation each), two FMAs, a clamp,
    # an add and a wrap
    out["sam_pll"] = dict(
        max_abs_err=err, ms=timer(fn, reps=10), plain_ms=timer(plain, reps=1),
        library_ms=None, ms_ordinary_lanes=ms_ordinary,
        **roofline(2 * z.numel() * 8 + 4 * c_main * 4, 19.0 * z.numel()))
    return out


# ---------------------------------------------------------------------------
# phase 2: DDC tone fidelity
# ---------------------------------------------------------------------------

def tone_metrics(audio: np.ndarray, fs: float):
    """(freq, amplitude, SINAD dB) of the dominant tone: 4-term
    Blackman-Harris window, +-6-bin integration (as the reference's
    `tests/test_channelizer.py:tone_metrics`)."""
    n = len(audio)
    k = np.arange(n) * (2 * np.pi / n)
    w = (0.35875 - 0.48829 * np.cos(k) + 0.14128 * np.cos(2 * k)
         - 0.01168 * np.cos(3 * k))
    p = np.abs(np.fft.fft(audio * w)) ** 2
    peak = int(np.argmax(p))
    sig = p[[(peak + d) % n for d in range(-6, 7)]].sum()
    amp = math.sqrt(sig / (n * np.sum(w ** 2)))
    sinad = 10 * math.log10(sig / max(p.sum() - sig, 1e-30))
    return float(np.fft.fftfreq(n, 1.0 / fs)[peak]), amp, sinad


def phase_ddc(torch, device, block: int) -> dict:
    from flydog_sdr_gps_tpu_torch.ops import channelizer as chz
    from flydog_sdr_gps_tpu_torch.ops import nco
    from flydog_sdr_gps_tpu_torch.runtime import DeviceSceneSource

    plan = chz.make_ddc_plan(audio_block=block)
    f_tuned, f_off = 7.040e6, 1000.0
    bank, dphi = chz.build_filterbank(
        plan, [nco.freq_to_fcw(f_tuned, plan.adc_clock)])
    bank = torch.as_tensor(bank, device=device)
    dphi = torch.as_tensor(dphi, device=device)
    src = DeviceSceneSource(tones=[(f_tuned + f_off, 1.0)],
                            block=plan.adc_block, device=device)
    st = chz.init_ddc_state(plan, 1, device)
    outs = []
    for _ in range(3):
        st, a = chz.ddc_block(plan, st, src.next_block(), bank, dphi)
        outs.append(a[:, 0].cpu().numpy())
    audio = np.concatenate(outs)[64:]
    f, amp, sinad = tone_metrics(audio, plan.fs_out)
    log(f"  tone: {f:.1f} Hz (want {f_off}), amplitude {amp:.5f}, "
        f"SINAD {sinad:.2f} dB (want >= 80)")
    check(abs(f - f_off) < plan.fs_out / len(audio) * 4, f"tone freq {f}")
    check(abs(amp - 1.0) < 0.01, f"tone amplitude {amp}")
    check(sinad >= 80.0, f"SINAD {sinad} dB < 80")
    return dict(freq_hz=f, amplitude=amp, sinad_db=sinad)


# ---------------------------------------------------------------------------
# phase 3: the slice through StreamEngine
# ---------------------------------------------------------------------------

def dominant_hz(audio: np.ndarray, fs: float) -> float:
    spec = np.abs(np.fft.rfft(audio * np.hanning(len(audio))))
    spec[:3] = 0.0                                  # ignore DC
    return float(np.fft.rfftfreq(len(audio), 1.0 / fs)[np.argmax(spec)])


def make_engine(torch, device, channels: int, block: int, stage2: str):
    from flydog_sdr_gps_tpu_torch.models import rx_channel as rx
    from flydog_sdr_gps_tpu_torch.ops import demod
    from flydog_sdr_gps_tpu_torch.runtime import (DeviceSceneSource,
                                                  StreamEngine)
    params = rx.RxParams(num_channels=channels, audio_block=block,
                         stage2=stage2)
    src = DeviceSceneSource(tones=SCENE, noise_rms=3e-4,
                            block=params.ddc.adc_block, device=device)
    eng = StreamEngine(params, src, device=device)
    eng.set_channel(0, freq_hz=7.100e6, mode=demod.MODE_AM, in_use=True)
    eng.set_channel(1, freq_hz=14.200e6, mode=demod.MODE_USB, in_use=True)
    for i, f in enumerate(EMPTY_FREQS):
        eng.set_channel(2 + i, freq_hz=f, mode=demod.MODE_USB, in_use=True)
    return eng


def run_blocks(torch, eng, n: int, keep: list):
    """Run ``n`` blocks, synchronizing after each; keep the listened
    channels' taps on the host; return per-block wall ms."""
    lanes = slice(0, 2 + len(EMPTY_FREQS))
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        taps = eng.run_block()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        for name in ("audio", "audio2", "iq_pre_fir", "iq_post_agc",
                     "smeter_dbm"):
            check(bool(torch.isfinite(getattr(taps, name)).all()),
                  f"non-finite {name}")
        keep.append((taps.audio[:, lanes].cpu().numpy(),
                     taps.smeter_dbm[lanes].cpu().numpy()))
    return ms


def phase_slice(torch, device, channels: int, block: int,
                nfused: int = 8, nunfused: int = 2,
                profile: bool = False) -> dict:
    from flydog_sdr_gps_tpu_torch.ops import agc, demod, kernels
    counters = {"stage2_rot": kernels.stage2_rot, "stage2": kernels.stage2,
                "agc_envelope": agc.envelope_scan, "sam_pll": demod.sam_pll}

    eng = make_engine(torch, device, channels, block, "fused")
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0                     # the main path's run starts
    fused = []
    ms = run_blocks(torch, eng, nfused, fused)
    per_block = {k: fn.launches / nfused for k, fn in counters.items()}
    fs = eng.params.fs_out
    block_ms = eng.params.ddc.adc_block / eng.params.adc_clock * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del eng
    eng = make_engine(torch, device, channels, block, "unfused")
    unfused = []
    ms_unfused = run_blocks(torch, eng, nunfused, unfused)
    launches = {k: fn.launches for k, fn in counters.items()}
    per_block_unfused = {
        k: (n - per_block[k] * nfused) / nunfused for k, n in launches.items()}
    del eng                                  # the main path's run ends
    prof_table = None
    if profile:                              # after the counts were read
        eng = make_engine(torch, device, channels, block, "fused")
        prof_table = profile_block(torch, eng)
        del eng

    log(f"  launches in the main path's run: {launches}; per fused block "
        f"{per_block}, per unfused block {per_block_unfused}")
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched by the main path")
    audio = np.concatenate([a for a, _ in fused])
    settled = audio[len(audio) // 4:]       # past FIR fill and AGC attack
    f_am = dominant_hz(settled[:, 0], fs)
    f_usb = dominant_hz(settled[:, 1], fs)
    rms_empty = np.sqrt(np.mean(settled[:, 2:] ** 2, axis=0))
    smeter = fused[-1][1]
    log(f"  AM 7.100 MHz hears {f_am:.1f} Hz; USB 14.200 MHz hears "
        f"{f_usb:.1f} Hz; empty-lane rms {np.array2string(rms_empty)}")
    log(f"  S-meter dBm: AM {smeter[0]:.2f}, USB {smeter[1]:.2f}, "
        f"empty {np.array2string(smeter[2:], precision=1)}")
    resolution = fs / len(settled)
    check(abs(f_am - 1000.0) <= 2 * resolution + 5, f"AM hears {f_am}")
    check(abs(f_usb - 1800.0) <= 2 * resolution + 5, f"USB hears {f_usb}")
    check(bool(np.all(rms_empty < EMPTY_RMS_MAX)),
          f"empty lanes not quiet: {rms_empty}")
    # AM: 0.30 carrier (60 % at 1 kHz) -> ~-23.5 dBm mean, ~-19.4 peak;
    # USB: 0.15 tone -> ~-29.5 dBm; empty lanes near the noise floor
    check(-26.0 < smeter[0] < -16.0, f"AM S-meter {smeter[0]}")
    check(-33.0 < smeter[1] < -26.0, f"USB S-meter {smeter[1]}")
    check(bool(np.all(smeter[2:] < -100.0)), f"empty S-meter {smeter[2:]}")
    check(all(np.isfinite(a).all() for a, _ in unfused), "unfused audio")
    # the rate is all the signal time of the steady blocks over all their
    # wall time, so a stall in the window counts; the median and spread
    # are per-block statistics beside it
    steady = ms[2:] if len(ms) > 2 else ms
    return dict(launches=launches, launches_per_block=per_block,
                launches_per_block_unfused=per_block_unfused,
                ms_median=statistics.median(steady),
                ms_min=min(steady), ms_max=max(steady),
                ms_blocks=ms, ms_unfused_blocks=ms_unfused,
                realtime_factor=len(steady) * block_ms / sum(steady),
                block_period_ms=block_ms,
                peak_mem_gb=peak_gb, am_hz=f_am, usb_hz=f_usb,
                smeter_dbm=[float(v) for v in smeter],
                empty_rms=[float(v) for v in rms_empty],
                profile=prof_table)


def profile_block(torch, eng) -> str:
    """Where one block's time goes: the source, the DDC and the audio
    back half each timed alone (3 runs), then one block under
    torch.profiler, device time by kernel."""
    from torch.profiler import ProfilerActivity, profile
    from flydog_sdr_gps_tpu_torch.models import rx_channel as rx
    timer = Timer(torch)
    x = eng.source.next_block()
    p, st, tu = eng.params, eng.state, eng.tuning
    _, iq = rx._ddc(p, st, tu, x)
    stages = {
        "source.next_block": lambda: eng.source.next_block(),
        "ddc (stage 1 + fused stage 2)": lambda: rx._ddc(p, st, tu, x),
        "audio_back_half": lambda: rx.audio_back_half(p, st, tu, iq),
    }
    lines = [f"  {name:<32} {timer(fn, reps=3):9.3f} ms"
             for name, fn in stages.items()]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.run_block()
        torch.cuda.synchronize()
    return "\n".join(["stage times (each alone):", *lines,
                      prof.key_averages().table(sort_by="cuda_time_total",
                                                row_limit=30,
                                                max_name_column_width=70)])


# ---------------------------------------------------------------------------

def main(argv: list[str]) -> int:
    profile = "--profile" in argv
    if not (HERE / PKG / "_build.py").is_file():
        log(f"chip_smoke: {PKG}/ is not beside this script; run it from "
            "the root of a checkout")
        return 2
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is false; this script "
            "needs an NVIDIA card")
        return 1
    sys.path.insert(0, str(HERE))
    from flydog_sdr_gps_tpu_torch import _build

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader", "-i", "0"])
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(run([_build._nvcc(), "--version"]).splitlines()[-1])
    log(f"card: {card}")

    t0 = time.perf_counter()
    _build.lib()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s wall "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'} s)"
        f" -> {_build.library_path()}")

    timer = Timer(torch)
    log("phase 1: kernels vs plain versions")
    kern = phase_kernels(torch, device, timer, c_main=4096, block=2048)
    for name, r in kern.items():
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        lib = (f"{r['library_call']} {r['library_ms']:.4f} ms (layout change "
               "not timed)"
               if r["library_ms"] is not None else "no single library call")
        if "ms_ordinary_lanes" in r:
            lib += (f"; {r['ms_ordinary_lanes']:.4f} ms before the special "
                    "lanes were put in")
        log(f"  {name:<13} kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f}"
            f" ms, {lib}; bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
            f"(bytes {r['bound_bytes_ms']:.4f}, operations "
            f"{r['bound_ops_ms']:.4f}), share of bound "
            f"{r['share_of_bound']:.3f}  [{card}]")
        # a kernel cannot beat its bound: a share over 1 is a timing fault
        check(r["share_of_bound"] <= 1.05,
              f"{name}: {r['ms']} ms is under its bound {r['bound_ms']} ms")
    log("phase 2: DDC tone fidelity")
    ddc = phase_ddc(torch, device, block=2048)
    log("phase 3: the slice, C=4096, audio_block=2048")
    sl = phase_slice(torch, device, channels=4096, block=2048,
                     profile=profile)
    log(f"  realtime factor {sl['realtime_factor']} (signal time / wall "
        f"time of the blocks after 2 warm-up blocks, {sl['block_period_ms']}"
        f" ms per block period); per block median {sl['ms_median']} ms, "
        f"min {sl['ms_min']}, max {sl['ms_max']}; peak memory "
        f"{sl['peak_mem_gb']} GB  [{card}]")
    log(f"  per-block ms: {[round(v, 2) for v in sl['ms_blocks']]}, "
        f"unfused: {[round(v, 2) for v in sl['ms_unfused_blocks']]}")
    if sl["profile"]:
        log(sl["profile"])
    summary = dict(card=card, build_s=_build.build_seconds, ddc=ddc,
                   slice={k: v for k, v in sl.items() if k != "profile"},
                   kernels=kern)
    out_dir = HERE / "build"                # listed in .gitignore
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(summary, indent=1))

    log(card)
    log(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=f"{PKG}/{src}",
             replaces=replaces, launches=sl["launches"][name],
             launches_per_block=sl["launches_per_block"][name],
             launches_per_block_unfused=sl[
                 "launches_per_block_unfused"][name],
             max_abs_err=kern[name]["max_abs_err"], ms=kern[name]["ms"],
             plain_ms=kern[name]["plain_ms"],
             bound_ms=kern[name]["bound_ms"],
             bound_by=kern[name]["bound_by"],
             share_of_bound=kern[name]["share_of_bound"],
             library_ms=kern[name]["library_ms"])
        for name, (src, replaces) in KERNEL_SOURCES.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
