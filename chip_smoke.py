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
   infinity, or sit at the +-fmax clamp; the LMS chain (kernel 5) at
   (2048, 4096) with every combination of enables side by side, timed
   with every stage on (its row), with those mixed enables, every stage
   off and one lane on.  Times each kernel twice (with the card kept
   busy before the timed calls, ``ms``, and without, ``ms_host_paced``)
   and its plain version, and for kernel 2 one library call
   (``conv1d``) that computes the same function.  Each kernel's time is
   held against its bound: the larger of its bytes (every input and
   output once) over 3.35 TB/s and the operations the function needs
   over 67 TFLOP/s (the H100 SXM's published float32 peak).
2. DDC fidelity: a noise-free full-scale tone through ``ddc_block`` —
   right frequency, amplitude ~1.0, SINAD >= 80 dB (a stage-1 matmul
   that quietly ran in TF32 would fail this).
3. The slice: ``StreamEngine`` at C=4096, audio_block=2048, fed by a
   ``DeviceSceneSource`` (AM 7.100 MHz with 1 kHz, a tone at 14.2018
   MHz, a carrier at 10.000 MHz, noise 3e-4 rms): an AM channel must hear
   1000 Hz, a USB channel 1800 Hz, empty channels stay quiet, S-meters
   plausible, every tap finite; 8 fused blocks and 2 unfused blocks,
   with the launch counters of kernels 1-4 shown to rise in that run.
4. The serving path: a ``StreamEngine`` at the same size fed by the same
   scene plus one FSK emitter; 32 subscribed channels spread over the
   band (AM, USB, one SAM, one with the LMS notch and denoiser on, one
   with spectral NR on) served by ``run_block_gather`` at bucket 32,
   then at bucket 64 after ``prewarm_gather(64)`` ran on a thread while
   blocks went on; the packed array fetched to pinned host memory one
   block behind and unpacked by the server's layout rule; a
   ``WfSubsystem`` with four slots (z0, z7, z13, and z14, which needs
   two blocks an ingest) fed ``engine._last_x`` every block, one row a
   slot a block.  Checks: the packed columns equal the same columns of
   ``run_block``'s taps from a second engine with the same seed
   (exact); the AM lane hears 1000 Hz, the USB lane 1800 Hz; the z0
   row's three strongest peaks sit at the scene's carriers; the
   deep-zoom rows centred on 10 MHz peak at their centre; a checkpoint
   loaded into a new engine gives the uninterrupted engine's next block
   (exact); kernels 1, 3, 4 and 5 were launched once a served block
   (the second engine's blocks run before the counters are set to 0);
   nothing is non-finite; a block with the LMS chain on for every
   channel stays under the block period.

5. The server: a ``KiwiServer`` on a ``StreamEngine`` at the same size
   and the ``run_server`` scene, ``realtime=False``, 32 listeners over
   in-process sockets, each driven by the command strings a KiwiSDR
   client sends (``SET auth``, ``SET mod= low_cut= high_cut= freq=``,
   ``SET compression=``, ``SET zoom= start=``, ``SET wf_speed=``): AM on
   7100 kHz and USB on 14200 kHz (ADPCM and plain s16), one IQ-mode
   listener, one SAM, one with ``SET nr algo=2`` + ``type=1 en=1`` +
   ``type=0 en=1`` (kernel 5 through the protocol), one with spectral NR,
   one S_meter extension client, four W/F sockets at z0/z7/z13/z14; a
   listener that joins mid-run; where aiohttp is installed, one real
   WebSocket client on an ephemeral port.  Checks: every SND header
   parses, sequence numbers run without a gap, nothing was dropped; the
   decoded audio of the AM lanes peaks at 1000 Hz, of the USB lanes at
   1800 Hz; the S-meter field of the carrier lanes is within 1 dB of
   ``run_block``'s; W/F rows arrive at every zoom with their strongest
   bins on the scene's carriers; kernels 1, 3, 4 and 5 were launched
   once a block; the late joiner hears audio within the pipeline's two
   blocks (and the one that was running); the WebSocket client's first
   SND packet is the one an in-process socket got.  Prints the wall time
   a block (block start to block start), the realtime factor with the
   server in the loop, the host time a block in the encode and the
   fan-out, and what the event loop loses while the blocks are enqueued.

The line before the last is a JSON object with each kernel's launches,
error against its plain version, times and bound; the last line is
``{"ok": true, "device": {...}}``.  The script imports no jax.
"""

from __future__ import annotations

import dataclasses
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
    "lms_chain": ("csrc/lms.cu", "flydog_sdr_gps_tpu/ops/noise.py:296"),
}
# the serving scene adds one WSPR-like 4-FSK emitter (8192 audio samples a
# symbol = 4 blocks, 162 symbols, then idle to 200)
FSK_TONE = (10.1387e6, 0.10)
WF_CARRIERS_HZ = (7.100e6, 10.000e6, 14.2018e6)


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
    """Milliseconds per call: CUDA events around ``reps`` calls.

    With ``ahead`` the card is first kept busy by a large matrix product
    (about 20 ms), so that the host has enqueued every timed call before
    the first of them starts and the events bracket device time alone: a
    wrapper's host work (a few launches and a ctypes call, tens of
    microseconds) otherwise outlasts a short kernel, and the events
    would time the host.  :meth:`both` gives the two readings side by
    side: ``ms`` with the card kept busy first, ``ms_host_paced``
    without (the timer of this script's earlier versions, so that
    earlier numbers stay comparable)."""

    def __init__(self, torch):
        self.torch = torch
        self._busy = None

    def __call__(self, fn, reps: int = 5, warmup: int = 1,
                 ahead: bool = False) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        if ahead and self._busy is None:
            self._busy = torch.zeros((8192, 8192), device="cuda")
        torch.cuda.synchronize()
        if ahead:
            torch.matmul(self._busy, self._busy)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    def both(self, fn, reps: int = 10) -> dict:
        return dict(ms=self(fn, reps=reps, ahead=True),
                    ms_host_paced=self(fn, reps=reps))

    def release(self) -> None:
        self._busy = None


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
                out[kname] = dict(max_abs_err=err, **timer.both(fn),
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
        max_abs_err=err, **timer.both(fn),
        plain_ms=timer(plain, reps=1), library_ms=None,
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
    ms_ordinary = timer(lambda: demod.sam_pll(sam, z, ph0, fr0), reps=10,
                        ahead=True)
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
        max_abs_err=err, **timer.both(fn),
        plain_ms=timer(plain, reps=1), library_ms=None,
        ms_ordinary_lanes=ms_ordinary,
        **roofline(2 * z.numel() * 8 + 4 * c_main * 4, 19.0 * z.numel()))
    del z, g_v, r_v

    # kernel 5: the LMS notch -> denoiser chain on tones in noise, every
    # combination of enables side by side (channel % 4: both, notch only,
    # denoiser only, none)
    from flydog_sdr_gps_tpu_torch.ops import noise
    pn, pd = noise.LmsParams(notch=True), noise.LmsParams(notch=False)
    k = torch.arange(c_main, device=device)
    mixed = ((k % 4 == 0) | (k % 4 == 1), (k % 4 == 0) | (k % 4 == 2))
    every = torch.ones(c_main, dtype=torch.bool, device=device)
    enables = {"mixed": mixed, "all_on": (every, every),
               "all_off": (~every, ~every), "one_lane": (k == 5, k == 5)}
    f = torch.empty((1, c_main), device=device).uniform_(
        0.05, 1.0, generator=gen)                     # rad/sample
    x = 0.3 * torch.sin(f * t) + 0.1 * torch.randn(
        (block, c_main), generator=gen, device=device)
    sn, sd = (noise.init_lms(p, c_main, device) for p in (pn, pd))
    # adapted weights and full delay lines, as in a running receiver
    _, sn, sd = noise.lms_chain_block(pn, pd, x.flip(0).contiguous(), sn, sd,
                                      every, every)

    def lms(en, fn=noise.lms_chain_block):
        return lambda: fn(pn, pd, x, sn, sd, en[0], en[1])
    (g_y, g_n, g_d), (r_y, r_n, r_d) = lms(mixed)(), lms(
        mixed, noise.lms_chain_block_plain)()
    err, scale = max_err(g_y, r_y)
    log(f"  lms_chain ({block}, {c_main}) mixed enables max|err| {err:.3e} "
        f"(bound {1e-4 * scale:.3e})")
    check(err <= 1e-4 * scale, f"lms chain: {err}")
    for got, ref, what in ((g_n, r_n, "notch"), (g_d, r_d, "denoiser")):
        check(max_err(got.weights, ref.weights)[0] <= 1e-4, f"lms {what} w")
        check(max_err(got.line, ref.line)[0] <= 1e-4 * scale,
              f"lms {what} line")
    off = ~(mixed[0] | mixed[1])
    check(bool(torch.equal(g_y[:, off], x[:, off])), "lms: off lanes copy x")
    ms_by_enables = {name: timer(lms(en), reps=5, ahead=True)
                     for name, en in enables.items()}
    # x, both stages' weights and lines and the enables in; y and the
    # carries out.  Operations that the function needs, a stage that is on:
    # 5 a tap and sample (2 for the prediction, 3 for the update) and 4 a
    # sample for the norm, since successive windows differ by one sample
    # (add the square that enters, take off the one that leaves), which is
    # also how the kernel takes its norms.
    # The row is the case with every stage on.  With mixed enables the
    # function needs half of that, but the kernel runs a stage for a whole
    # warp (eight channels) if one of them has it on, which with these
    # enables is every warp: its time is the all-on time, and its bound is
    # printed beside the row, not as the row.
    carries = 2 * (pn.taps + pn.taps + pn.delay) * c_main * 4
    nbytes = 2 * x.numel() * 4 + 2 * carries + 2 * c_main
    per_stage = (5.0 * pn.taps + 4.0) * block

    def bound(en):
        return roofline(nbytes,
                        per_stage * (int(en[0].sum()) + int(en[1].sum())))
    out["lms_chain"] = dict(
        max_abs_err=err, ms=ms_by_enables["all_on"],
        ms_host_paced=timer(lms(enables["all_on"]), reps=5),
        plain_ms=timer(lms(mixed, noise.lms_chain_block_plain), reps=1,
                       warmup=0),
        library_ms=None, ms_by_enables=ms_by_enables,
        bound_ms_by_enables={name: bound(en)["bound_ms"]
                             for name, en in enables.items()},
        **bound(enables["all_on"]))
    timer.release()
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
# phase 4: the serving path (run_block_gather + fetch + the waterfall)
# ---------------------------------------------------------------------------

def serve_channels(bucket: int, channels: int) -> np.ndarray:
    """The subscribed channel numbers: 32 spread over all channels, and
    for bucket 64 another 32 between them."""
    stride = channels // 32
    first = stride * np.arange(32) + stride // 16
    return (first if bucket == 32
            else np.concatenate([first, first + stride // 2])
            ).astype(np.int32)


# what the first subscribed lanes listen to; the rest are USB lanes spread
# over the band
SERVE_LANES = ("am", "usb", "sam", "lms", "spectral_nr")


def make_serve_engine(torch, device, channels: int, block: int):
    from flydog_sdr_gps_tpu_torch.models import rx_channel as rx
    from flydog_sdr_gps_tpu_torch.ops import demod
    from flydog_sdr_gps_tpu_torch.runtime import (DeviceSceneSource,
                                                  StreamEngine)
    params = rx.RxParams(num_channels=channels, audio_block=block)
    symbols = np.random.default_rng(162).integers(0, 4, 162).tolist()
    scene = SCENE + [FSK_TONE + (("fsk", 8192, 12000 / 8192, symbols, 200),)]
    src = DeviceSceneSource(tones=scene, noise_rms=3e-4,
                            block=params.ddc.adc_block, device=device)
    eng = StreamEngine(params, src, device=device)
    subs = serve_channels(64, channels)
    settings = dict(
        am=dict(freq_hz=7.100e6, mode=demod.MODE_AM),
        usb=dict(freq_hz=14.200e6, mode=demod.MODE_USB),
        sam=dict(freq_hz=7.100e6, mode=demod.MODE_SAM),
        # the FSK emitter, 1.5 kHz up in a USB lane, notch and denoiser on
        lms=dict(freq_hz=FSK_TONE[0] - 1500.0, mode=demod.MODE_USB,
                 nr_notch_on=True, nr_den_on=True),
        # the 10 MHz carrier as a 1 kHz tone, spectral NR on
        spectral_nr=dict(freq_hz=9.999e6, mode=demod.MODE_USB, nr_on=True))
    for ch, name in zip(subs, SERVE_LANES):
        eng.set_channel(int(ch), in_use=True, **settings[name])
    for i, ch in enumerate(subs[len(SERVE_LANES):]):
        # (not 10.0 MHz sharp: that is the control mirror's default, so
        # set_channel would see no change and leave the bank as built)
        eng.set_channel(int(ch), freq_hz=1.0003e6 + 0.45e6 * i,
                        mode=demod.MODE_USB, in_use=True)
    return eng


def unpack(packed: np.ndarray, channels: int, block: int):
    """The server's layout rule: four (bucket, block) tap sections, the
    S-meter of every channel, the block's peak."""
    check(packed.ndim == 1 and packed.dtype == np.float32, "packed type")
    bucket = (len(packed) - channels - 1) // (4 * block)
    check(len(packed) == 4 * bucket * block + channels + 1, "packed length")
    nb = bucket * block
    rows = [packed[k * nb:(k + 1) * nb].reshape(bucket, block)
            for k in range(4)]
    return rows, packed[4 * nb:4 * nb + channels], float(packed[-1])


def strongest_peaks(row: np.ndarray, n: int, guard: int = 3) -> list[int]:
    """Pixels of the n strongest peaks, each with its neighbours taken
    out before the next is looked for."""
    row = row.copy()
    out = []
    for _ in range(n):
        px = int(np.argmax(row))
        out.append(px)
        row[max(px - guard, 0):px + guard + 1] = -np.inf
    return sorted(out)


def phase_serve(torch, device, timer, channels: int, block: int,
                n32: int = 8, n64: int = 4, profile: bool = False) -> dict:
    import threading
    from flydog_sdr_gps_tpu_torch.models import rx_channel as rx
    from flydog_sdr_gps_tpu_torch.models import waterfall as wf_model
    from flydog_sdr_gps_tpu_torch.numerology import (MAX_ZOOM, UI_SRATE_30M,
                                                     WF_OUT_PX)
    from flydog_sdr_gps_tpu_torch.ops import agc, demod, kernels, noise
    from flydog_sdr_gps_tpu_torch.server.wf_service import WfSubsystem
    counters = {"stage2_rot": kernels.stage2_rot, "stage2": kernels.stage2,
                "agc_envelope": agc.envelope_scan, "sam_pll": demod.sam_pll,
                "lms_chain": noise.lms_chain_block}

    eng = make_serve_engine(torch, device, channels, block)
    twin = make_serve_engine(torch, device, channels, block)   # run_block
    check(eng.tuning.any_lms and eng.tuning.any_spectral_nr,
          "the NR lanes are not on")
    wf = WfSubsystem(eng.params.adc_clock, UI_SRATE_30M, capacity=4,
                     device=device)
    hz_per_start = UI_SRATE_30M / (WF_OUT_PX << MAX_ZOOM)

    def centred(zoom, cf=10.0e6):
        span = UI_SRATE_30M / (1 << zoom)
        return round((cf - span / 2) / hz_per_start)
    slots = {0: wf.attach(0, 0), 7: wf.attach(7, centred(7)),
             13: wf.attach(13, centred(13)), 14: wf.attach(14, centred(14))}
    check(all(s is not None for s in slots.values()), "a slot was refused")
    check(wf.attach(3, 0) is None, "a fifth chain was handed out")
    check(slots[14].params.ingest_blocks(eng.params.ddc.adc_block) == 2
          and slots[13].params.ingest_blocks(eng.params.ddc.adc_block) == 1,
          "z14 needs two blocks an ingest, z13 one")

    block_ms = eng.params.ddc.adc_block / eng.params.adc_clock * 1e3
    nblocks = n32 + n64

    def bucket_of(blk):
        return 32 if blk < n32 else 64
    # what the served engine must give, from the twin's run_block, in a
    # pass of its own so that the serving run's counts are its own
    wants = []
    for blk in range(nblocks):
        taps = twin.run_block()
        i = torch.as_tensor(serve_channels(bucket_of(blk), channels),
                            dtype=torch.int64, device=device)
        want = torch.cat(
            [t[:, i].T.reshape(-1) for t in (
                taps.audio, taps.audio2, taps.iq_post_agc.real,
                taps.iq_post_agc.imag)]
            + [taps.smeter_dbm, twin._last_x.abs().max().reshape(1)])
        wants.append(want.cpu().numpy())
        del taps, want
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0                     # the serving path's run starts
    ms, audio, rows_seen = [], [], {}
    pending = None                          # (fetch handle, want, bucket)
    warm = None

    def settle(entry):
        handle, want, bucket = entry
        got = handle.result()
        check(got.shape == (eng.packed_len(bucket),), "fetched length")
        check(bool(np.isfinite(got).all()), "non-finite value in a fetch")
        check(np.array_equal(got, want), "packed columns differ from the "
              "same columns of run_block's taps")
        tap_rows, smeter, peak = unpack(got, channels, block)
        audio.append(tap_rows[0][:len(SERVE_LANES)])
        return smeter, peak

    for blk in range(nblocks):
        bucket = bucket_of(blk)
        idx = serve_channels(bucket, channels)
        if blk == n32 // 2:                 # off the block loop, as the
            warm = threading.Thread(        # server does for a new bucket
                target=eng.prewarm_gather, args=(64,))
            warm.start()
        if blk == n32:
            warm.join()
        t0 = time.perf_counter()
        packed = eng.run_block_gather(idx)
        wf.ingest(eng._last_x)
        handle = eng.start_fetch(packed)    # copies while the rows are made
        rows = {z: wf.frame(s) for z, s in slots.items()}
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if pending is not None:             # outside the timed window:
            settle(pending)                 # the block before
        pending = (handle, wants[blk], bucket)
        for z, row in rows.items():
            check(row.shape == (WF_OUT_PX,) and bool(np.isfinite(row).all()),
                  f"z{z} row")
        rows_seen = rows
    smeter, peak = settle(pending)
    launches = {k: fn.launches for k, fn in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del wants                               # the serving path's run ends
    log(f"  launches in the serving run ({nblocks} served blocks): "
        f"{launches}")
    for k in ("stage2_rot", "agc_envelope", "sam_pll", "lms_chain"):
        check(launches[k] == nblocks, f"kernel {k}: {launches[k]} launches "
              f"in {nblocks} served blocks, not one a block")
    check(launches["stage2"] == 0, "the served path is the fused one")

    # what the listeners hear
    fs = eng.params.fs_out
    heard = np.concatenate(audio, axis=1)           # (lanes, samples)
    settled = heard[:, heard.shape[1] // 4:]
    f_am, f_usb = dominant_hz(settled[0], fs), dominant_hz(settled[1], fs)
    f_nr = dominant_hz(settled[4], fs)
    resolution = fs / settled.shape[1]
    log(f"  AM lane hears {f_am:.1f} Hz, USB lane {f_usb:.1f} Hz, the "
        f"spectral-NR lane {f_nr:.1f} Hz; LMS lane rms "
        f"{float(np.sqrt(np.mean(settled[3] ** 2))):.4f}; peak |x| "
        f"{peak:.4f}")
    check(abs(f_am - 1000.0) <= 2 * resolution + 5, f"AM hears {f_am}")
    check(abs(f_usb - 1800.0) <= 2 * resolution + 5, f"USB hears {f_usb}")
    check(abs(f_nr - 1000.0) <= 2 * resolution + 5, f"NR lane hears {f_nr}")
    check(0.3 < peak <= 1.0, f"block peak {peak}")

    # what the waterfall shows
    z0 = rows_seen[0]
    want_px = sorted(round(f / UI_SRATE_30M * WF_OUT_PX)
                     for f in WF_CARRIERS_HZ)
    got_px = strongest_peaks(z0, 3)
    log(f"  z0 row: strongest peaks at pixels {got_px} (carriers at "
        f"{want_px}), {[round(float(z0[p]), 1) for p in got_px]} dB, median "
        f"{float(np.median(z0)):.1f} dB")
    check(all(abs(g - w) <= 1 for g, w in zip(got_px, want_px)),
          f"z0 peaks {got_px} are not at the carriers {want_px}")
    for z in (7, 13, 14):
        px = int(np.argmax(rows_seen[z]))
        log(f"  z{z} row centred on 10 MHz peaks at pixel {px} "
            f"({float(rows_seen[z][px]):.1f} dB, median "
            f"{float(np.median(rows_seen[z])):.1f} dB)")
        check(abs(px - WF_OUT_PX // 2) <= 1, f"z{z} peak at pixel {px}")
    # z14's first row is made before its first ingest is whole
    check(slots[14].row_seq == 1 + nblocks // 2
          and slots[13].row_seq == nblocks,
          "z14 makes a row every other block, z13 every block")

    # checkpoint: a new engine from the snapshot, fed the twin's source
    # (which stands where the served engine's does), gives the same block
    out_dir = HERE / "build"
    out_dir.mkdir(exist_ok=True)
    path = str(out_dir / "chip_smoke_state.pkl")
    idx = serve_channels(32, channels)
    t0 = time.perf_counter()
    eng.save_state(path)
    resumed = make_serve_engine(torch, device, channels, block)
    resumed.load_state(path)
    resume_s = time.perf_counter() - t0
    resumed.source = twin.source
    check(resumed.seq == eng.seq and resumed.block_ticks == eng.block_ticks
          and resumed.gps_timestamp() == eng.gps_timestamp(),
          "sequence or timestamp lost in the checkpoint")
    want = eng.fetch(eng.run_block_gather(idx))
    got = resumed.fetch(resumed.run_block_gather(idx))
    # all a listener gets: the tap rows, the peak, and the S-meter of the
    # channels in use (load_state retunes a channel nobody has tuned to
    # its control mirror's 10 MHz, as the reference does)
    used = 4 * 32 * block + serve_channels(64, channels)
    keep = np.concatenate([np.arange(4 * 32 * block), used, [len(want) - 1]])
    check(np.array_equal(got[keep], want[keep]), "the block after "
          "load_state differs from the uninterrupted engine's")
    log(f"  checkpoint: save + new engine + load {resume_s:.2f} s; the next "
        "block equals the uninterrupted engine's exactly")
    del resumed, twin

    # times of the pieces, each alone (CUDA events; pure functions of a
    # state that is not advanced)
    x = eng._last_x
    x2 = torch.cat([x, x])
    ingest_ms = {}
    for z, slot in slots.items():
        xin = x2 if z == 14 else x
        ingest_ms[z] = timer(lambda: wf_model.wf_ingest(
            slot.params, slot.state, xin, *slot.tune), reps=3)
    frame_ms = timer(lambda: wf_model.wf_frame(
        slots[0].params, slots[0].state, "hanning", "cma"), reps=10)
    del x2
    taps_audio = torch.randn((block, channels), device=device)
    nr_ms = timer(lambda: noise.spectral_nr_block(
        eng.params.nr, taps_audio, eng.state.nr), reps=3)
    gather_only = timer(lambda: eng.fetch(torch.zeros(
        eng.packed_len(32), device=device)), reps=5)

    # the served block with the NR lanes off, then with the LMS chain on
    # for every channel
    def served_ms(n):
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            eng.fetch(eng.run_block_gather(idx))
            out.append((time.perf_counter() - t0) * 1e3)
        return out
    subs = serve_channels(64, channels)
    on_ms = served_ms(4)
    eng.set_channel(int(subs[3]), nr_notch_on=False, nr_den_on=False)
    lms_off_ms = served_ms(4)
    eng.set_channel(int(subs[4]), nr_on=False)
    check(not eng.tuning.any_lms and not eng.tuning.any_spectral_nr,
          "the NR gates did not close")
    off_ms = served_ms(4)
    every = torch.ones(channels, dtype=torch.bool, device=device)
    eng.tuning = rx.with_gates(dataclasses.replace(
        eng.tuning, nr_notch_on=every, nr_den_on=every))
    all_lms_ms = served_ms(3)
    check(max(all_lms_ms) < block_ms, f"a block with the LMS chain on for "
          f"every channel took {max(all_lms_ms)} ms of {block_ms}")
    prof_table = None
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        eng.tuning = rx.with_gates(dataclasses.replace(
            eng.tuning, nr_notch_on=~every, nr_den_on=~every))
        eng.set_channel(int(subs[3]), nr_notch_on=True, nr_den_on=True)
        eng.set_channel(int(subs[4]), nr_on=True)
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            packed = eng.run_block_gather(idx)
            wf.ingest(eng._last_x)
            handle = eng.start_fetch(packed)
            for s in slots.values():
                wf.frame(s)
            handle.result()
            torch.cuda.synchronize()
        prof_table = prof.key_averages().table(
            sort_by="cuda_time_total", row_limit=30,
            max_name_column_width=70)

    steady = ms[2:n32] + ms[n32 + 1:]       # past warm-up and bucket change
    return dict(
        launches=launches, blocks=nblocks, ms_blocks=ms,
        ms_median=statistics.median(steady), ms_min=min(steady),
        ms_max=max(steady),
        realtime_factor=len(steady) * block_ms / sum(steady),
        block_period_ms=block_ms, peak_mem_gb=peak_gb,
        bytes_fetched={b: eng.packed_len(b) * 4 for b in (32, 64)},
        fetch_ms_bucket32=gather_only,
        wf_ingest_ms={f"z{z}": v for z, v in ingest_ms.items()},
        wf_frame_ms=frame_ms, spectral_nr_ms=nr_ms,
        served_ms_nr_on=on_ms, served_ms_lms_off=lms_off_ms,
        served_ms_nr_off=off_ms, served_ms_lms_every_channel=all_lms_ms,
        am_hz=f_am, usb_hz=f_usb, nr_lane_hz=f_nr, z0_peaks_px=got_px,
        resume_s=resume_s, profile=prof_table)


# ---------------------------------------------------------------------------
# phase 5: the server (KiwiSDR protocol over in-process sockets)
# ---------------------------------------------------------------------------

class Sock:
    """An in-process socket: what a connection asks of one
    (``send_bytes``, ``closed``, ``close``)."""

    def __init__(self):
        self.sent: list[bytes] = []
        self.closed = False

    async def send_bytes(self, data) -> None:
        self.sent.append(bytes(data))

    async def close(self) -> None:
        self.closed = True

    def of(self, tag: bytes) -> list[bytes]:
        return [p for p in self.sent if p[:len(tag)] == tag]


def parse_snd(pkt: bytes):
    """(flags, seq, S-meter dBm, rest of the header, payload) of one SND
    packet; raises on anything that is not one."""
    import struct
    from flydog_sdr_gps_tpu_torch.server import packets
    check(pkt[:3] == b"SND" and len(pkt) >= 10, "not an SND packet")
    flags = pkt[3]
    seq, = struct.unpack("<I", pkt[4:8])
    sm, = struct.unpack(">H", pkt[8:10])
    n = 20 if flags & packets.SND_FLAG_MODE_IQ else 10
    check(len(pkt) > n, "an SND packet without payload")
    return flags, seq, sm / 10.0 - packets.SMETER_BIAS, pkt[10:n], pkt[n:]


def snd_audio(sock: Sock) -> np.ndarray:
    """The float audio of a socket's SND packets, ADPCM decoded from the
    stream's start, s16 of either byte order."""
    from flydog_sdr_gps_tpu_torch.ops import adpcm
    from flydog_sdr_gps_tpu_torch.server import packets
    st, out = adpcm.AdpcmState(), []
    for pkt in sock.of(b"SND"):
        flags, _seq, _sm, _hdr, payload = parse_snd(pkt)
        if flags & packets.SND_FLAG_COMPRESSED:
            out.append(adpcm.decode(np.frombuffer(payload, np.uint8), st))
        else:
            le = flags & packets.SND_FLAG_LITTLE_ENDIAN
            out.append(np.frombuffer(payload, "<i2" if le else ">i2"))
    return np.concatenate(out).astype(np.float64) / 32768.0


def wf_rows(sock: Sock) -> list[tuple[int, int, np.ndarray]]:
    """(zoom, seq, the 1024 dB bytes) of a socket's W/F packets."""
    import struct
    from flydog_sdr_gps_tpu_torch.ops import adpcm
    from flydog_sdr_gps_tpu_torch.server import packets
    out = []
    for pkt in sock.of(b"W/F "):
        _x_bin, fz, seq = struct.unpack("<III", pkt[4:16])
        data = np.frombuffer(pkt[16:], np.uint8)
        if fz & packets.WF_FLAGS_COMPRESSION:
            data = adpcm.decode_u8(data, adpcm.AdpcmState())[
                packets.ADPCM_PAD:]
        check(len(data) == 1024, f"a W/F row of {len(data)} bins")
        out.append((fz & 0xFFFF, seq, data))
    return out


SERVER_LISTENERS = 32


def server_script(channels: int) -> list[tuple[str, list[str]]]:
    """(what the lane is, the SET commands of its SND socket) for the 32
    listeners, as a KiwiSDR client sends them."""
    auth = "SET auth t=kiwi p="

    def tune(mod, lo, hi, khz):
        return f"SET mod={mod} low_cut={lo} high_cut={hi} freq={khz:.3f}"
    am = tune("am", -4000, 4000, 7100.0)
    usb = tune("usb", 300, 2700, 14200.0)
    lanes = [
        ("am adpcm", [auth, "SET ident_user=am", am, "SET compression=1"]),
        ("am s16", [auth, am, "SET compression=0"]),
        ("usb adpcm", [auth, usb, "SET compression=1"]),
        ("usb s16", [auth, usb, "SET compression=0", "SET little-endian"]),
        ("iq", [auth, tune("iq", -5000, 5000, 14200.0)]),
        ("sam", [auth, tune("sam", -4000, 4000, 7100.0),
                 "SET compression=0"]),
        # the LMS chain (kernel 5) through the protocol
        ("lms", [auth, usb, "SET compression=0", "SET nr algo=2",
                 "SET nr type=1 en=1", "SET nr type=0 en=1"]),
        # the 10 MHz carrier as a 1 kHz tone, spectral NR on
        ("spectral_nr", [auth, tune("usb", 300, 2700, 9999.0),
                         "SET compression=0", "SET nr algo=3",
                         "SET nr type=0 en=1"]),
        ("s_meter ext", [auth, am, "SET compression=1"]),
    ]
    for i in range(SERVER_LISTENERS - len(lanes)):
        lanes.append((f"usb spread {i}", [
            auth, tune("usb", 300, 2700, 1000.3 + 450.0 * i),
            f"SET compression={i % 2}"]))
    return lanes


def phase_server(torch, device, channels: int, block: int,
                 nblocks: int = 14) -> dict:
    import asyncio
    from flydog_sdr_gps_tpu_torch import run_server
    from flydog_sdr_gps_tpu_torch.models import rx_channel as rx
    from flydog_sdr_gps_tpu_torch.numerology import (MAX_ZOOM, UI_SRATE_30M,
                                                     WF_OUT_PX)
    from flydog_sdr_gps_tpu_torch.ops import agc, demod, kernels, noise
    from flydog_sdr_gps_tpu_torch.runtime import (DeviceSceneSource,
                                                  StreamEngine)
    from flydog_sdr_gps_tpu_torch.server import KiwiServer, kiwi_server
    from flydog_sdr_gps_tpu_torch.server import packets
    counters = {"stage2_rot": kernels.stage2_rot, "stage2": kernels.stage2,
                "agc_envelope": agc.envelope_scan, "sam_pll": demod.sam_pll,
                "lms_chain": noise.lms_chain_block}
    have_aiohttp = kiwi_server.web is not None

    def engine():
        params = rx.RxParams(num_channels=channels, audio_block=block)
        src = DeviceSceneSource(tones=SCENE, noise_rms=3e-4,
                                block=params.ddc.adc_block, device=device)
        return StreamEngine(params, src, device=device)
    # what run_block's S-meter reads on the two carrier lanes
    twin = engine()
    twin.set_channel(0, freq_hz=7.100e6, mode=demod.MODE_AM,
                     passband=(-4000.0, 4000.0))
    twin.set_channel(1, freq_hz=14.200e6, mode=demod.MODE_USB,
                     passband=(300.0, 2700.0))
    for _ in range(3):
        want_sm = twin.run_block().smeter_dbm[:2].cpu().numpy()
    del twin

    eng = engine()
    server = KiwiServer(eng, realtime=False, port=0)
    block_ms = eng.params.ddc.adc_block / eng.params.adc_clock * 1e3
    hz_per_start = UI_SRATE_30M / (WF_OUT_PX << MAX_ZOOM)

    def centred(zoom, cf=10.0e6):
        span = UI_SRATE_30M / (1 << zoom)
        return round((cf - span / 2) / hz_per_start)
    wf_zooms = {0: 0, 1: 7, 2: 13, 3: 14}       # listener -> zoom
    script = server_script(channels)
    snd: dict[int, Sock] = {}
    wfs: dict[int, Sock] = {}
    ext = Sock()
    late = Sock()
    info: dict = {}

    async def drive():
        loop = asyncio.get_running_loop()
        # the listeners are there before the first block, so that every
        # block of this run serves all of them
        for i, (_what, cmds) in enumerate(script):
            snd[i] = Sock()
            conn = await server.open_stream(f"c{i}", "SND", snd[i],
                                            "127.0.0.1")
            check(conn is not None and conn.rx_chan == i, f"listener {i}")
            for cmd in cmds:
                await conn.handle_set(cmd, "SND")
        for i, zoom in wf_zooms.items():
            wfs[i] = Sock()
            conn = await server.open_stream(f"c{i}", "W/F", wfs[i],
                                            "127.0.0.1")
            for cmd in ("SET auth t=kiwi p=",
                        f"SET zoom={zoom} start="
                        f"{0 if zoom == 0 else centred(zoom)}",
                        "SET wf_speed=4"):
                await conn.handle_set(cmd, "W/F")
        conn = await server.open_stream("c8", "EXT", ext, "127.0.0.1")
        await conn.handle_set("SET auth t=kiwi p=", "EXT")
        await conn.handle_set("SET ext_switch_to_client=S_meter "
                              "first_time=1", "EXT")
        # the counts of the server's run start here: nothing has run yet
        check(eng.seq == 0, "a block ran before the server was started")
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        runner = None
        if have_aiohttp:
            runner = await server.start()       # an ephemeral port
        else:
            server.start_tasks()
        # buckets up to 64 marked warm, as the entry point does at boot
        await run_server.prewarm(server, eng, 64)
        lags: list[float] = []

        async def lag_probe():
            while True:
                t = loop.time()
                await asyncio.sleep(0.005)
                lags.append(loop.time() - t - 0.005)
        probe = asyncio.create_task(lag_probe())

        async def wait_for(cond, what, timeout=120.0):
            t0 = time.monotonic()
            while not cond():
                await asyncio.sleep(0.002)
                check(time.monotonic() - t0 < timeout, f"timed out: {what}")
        await wait_for(lambda: min(len(s.of(b"SND")) for s in snd.values())
                       >= nblocks // 2, "half of the blocks")
        # a listener joins mid-run
        info["join_seq"] = eng.seq
        conn = await server.open_stream("late", "SND", late, "127.0.0.1")
        for cmd in script[3][1]:
            await conn.handle_set(cmd, "SND")
        await wait_for(lambda: late.of(b"SND"), "the late joiner's audio")
        info["late_blocks"] = eng.seq - info["join_seq"]
        real = None
        if have_aiohttp:
            # one real WebSocket client camps on listener 3's channel
            import aiohttp
            async with aiohttp.ClientSession() as http:
                ws = await http.ws_connect(
                    f"http://127.0.0.1:{server.port}/real/MON")
                for cmd in ("SET auth t=kiwi p=", "SET camp=3",
                            "SET compression=0", "SET little-endian"):
                    await ws.send_str(cmd)
                real = []
                while len(real) < 3:
                    m = await asyncio.wait_for(ws.receive(), 60)
                    check(m.type == aiohttp.WSMsgType.BINARY,
                          f"the WebSocket client got {m.type}")
                    if m.data[:3] == b"SND":
                        real.append(bytes(m.data))
                async with http.get(
                        f"http://127.0.0.1:{server.port}/status") as r:
                    info["status"] = await r.text()
                await ws.close()
        await wait_for(lambda: min(len(s.of(b"SND")) for s in snd.values())
                       >= nblocks, "all of the blocks")
        probe.cancel()
        info["launches"] = {k: fn.launches for k, fn in counters.items()}
        info["blocks"] = eng.seq
        info["starts"] = list(server.block_started)
        info["drops"] = sum(c.send_drops for c in server.conns.values())
        info["lags"] = lags
        info["real"] = real
        await server.stop()
        if runner is not None:
            await runner.cleanup()
        await asyncio.sleep(0.05)
    asyncio.run(drive())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches, blocks = info["launches"], info["blocks"]
    log(f"  aiohttp present: {have_aiohttp}; {blocks} blocks run, launches "
        f"{launches}")
    for k in ("stage2_rot", "agc_envelope", "sam_pll", "lms_chain"):
        check(launches[k] == blocks, f"kernel {k}: {launches[k]} launches in "
              f"{blocks} blocks of the server, not one a block")
    check(launches["stage2"] == 0, "the server's path is the fused one")
    check(info["drops"] == 0, f"{info['drops']} packets were dropped")

    # every header parses, no sequence gap
    fs = eng.params.fs_out
    for i, sock in snd.items():
        pkts = [parse_snd(p) for p in sock.of(b"SND")]
        check(len(pkts) >= nblocks, f"listener {i}: {len(pkts)} packets")
        seqs = [p[1] for p in pkts]
        check(seqs == list(range(len(seqs))), f"listener {i}: sequence "
              f"numbers {seqs}")
        want_flags = {"am adpcm": packets.SND_FLAG_COMPRESSED, "am s16": 0,
                      "usb s16": packets.SND_FLAG_LITTLE_ENDIAN,
                      "iq": packets.SND_FLAG_MODE_IQ}.get(script[i][0])
        if want_flags is not None:
            check(all(p[0] == want_flags for p in pkts),
                  f"listener {i} ({script[i][0]}): flags {pkts[0][0]:#x}")
    import struct
    iq_secs = [struct.unpack("<BBII", parse_snd(p)[3])[2:]
               for p in snd[4].of(b"SND")]
    check(iq_secs == sorted(iq_secs) and iq_secs[-1] > iq_secs[0],
          f"the IQ header's time does not advance: {iq_secs[:3]}")
    heard = {}
    for i in (0, 1, 2, 3, 5, 7):
        a = snd_audio(snd[i])
        check(len(a) >= nblocks * block and bool(np.isfinite(a).all()),
              f"listener {i}: audio")
        heard[i] = dominant_hz(a[len(a) // 4:], fs)
    resolution = fs / (nblocks * block * 3 // 4)
    log(f"  heard, Hz: AM adpcm {heard[0]:.1f}, AM s16 {heard[1]:.1f}, USB "
        f"adpcm {heard[2]:.1f}, USB s16 {heard[3]:.1f}, SAM {heard[5]:.1f}, "
        f"spectral-NR lane {heard[7]:.1f}")
    for i, want in ((0, 1000.0), (1, 1000.0), (2, 1800.0), (3, 1800.0),
                    (5, 1000.0), (7, 1000.0)):
        check(abs(heard[i] - want) <= 2 * resolution + 5,
              f"listener {i} ({script[i][0]}) hears {heard[i]} Hz")
    lms_audio = snd_audio(snd[6])
    check(bool(np.isfinite(lms_audio).all()), "the LMS lane's audio")
    sm_am = parse_snd(snd[1].of(b"SND")[-1])[2]
    sm_usb = parse_snd(snd[3].of(b"SND")[-1])[2]
    log(f"  S-meter field dBm: AM {sm_am:.1f} (run_block {want_sm[0]:.2f}), "
        f"USB {sm_usb:.1f} (run_block {want_sm[1]:.2f})")
    check(abs(sm_am - want_sm[0]) <= 1.0 and abs(sm_usb - want_sm[1]) <= 1.0,
          "the S-meter field is not within 1 dB of run_block's")
    ext_msgs = ext.of(b"EXT smeter ")
    check(ext.of(b"EXT ready") and len(ext_msgs) >= nblocks - 1,
          f"the S-meter extension sent {len(ext_msgs)} readings")
    ext_dbm, = struct.unpack("<f", ext_msgs[-1][11:15])
    check(abs(ext_dbm - want_sm[0]) <= 1.0, f"extension reads {ext_dbm}")

    # the waterfall at every zoom
    z0_px = None
    for i, zoom in wf_zooms.items():
        rows = wf_rows(wfs[i])
        check(len(rows) >= nblocks // 2, f"z{zoom}: {len(rows)} rows")
        check(all(z == zoom for z, _s, _r in rows)
              and [s for _z, s, _r in rows] == list(range(len(rows))),
              f"z{zoom}: zoom or sequence numbers")
        row = rows[-1][2].astype(np.float64)
        if zoom == 0:
            want_px = sorted(round(f / UI_SRATE_30M * WF_OUT_PX)
                             for f in WF_CARRIERS_HZ)
            z0_px = strongest_peaks(row, 3)
            check(all(abs(g - w) <= 1 for g, w in zip(z0_px, want_px)),
                  f"z0 peaks {z0_px} are not at the carriers {want_px}")
        else:
            px = int(np.argmax(row))
            check(abs(px - WF_OUT_PX // 2) <= 1 and row[px] > np.median(row)
                  + 30, f"z{zoom} peak at pixel {px}")
    log(f"  W/F rows: {[len(wf_rows(wfs[i])) for i in wf_zooms]} at zooms "
        f"{list(wf_zooms.values())}; z0 peaks at pixels {z0_px}")

    # the late joiner and the real client
    log(f"  the late joiner's first audio came {info['late_blocks']} blocks "
        "after it joined")
    check(info["late_blocks"] <= 3, "the late joiner waited more than the "
          "pipeline's two blocks and the one that was running")
    if info["real"] is not None:
        own = {parse_snd(p)[4]: parse_snd(p)[2] for p in snd[3].of(b"SND")}
        first = parse_snd(info["real"][0])
        check(first[4] in own and own[first[4]] == first[2]
              and first[0] == packets.SND_FLAG_LITTLE_ENDIAN,
              "the WebSocket client's first SND packet is not the one an "
              "in-process socket got on that channel")
        check("users=34" in info["status"] and "sdr_hw=NVIDIA" in
              info["status"], f"/status: {info['status']!r}")
        log("  a real WebSocket client on an ephemeral port got the same "
            "first SND packet as the in-process socket on its channel; "
            "/status answered")

    starts = np.diff(np.asarray(info["starts"])) * 1e3
    steady = starts[2:]                         # past the first blocks
    lags = np.asarray(info["lags"]) * 1e3
    return dict(
        launches=launches, blocks=blocks, aiohttp=have_aiohttp,
        ms_blocks=[float(v) for v in starts],
        ms_median=float(np.median(steady)), ms_min=float(steady.min()),
        ms_max=float(steady.max()),
        realtime_factor=float(len(steady) * block_ms / steady.sum()),
        block_period_ms=block_ms, peak_mem_gb=peak_gb,
        encode_ms_per_block=server.encode_s / server.blocks_fanned * 1e3,
        fanout_ms_per_block=server.fanout_s / server.blocks_fanned * 1e3,
        loop_lag_ms=dict(mean=float(lags.mean()), p99=float(
            np.percentile(lags, 99)), max=float(lags.max()), n=len(lags)),
        late_blocks=info["late_blocks"], heard_hz=heard,
        smeter_field_dbm=[sm_am, sm_usb],
        smeter_run_block_dbm=[float(v) for v in want_sm])


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
        log(f"  {name:<13} kernel {r['ms']:.4f} ms ({r['ms_host_paced']:.4f} "
            f"host-paced), plain {r['plain_ms']:.3f}"
            f" ms, {lib}; bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
            f"(bytes {r['bound_bytes_ms']:.4f}, operations "
            f"{r['bound_ops_ms']:.4f}), share of bound "
            f"{r['share_of_bound']:.3f}  [{card}]")
        # a kernel cannot beat its bound: a share over 1 is a timing fault
        check(r["share_of_bound"] <= 1.05,
              f"{name}: {r['ms']} ms is under its bound {r['bound_ms']} ms")
    lms = kern["lms_chain"]
    log(f"  lms_chain (the row above: every stage on) by enables, ms: "
        f"{lms['ms_by_enables']}; bounds of what the function needs, ms: "
        f"{lms['bound_ms_by_enables']}  [{card}]")
    for name, ms in lms["ms_by_enables"].items():
        check(lms["bound_ms_by_enables"][name] / ms <= 1.05,
              f"lms_chain {name} is under its bound")
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
    log("phase 4: the serving path, C=4096, audio_block=2048, buckets 32 "
        "and 64, four waterfall slots")
    sv = phase_serve(torch, device, timer, channels=4096, block=2048,
                     profile=profile)
    log(f"  served block (run_block_gather + 4 waterfall ingests and rows + "
        f"fetch): median {sv['ms_median']} ms, min {sv['ms_min']}, max "
        f"{sv['ms_max']}; realtime factor {sv['realtime_factor']} (signal "
        f"time / wall time of the steady served blocks); peak memory "
        f"{sv['peak_mem_gb']} GB  [{card}]")
    log(f"  per-block ms: {[round(v, 2) for v in sv['ms_blocks']]}")
    log(f"  alone: wf ingest ms by zoom {sv['wf_ingest_ms']} (z14 takes two "
        f"blocks), wf frame {sv['wf_frame_ms']:.4f} ms, spectral-NR loop "
        f"{sv['spectral_nr_ms']:.3f} ms, fetch of a bucket-32 array "
        f"{sv['fetch_ms_bucket32']:.4f} ms; bytes fetched a block "
        f"{sv['bytes_fetched']}  [{card}]")
    log(f"  served block without waterfall, ms: NR lanes on "
        f"{[round(v, 2) for v in sv['served_ms_nr_on']]}, LMS lane off "
        f"{[round(v, 2) for v in sv['served_ms_lms_off']]}, all NR off "
        f"{[round(v, 2) for v in sv['served_ms_nr_off']]}, LMS on for every "
        f"channel {[round(v, 2) for v in sv['served_ms_lms_every_channel']]}"
        f"  [{card}]")
    if sv["profile"]:
        log(sv["profile"])
    log("phase 5: the server, C=4096, audio_block=2048, 32 listeners and "
        "four waterfall sockets over the KiwiSDR protocol")
    sr = phase_server(torch, device, channels=4096, block=2048)
    log(f"  served by the server: per block median {sr['ms_median']} ms, min "
        f"{sr['ms_min']}, max {sr['ms_max']} (block start to block start, "
        f"after 2 blocks); realtime factor {sr['realtime_factor']} with the "
        f"server in the loop; peak memory {sr['peak_mem_gb']} GB  [{card}]")
    log(f"  per-block ms: {[round(v, 2) for v in sr['ms_blocks']]}")
    log(f"  host ms a block: encode {sr['encode_ms_per_block']:.3f}, fan-out "
        f"(framing, queues, extension, waterfall rows) "
        f"{sr['fanout_ms_per_block']:.3f}; what the event loop loses: a "
        f"5 ms sleep came back late by mean {sr['loop_lag_ms']['mean']:.3f} "
        f"ms, p99 {sr['loop_lag_ms']['p99']:.3f}, max "
        f"{sr['loop_lag_ms']['max']:.3f} ({sr['loop_lag_ms']['n']} sleeps); "
        f"aiohttp present: {sr['aiohttp']}  [{card}]")
    check(sr["realtime_factor"] >= 1.0, "the server does not hold real time")
    summary = dict(card=card, build_s=_build.build_seconds, ddc=ddc,
                   server=sr,
                   slice={k: v for k, v in sl.items() if k != "profile"},
                   serve={k: v for k, v in sv.items() if k != "profile"},
                   kernels=kern)
    out_dir = HERE / "build"                # listed in .gitignore
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(summary, indent=1))

    log(card)
    log(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=f"{PKG}/{src}",
             replaces=replaces,
             launches=sl["launches"].get(name, 0) + sv["launches"][name]
             + sr["launches"][name],
             launches_slice=sl["launches"].get(name, 0),
             launches_serve=sv["launches"][name],
             launches_server=sr["launches"][name],
             launches_per_block=sl["launches_per_block"].get(
                 name, sv["launches"][name] / sv["blocks"]),
             launches_per_block_unfused=sl[
                 "launches_per_block_unfused"].get(name),
             max_abs_err=kern[name]["max_abs_err"], ms=kern[name]["ms"],
             ms_host_paced=kern[name]["ms_host_paced"],
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
