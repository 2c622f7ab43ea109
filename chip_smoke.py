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
   off and one lane on; the GPS tracking bank (kernel 6) on the 12 rows
   a cold search of the ``run_server --gps`` sky leaves (C/A and E1B rows,
   one C/A row dropped to make an inactive row), 40 epochs compared with
   its plain version, 400 (one 0.4 s chunk) timed; the spectral-NR
   recurrences (kernel 7) on the spectra of two chained blocks of (2048,
   4096) audio, both gain rules, every element of every state field
   compared.  Times each kernel
   twice (with the card kept busy before the timed calls, ``ms``, and
   without, ``ms_host_paced``) and its plain version, and for kernel 2
   one library call (``conv1d``) that computes the same function.  Each
   kernel's time is held against its bound: the larger of its bytes
   (every input and output once) over 3.35 TB/s and the operations the
   function needs over 67 TFLOP/s (the H100 SXM's published float32
   peak).
2. DDC fidelity: a noise-free full-scale tone through ``ddc_block`` —
   right frequency, amplitude ~1.0, SINAD >= 80 dB (a stage-1 matmul
   that quietly ran in TF32 would fail this).
3. The slice: ``StreamEngine`` at C=4096, audio_block=2048, fed by a
   ``DeviceSceneSource`` (AM 7.100 MHz with 1 kHz, a tone at 14.2018
   MHz, a carrier at 10.000 MHz, noise 3e-4 rms): an AM channel must hear
   1000 Hz, a USB channel 1800 Hz, empty channels stay quiet, S-meters
   plausible, every tap finite; 8 fused blocks and 2 unfused blocks,
   with the launch counters of kernels 1-4 shown to rise in that run.
3b. The 20.25 kHz family (rx3.wf3's rate: d1=1543, d2=4, fs_out = 125
   MHz / 6172) through the whole chain at C=4096, audio_block=2048, on
   the same scene: 2 warm-up and 6 timed blocks; an AM lane on 7.100
   MHz hears 1000 Hz, a USB lane on 14.1946 MHz (passband 200-9000 Hz)
   hears the 14.2018 MHz tone at 7200 Hz, every tap finite, kernels 1,
   3 and 4 launched once a block.  Then ``RxParams.from_config(rx3.wf3)``
   at its 3 channels for 4 blocks, the same tones.
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
   Then the same server with ``autorun=["wspr:14095.6", "FT8:14074"]``
   beside the listeners for 88 blocks (an FT8 capture completes in the
   80th), and again without autorun for 88 blocks: the units claim idle
   channels tuned in USB, each unit's capture grows by a block every
   block (or completes), ``/status`` says ``autorun=2``, every gate above
   holds; prints both factors, the autorun host ms a block and the
   block in which the FT8 capture completed beside its neighbours.

6a. GPS alone at full width: the ``run_server --gps`` sky (the GPS
   satellites above 15 degrees of 8 asked for, the decoy PRNs 3, 7 and
   30, 4 Galileo E1B satellites, +0.4 ppm, noise 0.9) synthesized on the
   card, a 12-row ``GpsManager`` from a cold start, driven by
   ``GpsReceiver.run`` in 0.4 s chunks until a fix and a locked clock (at
   most 40 s of IF).  Checks: every satellite of the sky tracked, no
   decoy, a fix within 60 m (the manager's single-point solution from
   every satellite with an ephemeris; the EKF's error is printed beside
   it), the clock within 0.15 ppm of +0.4, kernel 6 launched, no service
   error.  Prints ms a chunk of the scene, of a
   chunk with and without a search, of a solve, and IF time over wall
   time.
6b. Phase 5's server and traffic again, 24 blocks, with that receiver
   (a new, cold one, paced at real time) beside it: the realtime factor
   beside phase 5's, GPS chunks processed, rows tracking, the ADMIN
   socket's ``gps`` reply.  Fails under a factor of 1.0 or with no
   satellite tracked.
7. The decoders' front ends on the card: a 114 s WSPR transmission
   (K1ABC FN42 37, tone 0 at 1520 Hz), a 13.5 s FT8 and a 6.5 s FT4
   one (CQ K1ABC FN42), synthesized on the host from the copied encoders
   in noise at the SNRs of the decoders' own tests, each streamed
   through (2048, 4096) device taps to its extension, which must decode
   it; the peak device memory of each capture (under 1 GB: no tap kept);
   the recorded off-air WSPR capture (``tests/data/wspr_offair_375.npz``)
   through the host path must give ZL3DMH RE66 37; the FFT extension's
   row peaks at a test tone's bin; each front end timed alone.
8a. The host-only decoders through device taps: each of FSK ("CQ DX" at
   45.45 Bd / 170 Hz), NAVTEX ("NAV WARNING 42"), timecode (a DCF77
   minute, "2024-03-02 09:05"), FAX (a stripe pattern), SSTV (a Martin M1
   round trip), Loran-C (GRI 6731 folded, and found by a search), ALE 2G
   (three words in noise), STANAG 4285 (100 bits at 600 bps), HFDL (an
   MPDU at 1200 bps) and DRM (FAC, SDC and MSC from ``DrmTx``, in the
   post-AGC IQ tap) gets the signal its reference test synthesizes,
   streamed through (2048, 4096) taps on the card, a new tap tensor a
   block, and must decode what that test asserts.  Prints each
   decoder's host ms a block (median) and the ms of the block that
   completed its message.
8b. NAVTEX end to end: phase 5's scene plus one NAVTEX emitter 1000 Hz
   above 518 kHz (the source's FSK tone: 100 Bd, 170 Hz shift, the bits
   of "NAV WARNING 42"'s SITOR-B stream, then idle) through ``rx_block``
   (kernels 1, 3, 4) and a ``KiwiServer`` at C=4096; one SND client tuned
   to 518.000 kHz USB with ``SET ext_switch_to_client=NAVTEX
   center=1000`` on its EXT socket.  The text must arrive on the EXT
   socket within 30 blocks, with kernels 1, 3 and 4 launched once a
   block; prints the launch counts, the server's realtime factor over
   those blocks and the extension's host ms a block.

9a. The multi-device engine: a ``ShardedStreamEngine`` over a (2, 2)
   (time, chan) mesh of the one card repeated, at C=4096,
   audio_block=2048, on phase 3's scene and tuning, 8 blocks with a SET
   (channel 1 to LSB on 14.2036 MHz) before the 4th and the GPS clock's
   ``retune_all`` (+0.4 ppm) before the 6th; then the unfused
   single-device engine on the same blocks and events.  Checks: iq within
   1e-5, audio within 3e-3, S-meter within 0.1 dB of it (the reference's
   bounds, ``tests/test_parallel.py``); kernels 2, 3 and 4 launched four
   times a block (once a shard), 1, 5 and 7 not at all; the AM lane hears
   1000 Hz and the retuned LSB lane 1800 Hz.  Prints the block times and
   realtime factor beside phase 3's, the peak memory and one SET's ms;
   with ``--profile`` the summed kernel time and kernel count of one mesh
   block and of one fused single-device block.
9b. The mesh engine's serving path: two such engines on phase 3's scene
   for 6 blocks, with phase 9a's SET and ``retune_all``; each block that
   one serves (``run_block_gather``, after a ``prewarm_gather`` that must
   move nothing) must equal the other's ``run_block`` taps packed by
   ``pack_columns``, to the bit.  Then a ``KiwiServer`` over a mesh
   engine, served through that gather: four SND listeners (USB on
   14200.00 kHz, which must hear the 14.2018 MHz tone at 1800 +- 40 Hz,
   AM, LSB, IQ) and one W/F socket, whose z0 row must peak on the
   carriers; kernels 2, 3, 4 four times a block; the bucket served (4)
   warm.  Then ``run_server --mesh time=1,chan=1``
   must build on the card, and ``--mesh time=2,chan=2`` on a host without
   four cards must end naming the card count.
9c. Stage 2 by FFT correlation: ``RxParams(stage2="fft")``'s slice
   within 1e-4 of the unfused slice (kernel 2) on 2 blocks; phase 2's
   tone through the FFT method at >= 80 dB SINAD.  (Phase 1 times
   ``channelizer.stage2_fft`` as a second library call in kernel 2's row,
   with the memory it takes.)
9d. ``noise.lms_block`` in both modes through kernel 5 at (2048, 4096),
   within 1e-4 of the output's scale of its plain version.

10. The compiled step: phases 3 to 8b run on the engine's default on the
   card, the compiled step (CUDA graphs, a graph per program and gate
   tuple, replayed).  (a) It against the eager engine (``use_graphs=
   False``) from one state and one source at C=4096, audio_block=2048
   for 24 blocks, with a SET that opens each gate (a SAS lane, the LMS
   notch, spectral NR, NB_WILD) and later closes three of them, the GPS
   clock's ``retune_all`` and a ``load_state``: taps and state equal to
   the bit in every block, the same launches a block.  Prints each
   engine's median block wall, host and device ms, the graphs captured
   with each key's capture ms, the memory above the eager engine, and
   the kernels, copies and fills of one eager block, of its back half
   and of one replayed block (torch.profiler).  (b) Serving: bucket 16,
   then 32, prepared by ``prewarm_gather`` on a thread while blocks are
   served; every result equal to the eager engine's, no served block
   over the block period, the first bucket-32 block a replay.

11. The other compiled programs, each a CUDA graph over buffers its
   owner keeps, against an eager instance of itself side by side on the
   same inputs, at C=4096, audio_block=2048 (phases 3-10 run on them: the
   card's default): (a) the scene source (phase 3's scene, phase 4's
   4-FSK emitter, phase 8b's NAVTEX emitter, noise) for 8 blocks, then
   the compiled block over an eager and over a compiled source (host ms
   a block against the eager source's); (b) the waterfall, four slots (z0, z7,
   z13, z14 of two blocks an ingest) fed the engine's blocks, a mask
   change, rows equal, then a short phase-5 run for its fan-out ms; (c)
   the GPS sky of phase 6a and a 12-row tracking step with its pack,
   five 0.4 s chunks with noise 0 and with noise at the same generator
   state; (d) the mesh step on phase 9a's (2, 2) mesh of the card (one
   graph a block) for 8 blocks through a SET and ``retune_all``.  Each
   equal to the bit; prints wall, host and device ms, capture ms and the
   memory above the eager instance.

Kernel 7's launch count is read around phases 3 to 6b and must be one a
block in 4, 5 and 6b, where a lane has spectral NR on.  On the compiled
engine a key's first block runs eagerly and each replay credits the
launches its capture recorded; the launches of ``prewarm_gather``'s
warm-ups on scratch buffers (at the server's boot) are counted beside
the blocks'.  ``--profile``
also prints kernel 6's clock64 split of an epoch (``csrc/gps_track.cu``
built again with ``-DGPS_TRACK_CLOCKS`` and launched through
``track_epochs``).

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
import types
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
    "gps_track": ("csrc/gps_track.cu",
                  "flydog_sdr_gps_tpu/models/gps/tracking.py:330"),
    "spectral_nr": ("csrc/spectral_nr.cu",
                    "flydog_sdr_gps_tpu/ops/noise.py:150 and :172"),
}
# phase 5 with autorun: an FT8 capture (13.5 s) completes in the 80th block
# of 170.656 ms; a few more show the blocks after it
AUTORUN_BLOCKS = 88
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
                    out[kname].update(stage2_fft_library(
                        torch, timer, plan, y, ref))
            del got, ref
        del y

    plan12 = make_ddc_plan(audio_block=block)
    plan20 = make_ddc_plan(snd_rate=20_250, audio_block=block)
    stage2_case(plan12, c_main, f"12k C={c_main}", True)
    stage2_case(plan20, c_main, f"20.25k C={c_main}", False)
    for c in small_cs:
        stage2_case(plan12, c, f"12k C={c}", False)

    # phase 9's shapes: a MESH shard gives kernel 2 k1/T + tail2 rows of
    # C/K channels (an odd row count), kernels 3 and 4 a block of C/(T*K)
    # channels; held to the bounds above
    t_sz, k_sz = MESH
    c_grp = c_main // (t_sz * k_sz)

    def mesh_shard(kname, shape, err, bound):
        log(f"  {kname:<10} mesh shard {tuple(shape)} max|err| {err:.3e} "
            f"(bound {bound:.3e})")
        check(err <= bound, f"{kname} mesh shard {tuple(shape)}: {err} > "
              f"{bound}")
        out[kname]["mesh_shard"] = dict(shape=list(shape), max_abs_err=err,
                                        bound=bound)

    y = torch.complex(
        torch.randn((plan12.k1 // t_sz + plan12.tail2, c_main // k_sz),
                    generator=gen, device=device),
        torch.randn((plan12.k1 // t_sz + plan12.tail2, c_main // k_sz),
                    generator=gen, device=device))
    k2 = plan12.audio_block // t_sz
    got = kernels.stage2(y, plan12.h2, plan12.d2, k2)
    ref = kernels.stage2_plain(y, plan12.h2, plan12.d2, k2)
    check(tuple(got.shape) == (k2, c_main // k_sz), "stage2 mesh shard shape")
    mesh_shard("stage2", y.shape, max_err(got, ref)[0], 1e-4)
    del y, got, ref

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
    part = mag_db[:, :c_grp].contiguous()
    (g_seq, g_env, g_hang), (r_seq, r_env, r_hang) = (
        agc.envelope_scan(params, part, env0[:c_grp], hang0[:c_grp]),
        agc.envelope_scan_plain(params, part, env0[:c_grp], hang0[:c_grp]))
    err, scale = max_err(g_seq, r_seq)
    check(max_err(g_env, r_env)[0] <= 1e-4 * scale
          and bool(torch.equal(g_hang, r_hang)), "agc mesh shard state")
    mesh_shard("agc_envelope", part.shape, err, 1e-4 * scale)
    del part, g_seq, r_seq

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
    part = z[:, :c_grp].contiguous()      # the special lanes lie in it
    (g_v, g_ph, g_fr), (r_v, r_ph, r_fr) = (
        demod.sam_pll(sam, part, ph0[:c_grp], fr0[:c_grp]),
        demod.sam_pll_plain(sam, part, ph0[:c_grp], fr0[:c_grp]))
    err, scale = max_err_finite(torch, g_v, r_v, "sam pll v, mesh shard")
    check(max_err_finite(torch, g_fr, r_fr, "sam freq, mesh shard")[0]
          <= 1e-4 * float(sam.fmax)
          and max_err_finite(torch, g_ph, r_ph, "sam phase, mesh shard")[0]
          <= 1e-4 * math.pi, "sam pll mesh shard state")
    mesh_shard("sam_pll", part.shape, err, 1e-4 * scale)
    del z, part, g_v, r_v

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


def spectral_nr_case(torch, timer, device, c_main: int, block: int) -> dict:
    """Kernel 7 against its plain version at the main path's shape: the
    one-sided spectra (16, 129, c_main) of two chained blocks of audio
    (a tone a channel in noise, the tone off in the first block), framed
    as ``spectral_nr_block`` frames them, in ``torch.fft``'s layout; both
    gain rules, each version carrying its own state from block to
    block.  Every element of every field is held to 1e-6 of the plain
    version's, relative (the kernel rounds each operation as PyTorch
    does).  The row is the served rule, "subtract"."""
    from flydog_sdr_gps_tpu_torch.ops import noise
    gen = torch.Generator(device=device)
    gen.manual_seed(77)
    f = torch.empty((1, c_main), device=device).uniform_(0.05, 1.0,
                                                         generator=gen)
    rows = {}
    for rule in ("subtract", "mmse"):
        p = noise.SpectralNRParams(gain_rule=rule)
        hop, fft = p.hop, p.fft_size
        win = torch.as_tensor(np.hanning(fft + 1)[:fft].astype(np.float32),
                              device=device)
        st_k = noise.init_spectral_nr(p, c_main, device)
        st_p = noise.init_spectral_nr(p, c_main, device)
        errs = {}
        for blk in range(2):
            t = torch.arange(block + hop, device=device,
                             dtype=torch.float32)[:, None] + blk * block
            x = 0.3 * blk * torch.sin(f * t) + 0.1 * torch.randn(
                (block + hop, c_main), generator=gen, device=device)
            spec = torch.fft.fft(x.unfold(0, fft, hop).transpose(1, 2)
                                 * win[None, :, None], dim=1)[:, :fft // 2 + 1]
            got = noise.spectral_nr_gains(p, spec, st_k)
            ref = noise.spectral_nr_gains_plain(p, spec, st_p)
            for name, a, b in zip(("spec_g", "psd_smooth", "min_ring",
                                   "xhat2"), got, ref):
                err = float((a - b).abs().max())
                rel = float(((a - b).abs() / b.abs()).nan_to_num(0.0).max())
                check(bool(((a - b).abs() <= 1e-6 * b.abs()).all()),
                      f"spectral_nr {rule} block {blk} {name}: an element "
                      f"off by {rel} of its plain value > 1e-6")
                e0, r0 = errs.get(name, (0.0, 0.0))
                errs[name] = (max(e0, err), max(r0, rel))
            st_k = dataclasses.replace(st_k, psd_smooth=got[1],
                                       min_ring=got[2], xhat2=got[3])
            st_p = dataclasses.replace(st_p, psd_smooth=ref[1],
                                       min_ring=ref[2], xhat2=ref[3])
        log(f"  spectral_nr {rule:<8} {tuple(spec.shape)}, 2 chained blocks: "
            "max|err| (max relative err) " + ", ".join(
                f"{k} {e:.3e} ({r:.3e})" for k, (e, r) in errs.items())
            + " (bound 1e-6 relative, each element)")
        mmse = rule == "mmse"
        fn = lambda: noise.spectral_nr_gains(p, spec, st_k)
        plain = lambda: noise.spectral_nr_gains_plain(p, spec, st_k)
        # the spectrum in and out; the ring's min_window - 1 newest planes
        # in (the oldest is dropped unread) and min_window planes out; the
        # EMA and (mmse) xhat2 in and out; a frame, bin and channel: |X|^2 3, the EMA 3, the
        # minimum 1, X * g 2, and the gain 6 (subtract: product, division,
        # subtraction, two clamps, sqrt) or 36 (mmse: 9 for xi, 5 for v,
        # 14 for E1 with its log or exp, 5 for g, 3 for xhat2)
        mw = st_k.min_ring.shape[0]
        nbytes = 2 * spec.numel() * 8 \
            + (2 * mw - 1) * st_k.min_ring[0].numel() * 4 \
            + 2 * st_k.psd_smooth.numel() * 4 \
            + (2 * st_k.xhat2.numel() * 4 if mmse else 0)
        flops = (9.0 + (36.0 if mmse else 6.0)) * spec.numel()
        rows[rule] = dict(
            max_abs_err=max(e for e, _ in errs.values()),
            errors={k: dict(max_abs_err=e, max_rel_err=r)
                    for k, (e, r) in errs.items()},
            **timer.both(fn, reps=20), plain_ms=timer(plain, reps=3),
            library_ms=None, **roofline(nbytes, flops))
    timer.release()
    row = rows["subtract"]
    row["mmse"] = rows["mmse"]
    return row


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


def make_engine(torch, device, channels: int, block: int, stage2: str,
                use_graphs: bool | None = None):
    """Phase 3's engine; ``use_graphs`` None is the engine's default (the
    compiled step on the card)."""
    from flydog_sdr_gps_tpu_torch.models import rx_channel as rx
    from flydog_sdr_gps_tpu_torch.runtime import (DeviceSceneSource,
                                                  StreamEngine)
    params = rx.RxParams(num_channels=channels, audio_block=block,
                         stage2=stage2)
    src = DeviceSceneSource(tones=SCENE, noise_rms=3e-4,
                            block=params.ddc.adc_block, device=device)
    return tune_slice(StreamEngine(params, src, device=device,
                                   use_graphs=use_graphs))


def tune_slice(eng):
    """Phase 3's tuning: AM on 7.100 MHz, USB on 14.200 MHz, four USB
    lanes on empty spectrum."""
    from flydog_sdr_gps_tpu_torch.ops import demod
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
    from flydog_sdr_gps_tpu_torch.ops import agc, demod, kernels, noise
    counters = {"stage2_rot": kernels.stage2_rot, "stage2": kernels.stage2,
                "agc_envelope": agc.envelope_scan, "sam_pll": demod.sam_pll,
                "spectral_nr": noise.spectral_nr_gains}

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
        if k != "spectral_nr":
            check(n > 0, f"kernel {k} was not launched by the main path")
    # no lane of the slice has spectral NR on: its gate keeps kernel 7 off
    check(launches["spectral_nr"] == 0, "kernel 7 ran with spectral NR off")
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


def phase_slice_20k(torch, device, channels: int, block: int,
                    warmup: int = 2, timed: int = 6,
                    small_blocks: int = 4) -> dict:
    """Phase 3b: the 20.25 kHz family (rx3.wf3's rate, d2=4) through the
    whole chain at full width, then ``RxParams.from_config(rx3.wf3)`` at
    its own 3 channels.  An AM lane on 7.100 MHz hears 1000 Hz; a USB
    lane on 14.1946 MHz (passband 200-9000 Hz) hears the 14.2018 MHz
    tone at 7200 Hz, which the 12 kHz family cannot pass."""
    from flydog_sdr_gps_tpu_torch.models import rx_channel as rx
    from flydog_sdr_gps_tpu_torch.numerology import ADC_CLOCK_NOM, CONFIGS
    from flydog_sdr_gps_tpu_torch.ops import agc, demod, kernels, noise
    from flydog_sdr_gps_tpu_torch.runtime import (DeviceSceneSource,
                                                  StreamEngine)
    counters = {"stage2_rot": kernels.stage2_rot, "stage2": kernels.stage2,
                "agc_envelope": agc.envelope_scan, "sam_pll": demod.sam_pll,
                "spectral_nr": noise.spectral_nr_gains}
    cfg = CONFIGS["rx3.wf3"]

    def engine(params):
        src = DeviceSceneSource(tones=SCENE, noise_rms=3e-4,
                                block=params.ddc.adc_block, device=device)
        eng = StreamEngine(params, src, device=device)
        eng.set_channel(0, freq_hz=7.100e6, mode=demod.MODE_AM, in_use=True)
        eng.set_channel(1, freq_hz=14.1946e6, mode=demod.MODE_USB,
                        in_use=True, passband=(200.0, 9000.0))
        return eng

    def heard(rows, fs, what):
        audio = np.concatenate(rows)[block:]      # past the first block
        f_am = dominant_hz(audio[:, 0], fs)
        f_usb = dominant_hz(audio[:, 1], fs)
        log(f"  {what}: AM 7.100 MHz hears {f_am:.1f} Hz, USB 14.1946 MHz "
            f"hears {f_usb:.1f} Hz (the 14.2018 MHz tone at +7200 Hz)")
        res = fs / len(audio)
        check(abs(f_am - 1000.0) <= 2 * res + 5, f"{what}: AM hears {f_am}")
        check(abs(f_usb - 7200.0) <= 40.0, f"{what}: USB hears {f_usb}")
        return f_am, f_usb

    params = rx.RxParams(num_channels=channels, snd_rate=cfg.snd_rate,
                         audio_block=block)
    check(abs(params.fs_out - ADC_CLOCK_NOM / 6172) < 1e-9,
          f"fs_out {params.fs_out} is not 125 MHz / 6172")
    check((params.ddc.d1, params.ddc.d2) == (1543, 4),
          f"decimation {params.ddc.decims}")
    eng = engine(params)
    for fn in counters.values():
        fn.launches = 0                     # the main path's run starts
    rows, ms = [], []
    for i in range(warmup + timed):
        t0 = time.perf_counter()
        taps = eng.run_block()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        for name in ("audio", "audio2", "iq_pre_fir", "iq_post_agc",
                     "smeter_dbm"):
            check(bool(torch.isfinite(getattr(taps, name)).all()),
                  f"phase 3b: non-finite {name}")
        rows.append(taps.audio[:, :2].cpu().numpy())
    launches = {k: fn.launches for k, fn in counters.items()}
    nblk = warmup + timed                   # the main path's run ends
    log(f"  launches in the run: {launches} in {nblk} blocks")
    for k in ("stage2_rot", "agc_envelope", "sam_pll"):
        check(launches[k] == nblk, f"phase 3b: kernel {k} launched "
              f"{launches[k]} times in {nblk} blocks")
    check(launches["stage2"] == 0 and launches["spectral_nr"] == 0,
          "phase 3b: the unfused stage 2 or kernel 7 ran")
    fs = params.fs_out
    f_am, f_usb = heard(rows, fs, f"C={channels}")
    block_ms = params.ddc.adc_block / params.adc_clock * 1e3
    steady = ms[warmup:]
    del eng, taps
    # the firmware configuration itself, at its 3 channels
    small = rx.RxParams.from_config(cfg, audio_block=block)
    check(small.num_channels == 3 and small.fs_out == fs,
          "from_config(rx3.wf3)")
    eng = engine(small)
    rows_small = [eng.run_block().audio[:, :2].cpu().numpy()
                  for _ in range(small_blocks)]
    small_heard = heard(rows_small, fs, "from_config(rx3.wf3), C=3")
    return dict(launches=launches, fs_out=fs, adc_block=params.ddc.adc_block,
                am_hz=f_am, usb_hz=f_usb, small_heard_hz=small_heard,
                ms_blocks=ms, ms_median=statistics.median(steady),
                ms_min=min(steady), ms_max=max(steady),
                realtime_factor=len(steady) * block_ms / sum(steady),
                block_period_ms=block_ms)


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


def make_serve_engine(torch, device, channels: int, block: int,
                      use_graphs: bool | None = None):
    from flydog_sdr_gps_tpu_torch.models import rx_channel as rx
    from flydog_sdr_gps_tpu_torch.ops import demod
    from flydog_sdr_gps_tpu_torch.runtime import (DeviceSceneSource,
                                                  StreamEngine)
    params = rx.RxParams(num_channels=channels, audio_block=block)
    symbols = np.random.default_rng(162).integers(0, 4, 162).tolist()
    scene = SCENE + [FSK_TONE + (("fsk", 8192, 12000 / 8192, symbols, 200),)]
    src = DeviceSceneSource(tones=scene, noise_rms=3e-4,
                            block=params.ddc.adc_block, device=device)
    eng = StreamEngine(params, src, device=device, use_graphs=use_graphs)
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
                "lms_chain": noise.lms_chain_block,
                "spectral_nr": noise.spectral_nr_gains}

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
        # the block's stream, not the device: while prewarm_gather's
        # thread captures, CUDA refuses a device-wide synchronize (it
        # would wait on the capturing stream) and the capture fails
        torch.cuda.current_stream().synchronize()
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
    for k in ("stage2_rot", "agc_envelope", "sam_pll", "lms_chain",
              "spectral_nr"):
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


class AdminSock(Sock):
    """An in-process ADMIN socket: yields the given commands as the text
    messages the server's ADMIN loop reads (its types come from aiohttp),
    and records the replies."""

    def __init__(self, cmds):
        super().__init__()
        self.cmds = list(cmds)

    def __aiter__(self):
        return self

    async def __anext__(self):
        from flydog_sdr_gps_tpu_torch.server import kiwi_server
        if not self.cmds:
            raise StopAsyncIteration
        return types.SimpleNamespace(type=kiwi_server.WSMsgType.TEXT,
                                     data=self.cmds.pop(0))


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


def server_spans(since_ns: int) -> dict[str, list]:
    """The tracer's spans that started at or after ``since_ns``
    (``time.monotonic_ns``), by name: those of a server started then."""
    from flydog_sdr_gps_tpu_torch.utils.trace import get_trace
    out: dict[str, list] = {}
    for s in get_trace().span_records():
        if s.t0 >= since_ns:
            out.setdefault(s.name, []).append(s)
    return out


def block_starts(spans: dict) -> list[float]:
    """When each iteration of the block loop started (monotonic s),
    and when the last one ended: the ``server.block`` spans."""
    blocks = sorted(spans.get("server.block", []), key=lambda s: s.t0)
    if not blocks:
        return []
    return [s.t0 / 1e9 for s in blocks] + [blocks[-1].t1 / 1e9]


def fanout_split(spans: dict) -> dict:
    """Host ms a block fanned out, from the fan-out's spans: the encode
    (its job's run in the worker and its loop lag; the executor's queue
    before the job is not in it), the fan-out after the encode (from the
    start of ``fanout.snd`` to the end of ``server.fanout``: framing,
    queueing, the W/F rows, the extensions; the autorun job and its lag
    taken out) and, keyed by the number of blocks fanned out with it,
    the autorun units' work."""
    def ms(name, parent=None):
        out: dict[int, float] = {}
        for s in spans.get(name, []):
            if parent is None or s.parent == parent:
                out[s.block] = out.get(s.block, 0.0) + (s.t1 - s.t0) / 1e6
        return out
    fan = {s.block: s.t1 for s in spans.get("server.fanout", [])}
    snd = {s.block: s.t0 for s in spans.get("fanout.snd", [])}
    enc = ms("fanout.encode")
    for b, v in ms("loop.lag", "fanout.encode").items():
        enc[b] = enc.get(b, 0.0) + v
    ar = ms("fanout.autorun")
    ar_lag = ms("loop.lag", "fanout.autorun")
    rest = [(fan[b] - snd[b]) / 1e6 - ar.get(b, 0.0) - ar_lag.get(b, 0.0)
            for b in fan]
    return dict(encode_ms_per_block=sum(enc.values()) / len(fan),
                fanout_ms_per_block=float(np.mean(rest)),
                autorun_ms={b + 1: v for b, v in ar.items()})


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


def autorun_checks(info: dict, unit_samples: list, block: int, starts,
                   script_channels: int, have_status: bool) -> dict:
    """Phase 5 with autorun: each unit on an idle channel, tuned and in
    USB; each unit's capture grew by a block every block (or completed);
    ``/status`` reports the units.  Returns what the run measured of the
    autorun work: the host ms a block, and the block whose capture
    completed beside its neighbours."""
    from flydog_sdr_gps_tpu_torch.ops import demod
    units = info["autorun"]
    for u in units:
        check(u["rx_chan"] is not None and u["rx_chan"] >= script_channels,
              f"autorun unit {u['ext']} is not on an idle channel: {u}")
        check(abs(u["ctl_hz"] - u["freq_khz"] * 1e3) < 1.0
              and u["mode"] == demod.MODE_USB,
              f"autorun unit {u['ext']} is not tuned in USB: {u}")
    check(len({u["rx_chan"] for u in units}) == len(units),
          "two autorun units share a channel")
    check(len(unit_samples) >= info["blocks"] - 3,
          f"autorun fed {len(unit_samples)} of {info['blocks']} blocks")
    completed = []
    for k, u in enumerate(units):
        seq = [s[k] for s in unit_samples]
        check(seq[0] == block, f"{u['ext']}: first capture count {seq[0]}")
        for i in range(1, len(seq)):
            grew = seq[i] == seq[i - 1] + block
            done = seq[i] == 0 and seq[i - 1] + block >= u["capture"]
            check(grew or done, f"{u['ext']}: capture {seq[i - 1]} -> "
                  f"{seq[i]} at block {i}")
            if done:
                completed.append((u["ext"], i))
    if have_status:
        check("autorun=2" in info["status"] and "spots=" in info["status"],
              f"/status: {info['status']!r}")
    # the autorun host work a block, and the block a capture completed in:
    # the fan-out of the n-th block runs in the block loop's n-th
    # iteration (0-based), whose length is starts[n]
    ar = info["fanout"]["autorun_ms"]
    ms = [ar[n] for n in sorted(ar)]
    around = {}
    for ext, i in completed:
        n = sorted(ar)[i]
        around[f"{ext}@{n}"] = dict(
            autorun_ms=ar[n], block_ms={m: float(starts[m]) for m in
                                        range(n - 2, n + 3)
                                        if 0 <= m < len(starts)})
    out = dict(autorun_units=units, autorun_completed=completed,
               autorun_ms_median=float(np.median(ms)),
               autorun_ms_max=float(max(ms)), autorun_completion=around,
               spots=info["spots"])
    log(f"  autorun: units {[(u['ext'], u['rx_chan'], u['freq_khz']) for u in units]}"
        f", capture counts grew by {block} every block; host ms a block: "
        f"median {out['autorun_ms_median']:.3f}, max "
        f"{out['autorun_ms_max']:.3f}; captures completed (unit, block): "
        f"{completed}; spots {[s['text'] for s in info['spots']]}")
    for k, v in around.items():
        log(f"  the block a capture completed in ({k}): autorun host "
            f"{v['autorun_ms']:.3f} ms; block start to block start, ms, of "
            f"it and its neighbours {v['block_ms']}")
    return out


def phase_server(torch, device, channels: int, block: int,
                 nblocks: int = 14, gps=None, autorun=None) -> dict:
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
                "lms_chain": noise.lms_chain_block,
                "spectral_nr": noise.spectral_nr_gains}
    if gps is not None:
        from flydog_sdr_gps_tpu_torch.models.gps import tracking
        counters["gps_track"] = tracking.track_epochs
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
    server = KiwiServer(eng, realtime=False, port=0, gps=gps,
                        autorun=autorun)
    # each autorun unit's capture count after every block it was fed
    unit_samples: list[list[int]] = []
    if autorun:
        feed = server.autorun.process_block

        def process_block(taps):
            feed(taps)
            unit_samples.append([u.ext._samples if u.ext is not None
                                 else -1 for u in server.autorun.units])
        server.autorun.process_block = process_block
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
        t_from = time.monotonic_ns()
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
        if gps is not None:
            info["admin_gps"] = await admin_gps_reply(server)
            info["gps_status"] = gps.status()
        info["blocks"] = eng.seq
        if autorun:
            info["autorun"] = [
                dict(ext=u.ext_name, rx_chan=u.rx_chan, freq_khz=u.freq_khz,
                     ctl_hz=eng.ctl[u.rx_chan].freq_hz,
                     mode=eng.ctl[u.rx_chan].mode,
                     capture=u.ext.capture_samples,
                     results=len(getattr(u.ext, "results", [])))
                for u in server.autorun.units]
            info["spots"] = list(server.autorun.spots)
        spans = server_spans(t_from)
        info["starts"] = block_starts(spans)
        info["fanout"] = fanout_split(spans)
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
    warm = warmup_launches(eng, counters)
    log(f"  aiohttp present: {have_aiohttp}; {blocks} blocks run, launches "
        f"{launches}, of which the boot's prewarm made {warm} on scratch "
        "buffers")
    for k in ("stage2_rot", "agc_envelope", "sam_pll", "lms_chain",
              "spectral_nr"):
        check(launches[k] == blocks + warm[k], f"kernel {k}: {launches[k]} "
              f"launches in {blocks} blocks of the server and {warm[k]} "
              "warm-ups, not one a block")
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
        if gps is not None:
            check("gps_good=" in info["status"], "/status without GPS")
        log("  a real WebSocket client on an ephemeral port got the same "
            "first SND packet as the in-process socket on its channel; "
            "/status answered")

    starts = np.diff(np.asarray(info["starts"])) * 1e3
    steady = starts[2:]                         # past the first blocks
    lags = np.asarray(info["lags"]) * 1e3
    gps_out = {}
    if autorun:
        gps_out = autorun_checks(info, unit_samples, block, starts,
                                 script_channels=len(script),
                                 have_status=info["real"] is not None)
    if gps is not None:
        st = info["gps_status"]
        chunks = gps.mgr.ticks // gps.chunk
        log(f"  GPS beside the server: {chunks} chunks of 0.4 s processed, "
            f"kernel 6 launched {launches['gps_track']} times, "
            f"{st['tracking']} rows tracking {st['prns']}, service errors "
            f"{gps.errors}; ADMIN gps: " + json.dumps(
                info["admin_gps"] and {k: info["admin_gps"][k] for k in (
                    "enabled", "tracking", "prns", "fixes", "clock_ppm")}))
        check(gps.errors == 0, f"the GPS service logged {gps.errors} errors")
        check(st["tracking"] > 0, "no satellite is tracked beside the server")
        check(launches["gps_track"] > 0, "kernel 6 was not launched")
        check(info["admin_gps"] is None or
              info["admin_gps"]["enabled"] is True, "ADMIN gps")
        gps_out = dict(gps_chunks=int(chunks), gps_tracking=st["tracking"],
                       gps_prns=st["prns"], admin_gps=info["admin_gps"])
    return dict(**gps_out,
        launches=launches, blocks=blocks, aiohttp=have_aiohttp,
        ms_blocks=[float(v) for v in starts],
        ms_median=float(np.median(steady)), ms_min=float(steady.min()),
        ms_max=float(steady.max()),
        realtime_factor=float(len(steady) * block_ms / steady.sum()),
        block_period_ms=block_ms, peak_mem_gb=peak_gb,
        encode_ms_per_block=info["fanout"]["encode_ms_per_block"],
        fanout_ms_per_block=info["fanout"]["fanout_ms_per_block"],
        loop_lag_ms=dict(mean=float(lags.mean()), p99=float(
            np.percentile(lags, 99)), max=float(lags.max()), n=len(lags)),
        late_blocks=info["late_blocks"], heard_hz=heard,
        smeter_field_dbm=[sm_am, sm_usb],
        smeter_run_block_dbm=[float(v) for v in want_sm])


# ---------------------------------------------------------------------------
# phase 6: the GPS/Galileo receiver (kernel 6), alone and beside the server
# ---------------------------------------------------------------------------

GPS_LLA = (47.37, 8.54, 450.0)
# t0 picked as tests/test_gps_e2e.py picks it: the first three full
# subframes are ids 1, 2, 3, so the ephemerides complete ~19.3 s in
GPS_T0 = 345628.7
GPS_PPM = 0.4
GPS_DECOYS = (3, 7, 30)


def make_gps(device, realtime: bool = False):
    """The ``run_server --gps`` sky and receiver, cold: 8 GPS satellites,
    the decoy PRNs 3, 7 and 30, 4 Galileo E1B satellites, the oscillator
    at +0.4 ppm, noise 0.9, amplitude 0.5, synthesized on the card in
    0.4 s chunks, a 12-row manager on the card.  Returns (receiver,
    receiver position, the PRNs the sky has, the decoys it has not)."""
    from flydog_sdr_gps_tpu_torch.models.gps import manager, scene
    from flydog_sdr_gps_tpu_torch.numerology import GALILEO_PRN_BASE
    from flydog_sdr_gps_tpu_torch.runtime import GpsReceiver
    rx = scene.ecef_from_lla(*GPS_LLA)
    ephs = scene.visible_constellation(rx, GPS_T0, n_sats=8)
    gal = scene.visible_galileo(rx, GPS_T0, n_sats=4)
    sky = scene.GpsScene(rx, ephs, GPS_T0, duration=60.0,
                         clock_ppm=GPS_PPM, noise=0.9, amplitude=0.5,
                         galileo_ephemerides=gal, device=device)
    mgr = manager.GpsManager(prns=tuple(ephs) + GPS_DECOYS,
                             galileo_prns=tuple(gal), device=device)
    rec = GpsReceiver(sky, mgr, chunk_seconds=0.4, realtime=realtime)
    want = set(ephs) | {GALILEO_PRN_BASE + g for g in gal}
    return rec, rx, want, set(GPS_DECOYS) - set(ephs)


def gps_kernel_case(torch, timer, device) -> dict:
    """Kernel 6 against its plain version at the main path's shape: the
    12 rows a cold search of the sky leaves (C/A and E1B), one C/A row
    dropped to make an inactive row, 40 epochs compared, 400 timed."""
    from flydog_sdr_gps_tpu_torch.models.gps import tracking
    rec, _rx, _want, _decoys = make_gps(device)
    mgr, sky, tp = rec.mgr, rec.source, rec.mgr.tp
    mgr.process(sky.next_block(rec.chunk), search=True)
    st, tab = mgr._track_state, mgr._code_table
    is_boc = st.boc > 0
    ca = torch.nonzero(st.active & ~is_boc).flatten().tolist()
    check(int((st.active & is_boc).sum()) >= 1 and len(ca) >= 2,
          f"rows after the cold search: {sorted(mgr.channels)}")
    base = st.clone()
    tracking.deactivate_channel(base, ca[0])
    raw = sky.next_block(rec.chunk).reshape(-1, tp.epoch)     # (400, 16368)
    n_ep, nch, n = raw.shape[0], base.code_phase.shape[0], tp.epoch
    n_cmp = 40
    s_p, s_k = base.clone(), base.clone()
    _, o_p = tracking.track_epochs_plain(tp, s_p, tab, raw[:n_cmp])
    _, o_k = tracking.track_epochs(tp, s_k, tab, raw[:n_cmp])
    scale = float(o_p["ip"].abs().max())
    err = max(max_err(o_k[f], o_p[f])[0]
              for f in ("ip", "qp", "ip_pre", "qp_pre"))
    cp_err = max(max_err(o_k["code_phase"], o_p["code_phase"])[0],
                 max_err(s_k.code_phase, s_p.code_phase)[0])
    cf_rel = max(float(((o_k["carr_freq"] - o_p["carr_freq"]).abs()
                        / o_p["carr_freq"].abs()).max()),
                 float(((s_k.carr_freq - s_p.carr_freq).abs()
                        / s_p.carr_freq.abs()).max()))
    check(err <= 1e-3 * scale, f"gps_track sums: {err}")
    check(cp_err <= 1e-3 and cf_rel <= 1e-6, "gps_track loops")
    s_t = base.clone()
    times = timer.both(lambda: tracking.track_epochs(tp, s_t, tab, raw),
                       reps=5)
    resident = tracking.max_active_clusters(nch)
    log(f"  gps_track K={tracking.CLUSTER} blocks a row (12 rows: "
        f"{int(base.active.sum())} active, {int((base.active & is_boc).sum())}"
        f" E1B; {n_cmp} epochs) max|err| of ip/qp/ip_pre/qp_pre {err:.3e} "
        f"(bound {1e-3 * scale:.3e}); code phase {cp_err:.3e} chip (bound "
        f"1e-3); carr_freq {cf_rel:.3e} relative (bound 1e-6); clusters "
        f"resident at once {resident}")
    s_pl = base.clone()
    t0 = time.perf_counter()
    _, o_full = tracking.track_epochs_plain(tp, s_pl, tab, raw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    # operations as the kernel is written, a sample and row: the phase
    # (fma, 2), sin and cos (1 each), the wipe-off (2), six accumulates
    # of E, P, L (2 each), the split's compare (1); the split sums (4)
    # for the samples before each epoch's code-period boundary, counted
    # from this run's code phases; ~40 a row and epoch for the loops
    cl = base.code_len[None, :]
    t_b = (cl - torch.remainder(o_full["code_phase"], cl)) \
        / base.code_rate[None, :]
    n_pre = float(torch.clamp(torch.ceil(t_b), 0, n).sum())
    flops = 19.0 * n * n_ep * nch + 4.0 * n_pre + 40.0 * n_ep * nch
    # the chunk and the code table in; the state in and out; the outputs
    nbytes = (raw.numel() * 4 + tab.numel() * 4 + nch * (9 * 4 + 1)
              + nch * 6 * 4 + 9 * n_ep * nch * 4)
    out = dict(max_abs_err=err, code_phase_err=cp_err,
               carr_freq_rel_err=cf_rel, err_bound=1e-3 * scale, **times,
               cluster=tracking.CLUSTER, max_active_clusters=resident,
               plain_ms=plain_ms, library_ms=None, **roofline(nbytes, flops))
    timer.release()
    return out


def gps_clock_split(torch, device) -> str:
    """Where an epoch of kernel 6 goes: ``csrc/gps_track.cu`` built again
    with ``-DGPS_TRACK_CLOCKS`` (the kernel then adds clock64 differences
    of the parts of each epoch, for thread 0 of rank 0 and thread 160 of
    the last rank of every row), launched through ``track_epochs`` on
    phase 1's inputs (12 rows x 400 epochs)."""
    import ctypes
    from flydog_sdr_gps_tpu_torch import _build
    from flydog_sdr_gps_tpu_torch.models.gps import tracking
    out_dir = HERE / "build" / "gps_track_clocks"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libgps_track_clocks.so"
    run([_build._nvcc(), *_build.NVCC_FLAGS, "-DGPS_TRACK_CLOCKS", "-o",
         str(lib_path), str(HERE / PKG / "csrc" / "gps_track.cu")])
    lib = _build.load(lib_path)
    lib.gps_track_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gps_track_clocks.restype = ctypes.c_int
    rec, _rx, _want, _decoys = make_gps(device)
    mgr, sky, tp = rec.mgr, rec.source, rec.mgr.tp
    mgr.process(sky.next_block(rec.chunk), search=True)
    base, tab = mgr._track_state.clone(), mgr._code_table
    raw = sky.next_block(rec.chunk).reshape(-1, tp.epoch)
    n_ep, nch = raw.shape[0], base.code_phase.shape[0]
    parts = ("sample pass", "warp shuffles", "barrier 1", "warp 0 across "
             "warps + DSMEM writes", "cluster barrier", "thread 0's tail",
             "barrier 2")
    tracking.track_epochs(tp, base.clone(), tab, raw, lib=lib)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    tracking.track_epochs(tp, base.clone(), tab, raw, lib=lib)
    stop.record()
    torch.cuda.synchronize()
    clocks = np.zeros((nch, 2, len(parts)), np.int64)
    _build.check(lib.gps_track_clocks(clocks.ctypes.data, nch),
                 "gps_track_clocks")
    per = clocks[base.active.cpu().numpy()].mean(axis=0) / n_ep
    lines = [f"kernel 6 clock64 split at K={tracking.CLUSTER}, clocks an "
             "epoch (mean of the active rows; thread 0 of rank 0 | thread "
             f"160 of the last rank): {start.elapsed_time(stop):.4f} ms "
             f"instrumented; total {per[0].sum():.0f} | {per[1].sum():.0f}"]
    lines += [f"    {name:<36} {a:8.1f} | {b:8.1f}"
              for name, a, b in zip(parts, per[0], per[1])]
    return "\n".join(lines)


def phase_gps(torch, device, max_if_s: float = 40.0) -> dict:
    """GPS alone at full width, from a cold start: the service loop of
    ``GpsReceiver.run`` (search, 0.4 s chunks through ``GpsManager.
    process``, a solve every 2 s of IF) until a fix and a locked clock,
    or ``max_if_s`` of IF.  The scene's ``next_block``, the manager's
    ``process`` and ``solve`` are timed on the host around a sync."""
    import asyncio
    from flydog_sdr_gps_tpu_torch.models.gps import tracking
    rec, rx, want, decoys = make_gps(device)
    mgr, sky = rec.mgr, rec.source
    times: dict[str, list] = {"scene": [], "process": [], "search": [],
                              "solve": []}
    fixes_at: list[float] = []              # IF seconds of each fix

    def timed(name, fn):
        def run(*a):
            t0 = time.perf_counter()
            r = fn(*a)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if name == "process" and len(a) > 1 and a[1]:
                times["search"].append(ms)
            else:
                times[name].append(ms)
            if name == "solve" and r is not None:
                fixes_at.append(mgr.ticks / mgr.tp.fs)
            return r
        return run
    sky.next_block = timed("scene", sky.next_block)
    mgr.process = timed("process", mgr.process)
    mgr.solve = timed("solve", mgr.solve)

    async def drive():
        task = asyncio.create_task(rec.run())
        while not task.done():
            await asyncio.sleep(0.02)
            if (mgr.fixes > 0 and mgr.clock.locked) or \
                    mgr.ticks / mgr.tp.fs >= max_if_s:
                rec.stop()
        await task
    tracking.track_epochs.launches = 0      # the main path's run starts
    t0 = time.perf_counter()
    asyncio.run(drive())
    wall = time.perf_counter() - t0
    launches = tracking.track_epochs.launches   # ... and ends
    if_s = mgr.ticks / mgr.tp.fs
    st = rec.status()
    # the fix: the manager's single-point solution from every satellite
    # with a decoded ephemeris (its "all" set); beside it the EKF's
    # output, which the reference's filter (and so the port) throws off
    # when the set grows: the common receive time is dated from the
    # latest transmit time, so the clock bias jumps by milliseconds of
    # light time, and a reset keeps the filter's velocity and covariance
    sols = {k: dict(nsat=v["nsat"], rms=float(v["rms"]),
                    err_m=float(np.linalg.norm(v["pos"] - rx)))
            for k, v in mgr.last_solutions.items()}
    fix_err = sols["all"]["err_m"] if "all" in sols else None
    ekf_err = (float(np.linalg.norm(mgr.last_fix - rx))
               if mgr.last_fix is not None else None)
    tracked = set(mgr.channels)
    by_set = {k: (v["nsat"], round(v["rms"], 2), round(v["err_m"], 2))
              for k, v in sols.items()}
    log(f"  {if_s:.1f} s of IF in {wall:.2f} s wall (IF/wall "
        f"{if_s / wall:.2f}); kernel 6 launched {launches} times; tracking "
        f"{sorted(tracked)} (the sky: {sorted(want)}, decoys "
        f"{sorted(decoys)}); fixes {mgr.fixes} at IF s "
        f"{[round(t, 1) for t in fixes_at]}; solutions by set (satellites, "
        f"rms m, error m) {by_set}; "
        f"EKF error {ekf_err if ekf_err is None else round(ekf_err, 2)} m; "
        f"clock {mgr.clock.correction_ppm:+.4f} ppm (injected "
        f"{GPS_PPM:+.1f}), locked {mgr.clock.locked}; service errors "
        f"{rec.errors}")
    check(rec.errors == 0, f"the GPS service logged {rec.errors} errors")
    check(launches > 0, "kernel 6 was not launched by the main path")
    check(tracked == want, f"tracked {sorted(tracked)}, sky {sorted(want)}")
    check(not (tracked & decoys), f"a decoy is tracked: {tracked & decoys}")
    check(mgr.fixes > 0 and fix_err is not None and fix_err < 60.0,
          f"no fix within 60 m in {if_s:.1f} s of IF: {fix_err}")
    check(mgr.clock.locked and abs(mgr.clock.correction_ppm - GPS_PPM)
          < 0.15, f"clock {mgr.clock.correction_ppm} ppm")
    med = {k: (statistics.median(v) if v else None)
           for k, v in times.items()}
    return dict(if_s=if_s, wall_s=wall, if_over_wall=if_s / wall,
                launches=launches, chunks=len(times["scene"]),
                searches=len(times["search"]), fixes=mgr.fixes,
                fixes_at_if_s=fixes_at, fix_err_m=fix_err,
                ekf_err_m=ekf_err, solutions=sols,
                clock_ppm=mgr.clock.correction_ppm,
                tracked=sorted(tracked), status_tracking=st["tracking"],
                ms_median=med, ms_all={k: [round(x, 3) for x in v]
                                       for k, v in times.items()})


async def admin_gps_reply(server) -> dict | None:
    """What the ADMIN socket's ``SET gps`` answers, over an in-process
    socket (None without aiohttp, whose message types the loop reads)."""
    from flydog_sdr_gps_tpu_torch.server import kiwi_server
    if kiwi_server.web is None:
        return None
    sock = AdminSock(["SET auth t=admin p=", "SET gps"])
    await server._ws_admin_loop(sock, lambda: [], "127.0.0.1")
    reply = sock.of(b"GPS ")
    check(len(reply) == 1, "the ADMIN socket's gps command did not answer")
    return json.loads(reply[0][4:])


# ---------------------------------------------------------------------------
# phase 7: the decoders' front ends on the card
# ---------------------------------------------------------------------------

def fsk_audio(tones, f0: float, spacing: float, sps: int, n: int,
              fs: float = 12000.0) -> np.ndarray:
    """Continuous-phase FSK audio (float64): symbol i is a sine at ``f0 +
    tones[i] * spacing`` for ``sps`` samples; zeros after the last
    symbol.  The decoders' own tests synthesize their signals so."""
    sig = np.zeros(n)
    phase = 0.0
    for i, tone in enumerate(tones):
        a, b = i * sps, min((i + 1) * sps, n)
        if a >= n:
            break
        f = f0 + tone * spacing
        t = np.arange(b - a)
        sig[a:b] = np.sin(phase + 2 * np.pi * f * t / fs)
        phase = (phase + 2 * np.pi * f * (b - a) / fs) % (2 * np.pi)
    return sig


class DecoderEngine:
    """What the decoder extensions ask of an engine, as the reference's
    extension tests stub it: an output rate and no source.  It names no
    device, so each extension runs its front end where its taps are."""
    class params:
        fs_out = 12000.0

    source = None


def feed_decoder(torch, device, name: str, audio: np.ndarray,
                 channels: int, block: int, ch: int = 7) -> dict:
    """Stream ``audio`` through the extension ``name`` on channel ``ch``
    of device taps (block, channels) on the card, a new tap tensor a
    block as the engine makes them; returns its messages, wall ms of the
    block that completed the capture and of the others, and the peak
    device memory of the run."""
    from flydog_sdr_gps_tpu_torch import extensions as ext_mod
    from flydog_sdr_gps_tpu_torch.models.rx_channel import RxTaps
    e = ext_mod.ext_create(name, DecoderEngine(), ch)
    e.start()
    dev_audio = torch.from_numpy(audio).to(device)
    iq = torch.zeros((1, 1), dtype=torch.complex64, device=device)  # unread
    smeter = torch.zeros(channels, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    msgs, ms, on_card = [], [], True
    for i in range(0, len(audio), block):
        tap = torch.zeros((block, channels), device=device)
        chunk = dev_audio[i:i + block]
        tap[:len(chunk), ch] = chunk
        taps = RxTaps(audio=tap, audio2=tap, iq_pre_fir=iq, iq_post_agc=iq,
                      smeter_dbm=smeter)
        buf = e._capture._buf
        on_card &= buf is None or buf.is_cuda
        t0 = time.perf_counter()
        out = e.process_block(taps)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        del taps, tap
        msgs += out
        if out:
            break
    max_allocated = torch.cuda.max_memory_allocated()
    peak = max_allocated - base
    check(on_card, f"{name}: the capture is not on the card")
    check(bool(msgs), f"{name}: no capture completed")
    return dict(ext=e, msgs=msgs, blocks=len(ms), completing_ms=ms[-1],
                other_ms_median=float(np.median(ms[:-1])),
                peak_mem_gb=peak / 1e9, max_allocated_gb=max_allocated / 1e9)


def phase_decoders(torch, device, timer, channels: int, block: int,
                   card: str) -> dict:
    """Phase 7: WSPR, FT8 and FT4 transmissions synthesized on the host
    from the copied encoders, in noise at the SNRs of the decoders' own
    tests, fed through device taps on the card to their extensions: each
    must decode its message.  The recorded off-air WSPR capture through
    the host path.  The FFT extension's row on a test tone.  Each front
    end's device work timed alone."""
    from flydog_sdr_gps_tpu_torch import extensions as ext_mod
    from flydog_sdr_gps_tpu_torch.extensions import (audio_fft, ft4, ft8,
                                                      ft8_decode, wspr,
                                                      wspr_decode)
    from flydog_sdr_gps_tpu_torch.models.rx_channel import RxTaps
    rng = np.random.default_rng(2026)
    out = {}
    cq = ft8_decode.pack_payload(ft8_decode.Ft8Message("CQ", "K1ABC", "FN42"))
    cases = {
        # tone 0 at 1500 + 20 Hz, test_wspr_decode.py's SNR
        "wspr": (wspr_decode.encode_to_tones(
            wspr_decode.WsprMessage("K1ABC", "FN42", 37)),
            wspr.DIAL_OFFSET + 20.0, wspr.TONE_SPACING,
            wspr.SPS * wspr.DECIM, int(wspr.CAPTURE_S * 12000), 0.25, 0.25,
            "K1ABC FN42 37"),
        # test_ft8_decode.py's and test_ft4.py's messages and SNRs
        "FT8": (ft8_decode.codeword_to_tones(ft8_decode.ldpc_encode(
            ft8_decode.add_crc(cq))), 1200.0, ft8.BAUD, ft8.SPS,
            int(ft8.Ft8Ext.CAPTURE_S * 12000), 0.3, 0.2, "CQ K1ABC FN42"),
        "FT4": (ft4.encode_tones(cq), 1500.0, ft4.BAUD, ft4.SPS,
                int(ft4.Ft4Ext.CAPTURE_S * 12000), 0.3, 0.2,
                "CQ K1ABC FN42"),
    }
    captures = {}
    for name, (tones, f0, spacing, sps, n, amp, noise, want) in cases.items():
        audio = (amp * fsk_audio(tones, f0, spacing, sps, n)
                 + noise * rng.standard_normal(n)).astype(np.float32)
        captures[name] = audio
        r = feed_decoder(torch, device, name, audio, channels, block)
        dec = [p.decode() for t, p in r["msgs"] if t.endswith("_decode")]
        log(f"  {name}: {r['blocks']} blocks of ({block}, {channels}) device "
            f"taps; decoded {dec}; the completing block {r['completing_ms']:.3f}"
            f" ms (front end + host decode), the others median "
            f"{r['other_ms_median']:.3f} ms; peak device memory of the "
            f"capture {r['peak_mem_gb']:.4f} GB over what was allocated "
            f"before it (torch.cuda.max_memory_allocated() "
            f"{r['max_allocated_gb']:.4f} GB)  [{card}]")
        check(any(d.startswith(want) for d in dec),
              f"{name} did not decode {want!r}: {r['msgs']}")
        # a capture that kept views of the taps would hold every block's
        # (block, channels) tensor: ~22 GB for WSPR at C=4096
        check(r["peak_mem_gb"] < 1.0, f"{name}: the capture held "
              f"{r['peak_mem_gb']} GB of the card")
        out[name] = {k: v for k, v in r.items() if k not in ("ext", "msgs")}
        out[name]["decoded"] = dec

    # the recorded off-air capture through the host path (copied code)
    z = np.load(HERE / "tests" / "data" / "wspr_offair_375.npz")["iq"] \
        .astype(np.complex128)
    nsym = len(z) // wspr.SPS
    power = np.abs(np.fft.fftshift(np.fft.fft(
        z[:nsym * wspr.SPS].reshape(nsym, wspr.SPS), axis=1),
        axes=1)).astype(np.float32) ** 2
    spots = []
    for c in wspr.sync_correlate(power, max_dt_sym=nsym - wspr.NSYM)[:5]:
        r = wspr.refine_candidate(z, c)
        msg = None if r is None else wspr_decode.decode_soft_symbols(r["soft"])
        if msg is not None:
            spots.append((msg.callsign, msg.grid, msg.dbm, r["freq"],
                          r["sync"]))
    log(f"  off-air WSPR capture (tests/data/wspr_offair_375.npz): {spots}")
    hit = [s for s in spots if s[:3] == ("ZL3DMH", "RE66", 37)]
    check(bool(hit) and abs(hit[0][3] - 1535.5) < 2.0 and hit[0][4] > 0.5,
          f"the off-air capture did not give ZL3DMH RE66 37: {spots}")
    out["offair"] = [list(s) for s in spots]

    # the FFT extension's row peaks at a test tone's bin
    f_tone = 1750.0
    t = np.arange(4 * block) / 12000.0
    tone = torch.from_numpy((0.4 * np.exp(2j * np.pi * f_tone * t))
                            .astype(np.complex64)).to(device)
    fe = ext_mod.ext_create("FFT", DecoderEngine(), 7)
    fe.start()
    rows = []
    for i in range(4):
        iq = torch.zeros((block, channels), dtype=torch.complex64,
                         device=device)
        iq[:, 7] = tone[i * block:(i + 1) * block]
        rows += fe.process_block(RxTaps(audio=iq.real, audio2=iq.real,
                                        iq_pre_fir=iq, iq_post_agc=iq,
                                        smeter_dbm=torch.zeros(channels)))
    row = np.frombuffer(rows[-1][1], "<f4")
    want_bin = audio_fft.FFT_N // 2 + round(f_tone / (12000.0 / audio_fft.FFT_N))
    log(f"  FFT: {len(rows)} rows; the row peaks at bin {int(np.argmax(row))} "
        f"(the {f_tone:.0f} Hz tone's bin {want_bin})")
    check(abs(int(np.argmax(row)) - want_bin) <= 1, "FFT row peak")

    # each front end's device work alone, on the captures above
    x_w = torch.from_numpy(captures["wspr"]).to(device)
    x_8 = torch.from_numpy(captures["FT8"]).to(device)
    x_4 = torch.from_numpy(captures["FT4"]).to(device)
    z_f = tone[:audio_fft.FFT_N].clone()
    times = {"wspr.frontend": timer.both(lambda: wspr.frontend(x_w)),
             "ft8.spectrogram": timer.both(lambda: ft8.spectrogram(x_8)),
             "ft4.spectrogram": timer.both(lambda: ft4.spectrogram(x_4)),
             "audio_fft.spectrum": timer.both(
                 lambda: audio_fft.spectrum(z_f))}
    for k, v in times.items():
        log(f"  {k}: {v['ms']:.4f} ms ({v['ms_host_paced']:.4f} host-paced)"
            f"  [{card}]")
    out["frontend_ms"] = times
    return out


# ---------------------------------------------------------------------------
# phase 8: the host-only decoders on the card's taps
# ---------------------------------------------------------------------------
# The signals are synthesized as the reference package's own decoder tests
# (tests/test_decoders2.py) synthesize them; those tests import jax, so the
# synthesizers are copied here, and tests/test_torch_decoders.py holds the
# copies to the originals and imports them from here.

FS_AUDIO = 12000.0
NAVTEX_TEXT = "NAV WARNING 42"
NAVTEX_KHZ = 518.0      # the client's USB dial; the emitter sits 1000 Hz up
NAVTEX_BLOCKS = 30      # ~5.1 s of 170.656 ms blocks; the message is 3.64 s


def rtty_audio(codes, baud: float, center: float, shift: float,
               fs: float = FS_AUDIO, lead: float = 0.2) -> np.ndarray:
    """ITA2 frames (1 start + 5 data + 1.5 stop bits) as FSK audio, 8
    mark bits before the first frame and 4 after the last (float32)."""
    bits = []
    for code in codes:
        bits.append((0, 1.0))                     # start
        for i in range(5):
            bits.append(((code >> i) & 1, 1.0))
        bits.append((1, 1.5))                     # stop
    samples = [np.zeros(int(lead * fs))]
    phase = 0.0
    bits = [(1, 8.0)] + bits + [(1, 4.0)]
    for bit, dur in bits:
        n = int(round(dur * fs / baud))
        f = center + (shift / 2 if bit else -shift / 2)
        t = np.arange(n)
        samples.append(np.sin(phase + 2 * np.pi * f * t / fs))
        phase = (phase + 2 * np.pi * f * n / fs) % (2 * np.pi)
    return np.concatenate(samples).astype(np.float32)


def navtex_bits(codes) -> list[int]:
    """CCIR 476 codes as the bits sent, 7 a code, most significant
    first."""
    return [(code >> i) & 1 for code in codes for i in range(6, -1, -1)]


def navtex_audio(codes, fs: float = FS_AUDIO) -> np.ndarray:
    """100 Bd FSK of ``navtex_bits(codes)`` at 1000 +- 85 Hz (a 1 is the
    upper tone), 1024 zeros before and 2048 after (float32)."""
    sps = int(round(fs / 100.0))
    phase = 0.0
    chunks = [np.zeros(1024)]
    for b in navtex_bits(codes):
        f = 1000.0 + (85.0 if b else -85.0)
        t = np.arange(sps)
        chunks.append(np.sin(phase + 2 * np.pi * f * t / fs))
        phase = (phase + 2 * np.pi * f * sps / fs) % (2 * np.pi)
    chunks.append(np.zeros(2048))
    return np.concatenate(chunks).astype(np.float32)


def dcf77_audio(bits, fs: float = FS_AUDIO) -> np.ndarray:
    """A DCF77-style AM second stream of one frame (a 500 Hz tone at
    amplitude 0.1 for the first 0.2 s of a second that sends a 1, 0.1 s
    for a 0), second 59 unreduced, then the next minute's first second
    (float32)."""
    def tone(n, a):
        return a * np.sin(2 * np.pi * 500.0 * np.arange(n) / fs)
    sec = int(fs)
    chunks = []
    for b in bits:
        red = int(0.2 * fs) if b else int(0.1 * fs)
        chunks.append(np.concatenate([tone(red, 0.1), tone(sec - red, 1.0)]))
    chunks.append(tone(sec, 1.0))
    chunks.append(np.concatenate([tone(int(0.1 * fs), 0.1),
                                  tone(sec - int(0.1 * fs), 1.0)]))
    return np.concatenate(chunks).astype(np.float32)


def fax_audio(line_n: int, fs: float = FS_AUDIO) -> np.ndarray:
    """Five WEFAX lines of ``line_n`` samples: a white sync pulse over the
    first 1/20 of a line, then black, white, black, white quarters, FM
    between 1500 (black) and 2300 Hz (white) (float32)."""
    lum = np.zeros(line_n)
    lum[: line_n // 20] = 1.0
    q = line_n // 4
    lum[q:2 * q] = 1.0
    lum[3 * q:] = 1.0
    freq = 1500.0 + lum * 800.0
    phase = 2 * np.pi * np.cumsum(np.tile(freq, 5)) / fs
    return np.sin(phase).astype(np.float32)


def sstv_audio(sstv, fs: float = FS_AUDIO) -> np.ndarray:
    """A Martin M1 transmission from the constants of the module ``sstv``:
    the VIS code 44 (leader, break, leader, start bit, 7 bits least
    significant first, even parity, stop bit), then 8 lines whose green
    scan is white on the left half, blue black, red white on the right
    half (float32)."""
    m = sstv.MODES[44]
    ms = fs / 1000.0
    st = [0.0]

    def tone_seg(freq, n_samples):
        t = np.arange(int(n_samples))
        seg = np.sin(st[0] + 2 * np.pi * freq * t / fs)
        st[0] = (st[0] + 2 * np.pi * freq * int(n_samples) / fs) \
            % (2 * np.pi)
        return seg

    parts = [np.zeros(1000)]
    parts.append(tone_seg(sstv.F_LEADER, 300 * ms))
    parts.append(tone_seg(sstv.F_SYNC, 10 * ms))
    parts.append(tone_seg(sstv.F_LEADER, 300 * ms))
    parts.append(tone_seg(sstv.F_SYNC, 30 * ms))
    vis_bits = [(44 >> b) & 1 for b in range(7)]
    vis_bits.append(sum(vis_bits) % 2)
    for b in vis_bits:
        parts.append(tone_seg(sstv.F_BIT1 if b else sstv.F_BIT0, 30 * ms))
    parts.append(tone_seg(sstv.F_SYNC, 30 * ms))

    def scan_seg(levels):
        seg = []
        for lv in levels:
            f = sstv.F_BLACK + lv * (sstv.F_WHITE - sstv.F_BLACK)
            seg.append(tone_seg(f, m.scan_ms * ms / len(levels)))
        return np.concatenate(seg)

    for _line in range(8):
        parts.append(tone_seg(sstv.F_SYNC, m.sync_ms * ms))
        parts.append(scan_seg([1.0, 0.0]))
        parts.append(tone_seg(1500, m.sep_ms * ms))
        parts.append(scan_seg([0.0, 0.0]))
        parts.append(tone_seg(1500, m.sep_ms * ms))
        parts.append(scan_seg([0.0, 1.0]))
        parts.append(tone_seg(1500, m.sep_ms * ms))
    parts.append(np.zeros(4000))
    return np.concatenate(parts).astype(np.float32)


def loran_audio(gri: int, secs: float, fs: float = FS_AUDIO) -> np.ndarray:
    """Envelope-like Loran-C pulse groups (8 Hann pulses of ~600 us, 1 ms
    apart, every GRI) in 0.02 rms noise of seed 7 (float32)."""
    n = int(secs * fs)
    audio = 0.02 * np.random.default_rng(7).standard_normal(n)
    period = fs * gri / 1e5
    t0 = 0.0
    pulse = np.hanning(int(fs * 300e-6) * 2 + 1)
    while t0 < n:
        for k in range(8):
            c = int(t0 + k * fs * 1e-3)
            lo, hi = c - len(pulse) // 2, c + len(pulse) // 2 + 1
            if 0 <= lo and hi < n:
                audio[lo:hi] += pulse
        t0 += period
    return audio.astype(np.float32)


def _text(msgs, tags=("chars", "time")) -> str:
    return "".join(p.decode() for t, p in msgs if t in tags)


def _rows(msgs, tag) -> list[np.ndarray]:
    return [np.frombuffer(p, np.uint8) for t, p in msgs if t == tag]


def _fax_ok(msgs) -> bool:
    rows = _rows(msgs, "fax_line")
    if len(rows) < 3:
        return False
    row = rows[2].astype(np.float64) / 255.0
    return bool(row[96:120].mean() > 0.7 and row[140:185].mean() < 0.3)


def _sstv_ok(msgs) -> bool:
    modes = [p.decode() for t, p in msgs if t == "sstv_mode"]
    lines = [np.frombuffer(p[1:], np.uint8).reshape(3, 64)
             for t, p in msgs if t == "sstv_line"]
    if modes != ["Martin M1"] or len(lines) < 6:
        return False
    r, g, b = lines[3].astype(np.float64) / 255.0
    return bool(g[8:24].mean() > 0.7 and g[40:56].mean() < 0.3
                and r[8:24].mean() < 0.3 and r[40:56].mean() > 0.7
                and b.mean() < 0.2)


def _loran_ok(msgs) -> bool:
    found = [p.decode().split()[0] for t, p in msgs if t == "gri_found"]
    rows = {t: np.frombuffer(p, np.uint8).astype(float) for t, p in msgs
            if t.startswith("scope")}
    if found != ["6731"] or set(rows) != {"scope0", "scope1"}:
        return False
    s0, s1 = rows["scope0"], rows["scope1"]
    contrast0 = s0.max() / max(np.median(s0), 1)
    contrast1 = s1.max() / max(np.median(s1), 1)
    return bool(s0.max() == 255 and np.median(s0) < 60
                and contrast0 > 2.5 * contrast1)


def _s4285_bits(msgs) -> np.ndarray:
    return np.unpackbits(np.frombuffer(
        b"".join(p for t, p in msgs if t == "s4285_bits"), np.uint8))


def host_decoder_cases() -> list[dict]:
    """Phase 8a's cases: for each decoder the signal its reference test
    synthesizes, the extension's start parameters (and commands), and
    ``done(msgs)``: what that test asserts of the messages.  ``feed_all``
    streams the whole signal before ``done`` is asked (Loran-C's scope
    rows are read at the end, as its test reads them)."""
    from flydog_sdr_gps_tpu_torch.extensions import (ale_2g, drm, fax, fsk,
                                                      hfdl, navtex, s4285,
                                                      sstv, timecode)
    inv = {c: i for i, c in enumerate(fsk.ITA2_LTRS)}
    fx = fax.FaxExt(DecoderEngine(), 0)
    fx.start(lpm=120.0, px=256)
    rng = np.random.default_rng(11)
    ale_audio = ale_2g.modulate([("TO", "HQ@"), ("TO", "HQ@"),
                                 ("TIS", "SAM")], fs=FS_AUDIO)
    ale_audio = ale_audio + 0.15 * rng.standard_normal(
        len(ale_audio)).astype(np.float32)
    s_bits = np.random.default_rng(21).integers(0, 2, 100).astype(np.uint8)
    hfdl_payload = b"SQUITTER 01"
    drm_iq = np.concatenate([drm.DrmTx().superframe(b"S", b"M"),
                             np.zeros(4000, np.complex64)])
    return [
        dict(name="FSK", what="'CQ DX' at 45.45 Bd / 170 Hz",
             params=dict(center=1000.0, shift=170.0, baud=45.45),
             signal=rtty_audio([fsk.LTRS] + [inv[c] for c in "CQ DX"],
                               45.45, 1000.0, 170.0),
             done=lambda m: "CQ DX" in _text(m)),
        dict(name="NAVTEX", what=repr(NAVTEX_TEXT), params=dict(center=1000.0),
             signal=navtex_audio(navtex.encode_text(NAVTEX_TEXT)),
             done=lambda m: NAVTEX_TEXT in _text(m)),
        dict(name="timecode", what="DCF77 2024-03-02 09:05", params={},
             signal=dcf77_audio(timecode.encode_dcf77_frame(
                 timecode.DecodedTime(minute=5, hour=9, day=2, month=3,
                                      year=24))),
             done=lambda m: "2024-03-02 09:05" in _text(m)),
        dict(name="FAX", what="the stripe pattern (120 LPM, 256 px)",
             params=dict(lpm=120.0, px=256), signal=fax_audio(fx.line_samples),
             done=_fax_ok),
        dict(name="SSTV", what="Martin M1, 8 striped lines",
             params=dict(px=64), signal=sstv_audio(sstv), done=_sstv_ok),
        dict(name="Loran_C", what="GRI 6731 folded, and found by a search",
             params=dict(gri0=6731, gri1=8000), commands=[{"search": True}],
             signal=loran_audio(6731, 6.0), done=_loran_ok, feed_all=True),
        dict(name="ALE_2G", what="[TO] HQ@ and [TIS] SAM", params={},
             signal=ale_audio,
             done=lambda m: (lambda w: "[TO] HQ@" in w and "[TIS] SAM" in w
                             and len(w) >= 3)(
                 [p.decode().split(" (")[0] for t, p in m
                  if t == "ale_word"])),
        dict(name="s4285", what="100 bits at 600 bps", params=dict(rate=600),
             signal=np.concatenate([s4285.modulate(s_bits, rate=600),
                                    np.zeros(20000, np.float32)]),
             done=lambda m: (len(_s4285_bits(m)) >= 100 and np.array_equal(
                 _s4285_bits(m)[:100], s_bits))),
        dict(name="HFDL", what="'SQUITTER 01' at 1200 bps", params={},
             signal=np.concatenate([hfdl.modulate(hfdl.make_mpdu(
                 hfdl_payload), rate=1200), np.zeros(60000, np.float32)]),
             done=lambda m: ("1200|" + hfdl_payload.hex()).encode() in
             [p for t, p in m if t == "hfdl_mpdu"]),
        dict(name="DRM", what="FAC, SDC 'S' and MSC 'M' through the IQ tap",
             params={}, signal=drm_iq,
             done=lambda m: ({"drm_fac", "drm_sdc", "drm_msc"}
                             <= {t for t, _ in m}
                             and (b"S", b"M") == (
                                 dict(m).get("drm_sdc"),
                                 dict(m).get("drm_msc")))),
    ]


def feed_host_decoder(torch, device, case: dict, channels: int, block: int,
                      ch: int = 7) -> dict:
    """Stream a case's signal through its extension on channel ``ch`` of
    (block, channels) taps on ``device``, a new tap tensor a block as the
    engine makes them: a real signal in the audio tap, a complex one in
    the post-AGC IQ tap.  Stops when ``done`` holds (or, with
    ``feed_all``, at the signal's end).  Returns the messages, the host
    ms of each block and the index of the block that completed the
    message (None if none did)."""
    from flydog_sdr_gps_tpu_torch import extensions as ext_mod
    from flydog_sdr_gps_tpu_torch.models.rx_channel import RxTaps
    e = ext_mod.ext_create(case["name"], DecoderEngine(), ch)
    e.start(**case["params"])
    for cmd in case.get("commands", ()):
        e.command(cmd)
    sig = case["signal"]
    is_iq = np.iscomplexobj(sig)
    dev_sig = torch.from_numpy(
        sig.astype(np.complex64 if is_iq else np.float32)).to(device)
    unread = torch.zeros((1, 1), dtype=torch.complex64, device=device)
    smeter = torch.full((channels,), -50.0, device=device)
    msgs, ms, done_at = [], [], None
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    for i in range(0, len(sig), block):
        chunk = dev_sig[i:i + block]
        if is_iq:
            iq = torch.zeros((block, channels), dtype=torch.complex64,
                             device=device)
            iq[:len(chunk), ch] = chunk
            audio = torch.zeros((block, channels), device=device)
        else:
            audio = torch.zeros((block, channels), device=device)
            audio[:len(chunk), ch] = chunk
            iq = unread
        taps = RxTaps(audio=audio, audio2=audio, iq_pre_fir=iq,
                      iq_post_agc=iq, smeter_dbm=smeter)
        sync()
        t0 = time.perf_counter()
        msgs += e.process_block(taps)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        del taps, audio, iq
        if done_at is None and not case.get("feed_all") \
                and case["done"](msgs):
            done_at = len(ms) - 1
            break
    if case.get("feed_all") and case["done"](msgs):
        done_at = len(ms) - 1
    return dict(msgs=msgs, ms=ms, done_at=done_at)


def phase_host_decoders(torch, device, channels: int, block: int,
                        card: str) -> dict:
    """Phase 8a: every host-only decoder fed its reference test's signal
    through (block, channels) device taps; each must decode what that test
    asserts."""
    out = {}
    for case in host_decoder_cases():
        r = feed_host_decoder(torch, device, case, channels, block)
        ms = r["ms"]
        ok = r["done_at"] is not None
        out[case["name"]] = dict(
            blocks=len(ms), decoded=ok,
            host_ms_median=float(np.median(ms)),
            completing_ms=ms[r["done_at"]] if ok else None)
        log(f"  {case['name']:<8} {case['what']}: "
            f"{'decoded' if ok else 'NOT decoded'} in {len(ms)} blocks of "
            f"({block}, {channels}) taps on {device.type}; host ms a block "
            f"median {np.median(ms):.3f}, the completing block "
            f"{ms[r['done_at']] if ok else float('nan'):.3f}  [{card}]")
        check(ok, f"{case['name']} did not decode {case['what']}: "
              f"{r['msgs'][:12]}")
    return out


def phase_navtex_server(torch, device, channels: int, block: int,
                        card: str) -> dict:
    """Phase 8b: a NAVTEX broadcast through the main path and the server.
    The scene of phase 5 plus one emitter 1000 Hz above 518 kHz: the
    source's FSK tone, 120 output samples a symbol (100 Bd at the 12 kHz
    plan), 170 Hz shift, the bits of ``NAVTEX_TEXT``'s SITOR-B stream,
    then idle.  One SND client tuned to 518 kHz USB and the NAVTEX
    extension on its EXT socket, there before the first block; the text
    must arrive on the EXT socket within ``NAVTEX_BLOCKS`` blocks, with
    kernels 1, 3 and 4 launched once a block."""
    import asyncio
    from flydog_sdr_gps_tpu_torch.extensions import navtex
    from flydog_sdr_gps_tpu_torch.models import rx_channel as rx
    from flydog_sdr_gps_tpu_torch.ops import agc, demod, kernels
    from flydog_sdr_gps_tpu_torch.runtime import (DeviceSceneSource,
                                                  StreamEngine)
    from flydog_sdr_gps_tpu_torch.server import KiwiServer
    counters = {"stage2_rot": kernels.stage2_rot,
                "agc_envelope": agc.envelope_scan, "sam_pll": demod.sam_pll}
    bits = navtex_bits(navtex.encode_text(NAVTEX_TEXT))
    emitter = (NAVTEX_KHZ * 1e3 + 1000.0, 0.05,
               ("fsk", 120, 170.0, bits, len(bits) + 200))
    params = rx.RxParams(num_channels=channels, audio_block=block)
    src = DeviceSceneSource(tones=SCENE + [emitter], noise_rms=3e-4,
                            block=params.ddc.adc_block, device=device)
    eng = StreamEngine(params, src, device=device)
    server = KiwiServer(eng, realtime=False, port=0)
    snd, ext = Sock(), Sock()
    ext_ms: list[float] = []
    info: dict = {}

    def heard() -> str:
        return b"".join(p[len(b"EXT chars "):]
                        for p in ext.of(b"EXT chars ")).decode()

    async def drive():
        conn = await server.open_stream("navtex", "SND", snd, "127.0.0.1")
        for cmd in ("SET auth t=kiwi p=",
                    f"SET mod=usb low_cut=300 high_cut=2700 "
                    f"freq={NAVTEX_KHZ:.3f}", "SET compression=0"):
            await conn.handle_set(cmd, "SND")
        await server.open_stream("navtex", "EXT", ext, "127.0.0.1")
        await conn.handle_set("SET auth t=kiwi p=", "EXT")
        await conn.handle_set("SET ext_switch_to_client=NAVTEX center=1000",
                              "EXT")
        x = conn.ext
        check(x is not None and x.name == "NAVTEX",
              "the NAVTEX extension did not start on the EXT socket")
        feed = x.process_block

        def timed(taps):
            t0 = time.perf_counter()
            msgs = feed(taps)
            ext_ms.append((time.perf_counter() - t0) * 1e3)
            return msgs
        x.process_block = timed
        check(eng.seq == 0, "a block ran before the server was started")
        for fn in counters.values():
            fn.launches = 0
        t_from = time.monotonic_ns()
        server.start_tasks()
        t0 = time.monotonic()
        while NAVTEX_TEXT not in heard() and eng.seq < NAVTEX_BLOCKS:
            await asyncio.sleep(0.002)
            check(time.monotonic() - t0 < 600.0, "phase 8b timed out")
        await server.stop()
        snap = None
        while snap != (eng.seq, [fn.launches for fn in counters.values()]):
            # a block's step may still be running on an executor thread
            snap = (eng.seq, [fn.launches for fn in counters.values()])
            await asyncio.sleep(0.5)
        info["launches"] = {k: fn.launches for k, fn in counters.items()}
        info["blocks"] = eng.seq
        info["starts"] = block_starts(server_spans(t_from))
    asyncio.run(drive())
    text, launches, blocks = heard(), info["launches"], info["blocks"]
    starts = np.diff(np.asarray(info["starts"])) * 1e3
    steady = starts[2:]                         # past the first blocks
    block_ms = eng.params.ddc.adc_block / eng.params.adc_clock * 1e3
    factor = float(len(steady) * block_ms / steady.sum())
    log(f"  the EXT socket heard {text!r} after {blocks} blocks; kernel "
        f"launches {launches}; realtime factor {factor} over {len(steady)} "
        f"blocks after 2 (block start to block start, median "
        f"{np.median(steady):.3f} ms); "
        f"NAVTEX host ms a block median {np.median(ext_ms):.3f}, max "
        f"{max(ext_ms):.3f} ({len(ext_ms)} blocks)  [{card}]")
    check(bool(ext.of(b"EXT ready NAVTEX")), "no EXT ready on the socket")
    check(NAVTEX_TEXT in text, f"the EXT socket heard {text!r}, not "
          f"{NAVTEX_TEXT!r}, in {blocks} blocks")
    warm = warmup_launches(eng, counters)
    for k, n in launches.items():
        check(n == blocks + warm[k], f"kernel {k}: {n} launches in {blocks} "
              f"blocks of phase 8b and {warm[k]} warm-ups, not one a block")
    return dict(heard=text, blocks=blocks, launches=launches,
                realtime_factor=factor, ms_blocks=[float(v) for v in starts],
                ext_host_ms_median=float(np.median(ext_ms)),
                ext_host_ms_max=float(max(ext_ms)))


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 9: the multi-device engine, the stage-2 FFT method, lms_block
# ---------------------------------------------------------------------------

MESH = (2, 2)                   # (time, chan), every shard on the one card
MESH_BLOCKS = 8                 # a SET before block 3, retune_all before 5
MESH_SERVER_BLOCKS = 12


def warmup_launches(eng, counters) -> dict:
    """The launches each counted kernel made in ``prewarm_gather``'s
    warm-ups on scratch buffers (real launches, which the counters hold
    beside the blocks'); none for an eager engine."""
    step = getattr(eng, "compiled", None)
    done = step.warmup_launches if step is not None else {}
    return {k: done.get(fn, 0) for k, fn in counters.items()}


def kernel_counters():
    from flydog_sdr_gps_tpu_torch.ops import agc, demod, kernels, noise
    return {"stage2_rot": kernels.stage2_rot, "stage2": kernels.stage2,
            "agc_envelope": agc.envelope_scan, "sam_pll": demod.sam_pll,
            "lms_chain": noise.lms_chain_block,
            "spectral_nr": noise.spectral_nr_gains}


def make_mesh_engine(torch, device, channels: int, block: int, scene=None,
                     use_graphs: bool | None = None,
                     source_graphs: bool | None = None):
    """A ``ShardedStreamEngine`` over a MESH of ``device`` repeated, fed by
    phase 3's scene on the card (the compiled mesh step unless
    ``use_graphs`` is False; the compiled source unless ``source_graphs``
    is False)."""
    from flydog_sdr_gps_tpu_torch import parallel
    from flydog_sdr_gps_tpu_torch.models import rx_channel as rx
    from flydog_sdr_gps_tpu_torch.runtime import (DeviceSceneSource,
                                                  ShardedStreamEngine)
    params = rx.RxParams(num_channels=channels, audio_block=block)
    src = DeviceSceneSource(tones=scene or SCENE, noise_rms=3e-4,
                            block=params.ddc.adc_block, device=device,
                            use_graphs=source_graphs)
    mesh = parallel.make_mesh(*MESH, devices=[device] * (MESH[0] * MESH[1]))
    return ShardedStreamEngine(params, src, mesh=mesh, use_graphs=use_graphs)


def mesh_events(torch, eng, b: int) -> float | None:
    """The control-plane events of phase 9a, before block ``b``: a SET
    (channel 1 to LSB on 14.2036 MHz, where the 14.2018 MHz tone is 1800
    Hz below) before block 3, the GPS clock's retune_all (+0.4 ppm) before
    block 5.  Returns the SET's wall ms (synchronized), else None."""
    from flydog_sdr_gps_tpu_torch.ops import demod
    if b == 3:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.set_channel(1, freq_hz=14.2036e6, mode=demod.MODE_LSB,
                        passband=(-2700.0, -300.0))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3
    if b == 5:
        eng.retune_all(eng.params.adc_clock * (1 + 0.4e-6))
    return None


def device_profile(torch, eng) -> dict:
    """One block (after one more) under torch.profiler: the summed time
    of the kernels that ran on the card and how many there were."""
    eng.run_block()
    torch.cuda.synchronize()
    return device_ops(torch, eng.run_block)


def device_ops(torch, fn) -> dict:
    """``fn()`` under torch.profiler: the summed time of what ran on the
    card (kernels, copies and fills) and how many there were."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return dict(device_ms=sum(e.self_device_time_total for e in dev) / 1e3,
                device_ops=sum(e.count for e in dev))


def phase_mesh(torch, device, channels: int, block: int,
               profile: bool = False) -> dict:
    """9a: the mesh engine against the unfused single-device engine on the
    same blocks (the reference's bounds, ``tests/test_parallel.py``).
    With ``profile``, one block of a new mesh engine and one of the fused
    single-device engine under torch.profiler, after the counts."""
    counters = kernel_counters()
    eng = tune_slice(make_mesh_engine(torch, device, channels, block))
    n_dev = MESH[0] * MESH[1]
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0                     # the mesh path's run starts
    ms, kept, set_ms = [], [], None
    for b in range(MESH_BLOCKS):
        set_ms = mesh_events(torch, eng, b) or set_ms
        t0 = time.perf_counter()
        taps = eng.run_block()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        kept.append((taps.audio, taps.iq_pre_fir, taps.smeter_dbm))
    launches = {k: fn.launches for k, fn in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9   # the run ends
    block_ms = eng.params.ddc.adc_block / eng.params.adc_clock * 1e3
    shape = dict(eng.mesh.shape)
    fs = eng.params.fs_out
    del eng, taps
    ref = make_engine(torch, device, channels, block, "unfused")
    err = dict(iq=0.0, audio=0.0, smeter=0.0)
    for b in range(MESH_BLOCKS):
        mesh_events(torch, ref, b)
        want = ref.run_block()
        audio, iq, sm = kept[b]
        for name, got, w in (("iq", iq, want.iq_pre_fir),
                             ("audio", audio, want.audio),
                             ("smeter", sm, want.smeter_dbm)):
            check(bool(torch.isfinite(got).all()), f"mesh {name} not finite")
            err[name] = max(err[name], float((got - w).abs().max()))
    lanes = torch.cat([a[:, :2] for a, _, _ in kept[3:]]).cpu().numpy()
    del ref, want, kept
    log(f"  mesh {shape} over {n_dev} x {device}: launches {launches} in "
        f"{MESH_BLOCKS} blocks; max |mesh - unfused engine|: iq "
        f"{err['iq']:.3e} (bound 1e-5), audio {err['audio']:.3e} (bound "
        f"3e-3), S-meter {err['smeter']:.3e} dB (bound 0.1)")
    check(err["iq"] <= 1e-5, f"mesh iq_pre_fir: {err['iq']}")
    check(err["audio"] <= 3e-3, f"mesh audio: {err['audio']}")
    check(err["smeter"] <= 0.1, f"mesh S-meter: {err['smeter']}")
    for k in ("stage2", "agc_envelope", "sam_pll"):
        check(launches[k] == n_dev * MESH_BLOCKS, f"kernel {k}: "
              f"{launches[k]} launches in {MESH_BLOCKS} mesh blocks, not "
              f"{n_dev} a block")
    for k in ("stage2_rot", "lms_chain", "spectral_nr"):
        check(launches[k] == 0, f"kernel {k} ran on the mesh path")
    f_am, f_lsb = (dominant_hz(lanes[:, i], fs) for i in (0, 1))
    log(f"  after the SET: AM hears {f_am:.1f} Hz, LSB 14.2036 MHz hears "
        f"{f_lsb:.1f} Hz")
    check(abs(f_am - 1000.0) <= 20 and abs(f_lsb - 1800.0) <= 20,
          f"mesh lanes hear {f_am}, {f_lsb}")
    steady = ms[2:]
    prof = None
    if profile:
        eng = tune_slice(make_mesh_engine(torch, device, channels, block))
        prof = {"mesh": device_profile(torch, eng)}
        del eng
        prof["one device, fused"] = device_profile(
            torch, make_engine(torch, device, channels, block, "fused"))
        log(f"  one profiled block's kernels on the card: {prof}")
    return dict(mesh=shape, devices=n_dev, launches=launches, profile=prof,
                launches_per_block={k: v / MESH_BLOCKS
                                    for k, v in launches.items()},
                blocks=MESH_BLOCKS, ms_blocks=ms,
                ms_median=statistics.median(steady), ms_min=min(steady),
                ms_max=max(steady),
                realtime_factor=len(steady) * block_ms / sum(steady),
                peak_mem_gb=peak_gb, base_mem_gb=base_gb, set_ms=set_ms,
                max_err=err,
                heard_hz=[f_am, f_lsb])


def mesh_gather_check(torch, device, channels: int, block: int) -> None:
    """Two mesh engines from one state on the same scene, through phase
    9a's SET and ``retune_all``: each block ``run_block_gather`` serves
    is the twin's ``run_block`` taps packed by ``pack_columns``, to the
    bit; ``prewarm_gather`` moves nothing."""
    from flydog_sdr_gps_tpu_torch.runtime.stream import pack_columns
    served, twin = (make_mesh_engine(torch, device, channels, block)
                    for _ in range(2))
    idx = np.array([1, 0, 5, 0], np.int32)
    served.prewarm_gather(len(idx))
    check(served.seq == 0, "prewarm_gather ran a block")
    for b in range(6):
        for e in (served, twin):
            mesh_events(torch, e, b)
        got = served.run_block_gather(idx)
        want = pack_columns(twin.run_block(), twin._last_x, idx)
        check(got.shape == (served.packed_len(len(idx)),) and
              torch.equal(got, want),
              f"mesh block {b}: run_block_gather is not pack_columns of "
              "run_block's taps")
    log("  mesh gather: 6 blocks equal to pack_columns of run_block's "
        "taps, to the bit")


def phase_mesh_server(torch, device, channels: int, block: int,
                      nblocks: int = MESH_SERVER_BLOCKS) -> dict:
    """9b: the mesh engine's gather against its ``run_block``
    (:func:`mesh_gather_check`); a ``KiwiServer`` over a mesh engine:
    four SND listeners and one W/F socket over in-process sockets; then
    ``run_server --mesh`` built on the card."""
    import asyncio
    from flydog_sdr_gps_tpu_torch import run_server
    from flydog_sdr_gps_tpu_torch.numerology import UI_SRATE_30M, WF_OUT_PX
    from flydog_sdr_gps_tpu_torch.runtime import ShardedStreamEngine
    from flydog_sdr_gps_tpu_torch.server import KiwiServer
    mesh_gather_check(torch, device, channels, block)
    counters = kernel_counters()
    eng = make_mesh_engine(torch, device, channels, block)
    server = KiwiServer(eng, realtime=False, port=0)
    auth = "SET auth t=kiwi p="
    script = [
        ("usb 14200.00", [auth, "SET mod=usb low_cut=300 high_cut=2700 "
                          "freq=14200.00", "SET compression=0"]),
        ("am adpcm", [auth, "SET mod=am low_cut=-4000 high_cut=4000 "
                      "freq=7100.000", "SET compression=1"]),
        ("lsb 14203.6", [auth, "SET mod=lsb low_cut=-2700 high_cut=-300 "
                         "freq=14203.600", "SET compression=0"]),
        ("iq", [auth, "SET mod=iq low_cut=-5000 high_cut=5000 "
                "freq=14200.000"]),
    ]
    snd = {i: Sock() for i in range(len(script))}
    wf = Sock()

    async def drive():
        for i, (_what, cmds) in enumerate(script):
            conn = await server.open_stream(f"m{i}", "SND", snd[i],
                                            "127.0.0.1")
            for cmd in cmds:
                await conn.handle_set(cmd, "SND")
        conn = await server.open_stream("m0", "W/F", wf, "127.0.0.1")
        for cmd in (auth, "SET zoom=0 start=0", "SET wf_speed=4"):
            await conn.handle_set(cmd, "W/F")
        check(eng.seq == 0, "a block ran before the server was started")
        for fn in counters.values():
            fn.launches = 0                 # the mesh server's run starts
        server.start_tasks()
        t0 = time.monotonic()
        while min(len(s.of(b"SND")) for s in snd.values()) < nblocks:
            await asyncio.sleep(0.002)
            check(time.monotonic() - t0 < 300, "the mesh server stalled")
        blocks = eng.seq
        launches = {k: fn.launches for k, fn in counters.items()}
        await server.stop()
        await asyncio.sleep(0.05)
        return blocks, launches
    t_from = time.monotonic_ns()            # the server's spans start here
    blocks, launches = asyncio.run(drive())
    check(server._warm_buckets == {4},
          f"warm buckets {server._warm_buckets}, not the one served (4)")
    n_dev = MESH[0] * MESH[1]
    for k in ("stage2", "agc_envelope", "sam_pll"):
        check(launches[k] == n_dev * blocks, f"kernel {k}: {launches[k]} "
              f"launches in {blocks} blocks of the mesh server")
    check(launches["stage2_rot"] == 0, "the mesh server ran kernel 1")
    fs = eng.params.fs_out
    heard = {}
    for i in (0, 1, 2):
        pkts = [parse_snd(p) for p in snd[i].of(b"SND")]
        check([p[1] for p in pkts] == list(range(len(pkts))),
              f"mesh listener {i}: sequence numbers")
        a = snd_audio(snd[i])
        check(bool(np.isfinite(a).all()), f"mesh listener {i}: audio")
        heard[script[i][0]] = dominant_hz(a[len(a) // 4:], fs)
    log(f"  mesh server: {blocks} blocks, launches {launches}; heard, Hz: "
        f"{heard}")
    check(abs(heard["usb 14200.00"] - 1800.0) <= 40,
          f"USB 14200.00 hears {heard['usb 14200.00']} Hz, not 1800 +- 40")
    check(abs(heard["am adpcm"] - 1000.0) <= 40, "the AM lane")
    check(abs(heard["lsb 14203.6"] - 1800.0) <= 40, "the LSB lane")
    rows = wf_rows(wf)
    check(len(rows) >= nblocks // 2, f"mesh W/F: {len(rows)} rows")
    want_px = sorted(round(f / UI_SRATE_30M * WF_OUT_PX)
                     for f in WF_CARRIERS_HZ)
    got_px = strongest_peaks(rows[-1][2].astype(np.float64), 3)
    check(all(abs(g - w) <= 1 for g, w in zip(got_px, want_px)),
          f"mesh W/F peaks {got_px} are not at the carriers {want_px}")
    starts = np.diff(np.asarray(block_starts(server_spans(t_from)))) * 1e3
    steady = starts[2:]
    block_ms = eng.params.ddc.adc_block / eng.params.adc_clock * 1e3
    del server, eng
    # the entry point: --mesh time=1,chan=1 builds on the card; a mesh of
    # more devices than the host has cards ends naming the count
    _srv, _cfg, built = run_server.build(run_server.parse_args(
        ["--mesh", "time=1,chan=1", "--channels", "8"]))
    check(isinstance(built, ShardedStreamEngine) and built.device.type ==
          "cuda" and built.mesh.shape == {"time": 1, "chan": 1},
          "run_server --mesh time=1,chan=1 did not build a mesh engine")
    del _srv, built
    cards = torch.cuda.device_count()
    refusal = None
    if cards != 4:
        try:
            run_server.build(run_server.parse_args(
                ["--mesh", "time=2,chan=2", "--channels", "8"]))
        except SystemExit as e:
            refusal = str(e.code)
        check(refusal is not None and
              f"needs 4 cards; this host has {cards}" in refusal,
              f"run_server --mesh time=2,chan=2 on {cards} cards: {refusal}")
    log(f"  run_server --mesh time=1,chan=1 built on the card; time=2,"
        f"chan=2 ended with: {refusal}")
    return dict(blocks=blocks, launches=launches, heard_hz=heard,
                wf_peaks_px=got_px, ms_blocks=[float(v) for v in starts],
                ms_median=float(np.median(steady)),
                realtime_factor=float(len(steady) * block_ms
                                      / steady.sum()),
                run_server_refusal=refusal)


def stage2_fft_library(torch, timer, plan, y, ref) -> dict:
    """Kernel 2's function as ``torch.fft`` calls (the reference's
    ``"fft"`` method, ``channelizer.stage2_fft``): its error against the
    plain version, its time and the device memory it takes."""
    from flydog_sdr_gps_tpu_torch.ops import channelizer as chz
    fn = lambda: chz.stage2_fft(plan, y)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = fn()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    err = float((got - ref).abs().max())
    del got
    log(f"  library call for stage2: torch.fft (stage2_fft, nfft "
        f"{chz.stage2_fft_size(plan, y.shape[0])}), max|err| {err:.3e} vs "
        f"plain (bound 1.000e-04), {peak:.3f} GB above its input")
    check(err <= 1e-4, f"stage2_fft vs stage2_plain: {err}")
    return dict(library_fft_ms=timer(fn, reps=3), library_fft_peak_gb=peak,
                library_fft_max_abs_err=err)


def phase_stage2_fft(torch, device, channels: int, block: int) -> dict:
    """9c: the slice with ``RxParams(stage2="fft")`` held to the unfused
    slice (kernel 2) on the same blocks, and phase 2's tone through the
    FFT method."""
    from flydog_sdr_gps_tpu_torch.ops import channelizer as chz
    from flydog_sdr_gps_tpu_torch.ops import nco
    from flydog_sdr_gps_tpu_torch.runtime import DeviceSceneSource
    want = []
    eng = make_engine(torch, device, channels, block, "unfused")
    for _ in range(2):
        # copied: the compiled step's next block overwrites its taps
        want.append(eng.run_block().iq_pre_fir.clone())
    del eng
    eng = make_engine(torch, device, channels, block, "fft")
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    err, ms = 0.0, []
    for w in want:
        t0 = time.perf_counter()
        got = eng.run_block().iq_pre_fir
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        err = max(err, float((got - w).abs().max()))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del eng, got, want
    log(f"  slice with stage2=\"fft\": max |iq - kernel 2's| {err:.3e} "
        f"(bound 1e-4); blocks {[round(v, 2) for v in ms]} ms, peak "
        f"memory {peak_gb:.3f} GB ({base_gb:.3f} GB allocated before the "
        "blocks, the engine included)")
    check(err <= 1e-4, f"stage2 fft slice: {err}")
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
        x = src.next_block()
        y1 = chz.stage1_apply(plan, torch.cat([st.x_tail, x]), bank,
                              st.phi1, dphi)
        y_ext = torch.cat([st.y_tail, y1])
        outs.append(chz.stage2_fft(plan, y_ext)[:, 0].cpu().numpy())
        st = chz.DDCState(x_tail=x[-plan.tail1:].clone(),
                          y_tail=y_ext[-plan.tail2:].clone(),
                          phi1=nco.advance(st.phi1, dphi, plan.k1))
    audio = np.concatenate(outs)[64:]
    f, amp, sinad = tone_metrics(audio, plan.fs_out)
    log(f"  tone through the FFT method: {f:.1f} Hz, amplitude {amp:.5f}, "
        f"SINAD {sinad:.2f} dB (want >= 80)")
    check(abs(f - f_off) < plan.fs_out / len(audio) * 4
          and abs(amp - 1.0) < 0.01 and sinad >= 80.0,
          f"stage2 fft tone: {f} Hz, {amp}, {sinad} dB")
    return dict(max_abs_err=err, ms_blocks=ms, peak_mem_gb=peak_gb,
                base_mem_gb=base_gb, sinad_db=sinad, freq_hz=f, amplitude=amp)


def phase_lms_block(torch, device, timer, channels: int, block: int) -> dict:
    """9d: ``noise.lms_block`` in both modes through kernel 5 at (block,
    channels), against its plain version."""
    from flydog_sdr_gps_tpu_torch.ops import noise
    gen = torch.Generator(device=device)
    gen.manual_seed(99)
    t = torch.arange(block, device=device, dtype=torch.float32)[:, None]
    f = torch.empty((1, channels), device=device).uniform_(
        0.05, 1.0, generator=gen)
    x = 0.3 * torch.sin(f * t) + 0.1 * torch.randn(
        (block, channels), generator=gen, device=device)
    out = {}
    for notch in (True, False):
        p = noise.LmsParams(notch=notch)
        # adapted weights and a full delay line, as in a running receiver
        _, st = noise.lms_block(p, x.flip(0).contiguous(),
                                noise.init_lms(p, channels, device))
        n0 = noise.lms_chain_block.launches
        y, s = noise.lms_block(p, x, st)
        check(noise.lms_chain_block.launches == n0 + 1,
              "lms_block did not launch kernel 5 once")
        yr, sr = noise.lms_block_plain(p, x, st)
        err, scale = max_err(y, yr)
        werr = max_err(s.weights, sr.weights)[0]
        lerr = max_err(s.line, sr.line)[0]
        mode = "notch" if notch else "denoise"
        log(f"  lms_block {mode} ({block}, {channels}): max|err| {err:.3e} "
            f"(bound {1e-4 * scale:.3e}), weights {werr:.3e}, line "
            f"{lerr:.3e}")
        check(err <= 1e-4 * scale and werr <= 1e-4
              and lerr <= 1e-4 * scale, f"lms_block {mode}: {err}")
        out[mode] = dict(max_abs_err=err, bound=1e-4 * scale,
                         **timer.both(lambda: noise.lms_block(p, x, st)))
    timer.release()
    return out


# ---------------------------------------------------------------------------
# phase 10: the compiled step (CUDA graphs) against the eager step
# ---------------------------------------------------------------------------

# before block k of 10a: a SET that opens (then closes) each gate, the GPS
# clock's retune_all, a reload from the eager engine's checkpoint (which
# brings nb_wild back to its default, as the reference's does)
COMPILED_BLOCKS = 24
COMPILED_EVENTS = {
    3: ("set", 6, dict(freq_hz=7.1002e6, mode="sas")),
    5: ("set", 7, dict(freq_hz=14.2000e6, nr_notch_on=True)),
    7: ("set", 8, dict(freq_hz=9.999e6, nr_on=True)),
    9: ("set", 9, dict(freq_hz=7.1004e6, nb_on=True, nb_wild=True)),
    11: ("retune_all", 0.4e-6, None),
    13: ("load_state", None, None),
    15: ("set", 6, dict(mode="usb")),
    17: ("set", 7, dict(nr_notch_on=False)),
    19: ("set", 8, dict(nr_on=False)),
}


def compiled_event(eng, event, ckpt: str, eager) -> None:
    from flydog_sdr_gps_tpu_torch.ops import demod
    kind, arg, kw = event
    if kind == "set":
        kw = dict(kw)
        if "mode" in kw:
            kw["mode"] = demod.MODE_NAMES[kw["mode"]]
        eng.set_channel(arg, **kw)
    elif kind == "retune_all":
        eng.retune_all(eng.params.adc_clock * (1 + arg))
    elif kind == "load_state":
        if eng is eager:
            eng.save_state(ckpt)
        eng.load_state(ckpt)


def timed_block(torch, fn):
    """(result, wall ms to the end of the device work, host ms until
    ``fn`` returned, device ms between CUDA events around it)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    stop.record()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return out, (t2 - t0) * 1e3, (t1 - t0) * 1e3, start.elapsed_time(stop)


def first_difference(torch, got, want) -> float | None:
    """None when every tensor of ``got`` equals ``want``'s to the bit,
    else the largest absolute difference."""
    worst = None
    from flydog_sdr_gps_tpu_torch.runtime.stream import _state_leaves
    for g, w in zip(_state_leaves(got), _state_leaves(want)):
        if torch.equal(g, w):
            continue
        if g.is_complex():
            g, w = torch.view_as_real(g), torch.view_as_real(w)
        d = float((g.double() - w.double()).abs().max())
        worst = d if worst is None else max(worst, d)
    return worst


def phase_compiled(torch, device, channels: int, block: int,
                   small: int = 16, large: int = 32) -> dict:
    """10: (a) the compiled engine against the eager engine from one
    state and one source, through every gate, a retune and a reload;
    (b) the serving path with a bucket growth prepared on a thread."""
    import threading
    from flydog_sdr_gps_tpu_torch.models import rx_channel as rx
    from flydog_sdr_gps_tpu_torch.runtime.stream import _state_leaves
    counters = kernel_counters()
    out_dir = HERE / "build"
    out_dir.mkdir(exist_ok=True)
    ckpt = str(out_dir / "chip_smoke_compiled.pkl")

    # -- (a) captured against eager -------------------------------------
    eager = make_engine(torch, device, channels, block, "fused",
                        use_graphs=False)
    graphs = make_engine(torch, device, channels, block, "fused")
    check(graphs.compiled is not None and eager.compiled is None,
          "the card's default engine is not the compiled one")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    stats = {"eager": [], "graphs": []}
    launches = {"eager": [], "graphs": []}
    diffs, captured_at = [], []
    for fn in counters.values():
        fn.launches = 0                     # the compiled path's run starts
    for b in range(COMPILED_BLOCKS):
        ev = COMPILED_EVENTS.get(b)
        if ev is not None:
            for eng in (eager, graphs):
                compiled_event(eng, ev, ckpt, eager)
        check(rx.gates(graphs.tuning) == rx.gates(eager.tuning),
              "the engines' gates differ")
        row = {}
        for name, eng in (("eager", eager), ("graphs", graphs)):
            before = {k: fn.launches for k, fn in counters.items()}
            n_graphs = len(graphs.compiled.graphs)
            taps, wall, host, dev = timed_block(torch, eng.run_block)
            launches[name].append({k: fn.launches - before[k]
                                   for k, fn in counters.items()})
            stats[name].append((wall, host, dev))
            if name == "graphs" and len(graphs.compiled.graphs) > n_graphs:
                captured_at.append(b)
            row[name] = rx.RxTaps(**{f.name: getattr(taps, f.name).clone()
                                     for f in dataclasses.fields(taps)})
        d_taps = first_difference(torch, row["graphs"], row["eager"])
        d_state = first_difference(torch, graphs.state, eager.state)
        diffs.append((d_taps, d_state))
        for name in ("audio", "audio2", "iq_pre_fir", "iq_post_agc",
                     "smeter_dbm"):
            check(bool(torch.isfinite(getattr(row["graphs"], name)).all()),
                  f"phase 10: non-finite {name}")
    path_launches = {k: fn.launches for k, fn in counters.items()}
    torch.cuda.synchronize()                # the compiled path's run ends
    torch.cuda.empty_cache()
    pool_gb = (torch.cuda.memory_reserved() - reserved0) / 1e9
    step = graphs.compiled
    buffers_gb = sum(t.numel() * t.element_size()
                     for t in _state_leaves(step.taps) + [step.x]) / 1e9
    step_capture_ms = capture_ms(
        step.graphs, lambda v: str(int(v)) if isinstance(v, bool) else str(v))
    # the launch count of one block and of its back half, eager, and of
    # one replayed block
    eager_ops = device_ops(torch, eager.run_block)
    graph_ops = device_ops(torch, graphs.run_block)
    x = eager.source.next_block()
    _, iq = rx._ddc(eager.params, eager.state, eager.tuning, x)
    back_ops = device_ops(torch, lambda: rx.audio_back_half(
        eager.params, eager.state, eager.tuning, iq))
    del x, iq
    bad = [(b, d) for b, d in enumerate(diffs) if d != (None, None)]
    log(f"  captured against eager over {COMPILED_BLOCKS} blocks: "
        f"{'equal to the bit in every block (taps and state)' if not bad else f'differences (block, (taps, state) max abs): {bad}'}")
    check(not bad, f"the captured step differs from the eager step: {bad}")
    check(launches["graphs"] == launches["eager"],
          f"launches a block differ: {launches}")
    steady = [b for b in range(2, COMPILED_BLOCKS) if b not in captured_at]

    def med(name, i):
        return statistics.median(stats[name][b][i] for b in steady)
    summary = {name: dict(wall_ms=med(name, 0), host_ms=med(name, 1),
                          device_ms=med(name, 2))
               for name in stats}
    del eager, graphs, step, row

    # -- (b) serving: a bucket growth prepared on a thread -------------
    def subs(bucket):
        return serve_channels(64, channels)[:bucket]
    eager = make_serve_engine(torch, device, channels, block,
                              use_graphs=False)
    graphs = make_serve_engine(torch, device, channels, block)
    block_ms = graphs.params.ddc.adc_block / graphs.params.adc_clock * 1e3
    serve_ms, warm, errors, equal = [], None, [], True
    key_large = None

    def prewarm():
        try:
            graphs.prewarm_gather(large)
        except Exception as e:              # noqa: BLE001 — checked below
            errors.append(repr(e))
    nserve, grow = 12, 7
    for b in range(nserve):
        bucket = small if b < grow else large
        if b == 2:
            warm = threading.Thread(target=prewarm)
            warm.start()
        if b == grow:
            warm.join()
            check(not errors, f"prewarm_gather failed: {errors}")
            key_large = ("gather", large) + rx.gates(graphs.tuning)
            check(key_large in graphs.compiled.graphs,
                  "the bucket was not captured off the loop")
        n_graphs = len(graphs.compiled.graphs)
        t0 = time.perf_counter()
        got = graphs.fetch(graphs.run_block_gather(subs(bucket)))
        serve_ms.append((time.perf_counter() - t0) * 1e3)
        if b >= grow:
            check(len(graphs.compiled.graphs) == n_graphs,
                  "a capture ran on the serving loop after the growth")
        want = eager.fetch(eager.run_block_gather(subs(bucket)))
        equal &= bool(np.array_equal(got, want))
    check(equal, "a served block differs from the eager engine's")
    during = serve_ms[2:grow]
    log(f"  serving, bucket {small} then {large} (prepared on a thread from "
        f"block 2, served from block {grow}): served ms "
        f"{[round(v, 2) for v in serve_ms]}; every result equal to the "
        f"eager engine's; longest block while the thread captured "
        f"{max(during):.2f} ms (block period {block_ms:.3f} ms)")
    # a block stalls when it misses the real-time budget
    check(max(serve_ms[1:]) < block_ms, "a served block stalled")
    prep_ms, = capture_ms({key_large: None}).values()
    del eager, graphs
    return dict(launches=path_launches, blocks=COMPILED_BLOCKS,
                steady_blocks=steady, captured_at=captured_at,
                ms=summary, ms_blocks={k: [list(v) for v in vs]
                                       for k, vs in stats.items()},
                graphs=len(step_capture_ms), capture_ms=step_capture_ms,
                pool_gb=pool_gb, buffers_gb=buffers_gb,
                eager_block=eager_ops, replayed_block=graph_ops,
                back_half=back_ops, serve_ms=serve_ms,
                prewarm_capture_ms=prep_ms, block_period_ms=block_ms)


PROGRAM_BLOCKS = 8          # 11a, 11b, 11d: blocks of each instance
PROGRAM_CHUNKS = 5          # 11c: 0.4 s chunks a sky


def reserved_gb(torch) -> float:
    """Device memory the caching allocator holds, caches emptied."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved() / 1e9


def held_gb(torch, instances: dict) -> dict:
    """The device memory each of ``instances`` holds, in GB: what the
    caching allocator gives back to the card when it is dropped
    (``reserved``: its tensors' segments and its graphs' pools) and the
    bytes of its live tensors (``allocated``; a graph pool's blocks are
    not live between replays), one after another in the dict's order
    (the dict is emptied).  The caller drops every other reference
    first (its outputs too)."""
    import gc
    held = {}
    for key in list(instances):
        before = (reserved_gb(torch), torch.cuda.memory_allocated() / 1e9)
        del instances[key]
        gc.collect()
        after = (reserved_gb(torch), torch.cuda.memory_allocated() / 1e9)
        held[key] = {"reserved": before[0] - after[0],
                     "allocated": before[1] - after[1]}
    return held


def above_eager(held: dict) -> float:
    """GB of the card the compiled instance (key True) holds beyond the
    eager one."""
    return held[True]["reserved"] - held[False]["reserved"]


def steady_median(rows: list, first: int = 2) -> dict:
    """Median wall, host and device ms over ``rows`` (wall, host, device)
    after the ``first`` (the eager run and capture of a key)."""
    rest = rows[first:] or rows
    return {name: statistics.median(r[i] for r in rest)
            for i, name in enumerate(("wall_ms", "host_ms", "device_ms"))}


def capture_ms(graphs: dict, fmt=str) -> dict:
    """Each key of ``graphs`` (a ``GraphSet``'s) with the wall ms of its
    capture: the tracer's last ``graphs.capture`` span of that key."""
    from flydog_sdr_gps_tpu_torch.utils.trace import get_trace
    last = {s.detail: (s.t1 - s.t0) / 1e6
            for s in get_trace().span_records() if s.name == "graphs.capture"}
    return {"/".join(fmt(v) for v in k): round(last[k], 3) for k in graphs}


def phase_programs(torch, device, channels: int, block: int,
                   gps_chunk_s: float = 0.4) -> dict:
    """11: the compiled programs beside the block step, each against an
    eager instance of itself run side by side on the same inputs."""
    out = {}
    counters = kernel_counters()
    from flydog_sdr_gps_tpu_torch.models import rx_channel as rx
    from flydog_sdr_gps_tpu_torch.runtime import (DeviceSceneSource,
                                                  StreamEngine)
    from flydog_sdr_gps_tpu_torch.server.wf_service import WfSubsystem
    params = rx.RxParams(num_channels=channels, audio_block=block)
    n = params.ddc.adc_block

    # -- (a) the scene source, and the compiled block over it ----------
    from flydog_sdr_gps_tpu_torch.extensions import navtex
    symbols = np.random.default_rng(162).integers(0, 4, 162).tolist()
    bits = navtex_bits(navtex.encode_text(NAVTEX_TEXT))
    tones = SCENE + [
        FSK_TONE + (("fsk", 8192, 12000 / 8192, symbols, 200),),
        (NAVTEX_KHZ * 1e3 + 1000.0, 0.05,
         ("fsk", 120, 170.0, bits, len(bits) + 200))]

    def source(use_graphs):
        return DeviceSceneSource(tones=tones, noise_rms=3e-4, block=n,
                                 device=device, seed=7,
                                 use_graphs=use_graphs)
    srcs = {True: source(True), False: source(False)}
    rows = {"eager": [], "graphs": []}
    equal = True
    for b in range(PROGRAM_BLOCKS):
        got, *t_g = timed_block(torch, srcs[True].next_block)
        want, *t_e = timed_block(torch, srcs[False].next_block)
        rows["eager"].append(t_e)
        rows["graphs"].append(t_g)
        equal &= bool(torch.equal(got, want))
        check(bool(torch.isfinite(got).all()), "11a: a non-finite block")
    check(equal, "11a: the compiled source differs from the eager one")
    out["source"] = dict(
        equal=equal, blocks=PROGRAM_BLOCKS,
        ms={k: steady_median(v) for k, v in rows.items()},
        capture_ms=capture_ms(srcs[True].graphs),
        fsk_rows=srcs[True]._fsk_cap)
    del want, got
    held = held_gb(torch, srcs)
    out["source"].update(memory_gb=held, memory_above_eager_gb=above_eager(
        held))
    # the compiled block (phase 10a's engine) over each source
    engines = {}
    for name, use in (("eager_source", False), ("compiled_source", True)):
        src = DeviceSceneSource(tones=SCENE, noise_rms=3e-4, block=n,
                                device=device, use_graphs=use)
        engines[name] = tune_slice(StreamEngine(params, src, device=device))
    rows = {k: [] for k in engines}
    for fn in counters.values():
        fn.launches = 0                     # the path's run starts
    for b in range(PROGRAM_BLOCKS):
        taps = {}
        for name, eng in engines.items():
            t, *ms = timed_block(torch, eng.run_block)
            rows[name].append(ms)
            taps[name] = t.audio.clone()
        check(bool(torch.equal(taps["eager_source"],
                               taps["compiled_source"])),
              "11a: the blocks over the two sources differ")
    out["launches_block"] = {k: fn.launches for k, fn in counters.items()}
    out["block"] = {k: steady_median(v) for k, v in rows.items()}
    del engines, taps
    between_phases(torch)

    # -- (b) the waterfall: four slots, one a two-block zoom -----------
    # the eager twin: the port's eager arithmetic on a state of its own
    from flydog_sdr_gps_tpu_torch.models import waterfall as wf_model
    eng = make_engine(torch, device, channels, block, "fused")
    keys = [(0, "cma"), (7, "max"), (13, "min"), (14, "cma")]
    hz = 30.0e6 / (1024 << 14)
    wf = WfSubsystem(eng.params.adc_clock, 30.0e6, capacity=4, device=device)
    slots = [wf.attach(z, int((10.0e6 - 30.0e6 / (2 << z)) / hz), i)
             for z, i in keys]
    check(slots[3].params.ingest_blocks(n) == 2,
          "11b: z14 does not take two blocks")
    twins = [dict(st=wf_model.init_state(s.params, device), acc=[],
                  tune=tuple(t.clone() for t in s.tune)) for s in slots]

    def eager_ingest():
        for s, e in zip(slots, twins):
            e["acc"].append(eng._last_x.clone())
            if len(e["acc"]) == s.params.ingest_blocks(n):
                e["st"] = wf_model.wf_ingest(s.params, e["st"],
                                             torch.cat(e["acc"]), *e["tune"])
                e["acc"] = []

    def eager_rows():
        return [wf_model.wf_frame(s.params, e["st"], "hanning", s.interp,
                                  mask=wf._device_mask(s.cf, s.params.span)
                                  ).cpu().numpy()
                for s, e in zip(slots, twins)]
    rows = {"eager": [], "graphs": []}
    row_ms = {"eager": [], "graphs": []}
    equal = True
    for b in range(PROGRAM_BLOCKS):
        if b == 5:
            wf.set_masked([(9.99e6, 10.01e6)])
        eng.run_block()
        _, *ms = timed_block(torch, eager_ingest)
        rows["eager"].append(ms)
        t0 = time.perf_counter()
        want = eager_rows()
        row_ms["eager"].append((time.perf_counter() - t0) * 1e3)
        _, *ms = timed_block(torch, lambda: wf.ingest(eng._last_x,
                                                      eng._x_ready))
        rows["graphs"].append(ms)
        t0 = time.perf_counter()
        got = [wf.frame(s) for s in slots]
        row_ms["graphs"].append((time.perf_counter() - t0) * 1e3)
        equal &= all(np.array_equal(a, c) for a, c in zip(got, want))
        for r in got:
            check(bool(np.isfinite(r).all()), "11b: a non-finite row")
    check(equal, "11b: the compiled waterfall's rows differ from eager")
    out["waterfall"] = dict(
        equal=equal, blocks=PROGRAM_BLOCKS,
        ms={k: steady_median(v) for k, v in rows.items()},
        frame_ms={k: statistics.median(v[2:]) for k, v in row_ms.items()},
        capture_ms=capture_ms(wf.graphs))
    instances = {True: (wf, slots), False: twins}
    del got, want, wf, slots, twins
    held = held_gb(torch, instances)
    out["waterfall"].update(memory_gb=held,
                            memory_above_eager_gb=above_eager(held))
    del eng
    between_phases(torch)
    log("  11b: a short phase-5 run for the fan-out (8 blocks)")
    srv = phase_server(torch, device, channels=channels, block=block,
                       nblocks=8)
    out["waterfall"]["server_fanout_ms_per_block"] = srv["fanout_ms_per_block"]
    out["waterfall"]["server_realtime_factor"] = srv["realtime_factor"]
    del srv
    between_phases(torch)

    # -- (c) the GPS sky and the tracking step -------------------------
    from flydog_sdr_gps_tpu_torch.models.gps import manager, scene, tracking
    rx_ = scene.ecef_from_lla(*GPS_LLA)
    ephs = scene.visible_constellation(rx_, GPS_T0, n_sats=8)
    gal = scene.visible_galileo(rx_, GPS_T0, n_sats=4)
    chunk = int(round(gps_chunk_s * tracking.TrackParams().fs))
    gps = {}
    for noise_ in (0.0, 0.9):
        skies = {g: scene.GpsScene(rx_, ephs, GPS_T0, duration=60.0,
                                   clock_ppm=GPS_PPM, noise=noise_,
                                   amplitude=0.5, galileo_ephemerides=gal,
                                   device=device, use_graphs=g)
                 for g in (False, True)}
        mgrs = {g: manager.GpsManager(prns=tuple(ephs) + GPS_DECOYS,
                                      galileo_prns=tuple(gal), device=device,
                                      use_graphs=g) for g in (False, True)}
        rows = {g: {"sky": [], "process": []} for g in skies}
        tracking.track_epochs.launches = 0
        equal = True
        for c in range(PROGRAM_CHUNKS):
            xs = {}
            for g in skies:
                xs[g], *ms = timed_block(
                    torch, lambda: skies[g].next_block(chunk))
                rows[g]["sky"].append(ms)
            equal &= bool(torch.equal(xs[True], xs[False]))
            for g in skies:
                _, *ms = timed_block(
                    torch, lambda: mgrs[g].process(xs[g], search=c == 0))
                rows[g]["process"].append(ms)
            equal &= set(mgrs[True].channels) == set(mgrs[False].channels)
            equal &= all(ch.chips == mgrs[False].channels[p].chips
                         for p, ch in mgrs[True].channels.items())
            equal &= all(torch.equal(a, b) for a, b in zip(
                _tensors(mgrs[True]._track_state),
                _tensors(mgrs[False]._track_state)))
        check(equal, f"11c: the compiled sky or tracking step differs "
              f"(noise {noise_})")
        check(len(mgrs[True].channels) >= 4,
              f"11c: {len(mgrs[True].channels)} rows tracking")
        gps[f"noise_{noise_}"] = dict(
            equal=equal, chunks=PROGRAM_CHUNKS,
            rows=len(mgrs[True].channels),
            ms={("graphs" if g else "eager"): {
                k: steady_median(v, first=1) for k, v in r.items()}
                for g, r in rows.items()},
            capture_ms=dict(**capture_ms(skies[True].graphs),
                            **capture_ms(mgrs[True]._graphs.graphs)),
            gps_track_launches=tracking.track_epochs.launches)
        del xs
        held = held_gb(torch, {g: (skies.pop(g), mgrs.pop(g))
                               for g in (True, False)})
        gps[f"noise_{noise_}"].update(memory_gb=held,
                                      memory_above_eager_gb=above_eager(held))
    out["gps"] = gps
    out["launches_gps"] = gps["noise_0.9"]["gps_track_launches"]
    between_phases(torch)

    # -- (d) the mesh step ---------------------------------------------
    # both over an uncompiled source, so that what each holds beyond the
    # other is its mesh step's
    meshes = {g: make_mesh_engine(torch, device, channels, block,
                                  use_graphs=g, source_graphs=False)
              for g in (True, False)}
    for e in meshes.values():
        tune_slice(e)
    check(meshes[True].program is not None and meshes[True].program.whole,
          "11d: the one-card mesh is not one program")
    rows = {False: [], True: []}
    launches = {False: [], True: []}
    equal = True
    for fn in counters.values():
        fn.launches = 0                     # the path's run starts
    mesh_launches = None
    for b in range(PROGRAM_BLOCKS):
        taps = {}
        for g, e in meshes.items():
            mesh_events(torch, e, b)
            before = {k: fn.launches for k, fn in counters.items()}
            t, *ms = timed_block(torch, e.run_block)
            rows[g].append(ms)
            launches[g].append({k: fn.launches - before[k]
                                for k, fn in counters.items()})
            taps[g] = [getattr(t, f.name).clone()
                       for f in dataclasses.fields(t)]
        equal &= all(torch.equal(a, c) for a, c in zip(taps[True],
                                                        taps[False]))
        equal &= all(torch.equal(a, c) for a, c in zip(
            _tensors(meshes[True].state), _tensors(meshes[False].state)))
    check(equal, "11d: the compiled mesh step differs from the eager one")
    check(launches[True] == launches[False],
          f"11d: launches a block differ: {launches}")
    mesh_launches = {k: sum(l[k] for l in launches[True])
                     for k in counters}
    prog = meshes[True].program
    graphs = {k: g for gs in prog._graphs.values() for k, g in
              gs.graphs.items()}
    replays = PROGRAM_BLOCKS - len(graphs)
    out["mesh"] = dict(
        equal=equal, blocks=PROGRAM_BLOCKS, path="one graph a block (whole)",
        ms={("graphs" if g else "eager"): steady_median(v)
            for g, v in rows.items()},
        launches_per_block=launches[True][-1], graph_replays=replays,
        replays_per_block=1, graphs=len(graphs),
        capture_ms=capture_ms(graphs))
    out["launches_mesh"] = mesh_launches
    del prog, graphs, taps, t, e
    held = held_gb(torch, meshes)
    out["mesh"].update(memory_gb=held, memory_above_eager_gb=above_eager(held))
    return out


def _tensors(obj) -> list:
    """Every tensor of nested dataclasses and lists, in order."""
    if obj is None:
        return []
    if hasattr(obj, "data_ptr"):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for x in obj for t in _tensors(x)]
    if not dataclasses.is_dataclass(obj):
        return []
    return [t for f in dataclasses.fields(obj)
            for t in _tensors(getattr(obj, f.name))]


def between_phases(torch) -> None:
    """Free what the last phase left (its engines and servers hold
    reference cycles, and each compiled engine a graph memory pool)
    before the next phase starts, and say what stays allocated."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"  (between phases: {torch.cuda.memory_allocated() / 1e9:.3f} GB "
        f"allocated, {torch.cuda.memory_reserved() / 1e9:.3f} GB reserved)")


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
    from flydog_sdr_gps_tpu_torch.models.gps import tracking

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
    kern["gps_track"] = gps_kernel_case(torch, timer, device)
    kern["spectral_nr"] = spectral_nr_case(torch, timer, device,
                                           c_main=4096, block=2048)
    for name, r in kern.items():
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        lib = (f"{r['library_call']} {r['library_ms']:.4f} ms (layout change "
               "not timed)"
               if r["library_ms"] is not None else "no single library call")
        if "library_fft_ms" in r:
            lib += (f"; torch.fft (the \"fft\" method) "
                    f"{r['library_fft_ms']:.4f} ms, "
                    f"{r['library_fft_peak_gb']:.3f} GB above its input")
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
    k7 = kern["spectral_nr"]["mmse"]
    log(f"  spectral_nr (the row above: the served rule, \"subtract\"); "
        f"\"mmse\" {k7['ms']:.4f} ms ({k7['ms_host_paced']:.4f} "
        f"host-paced), plain {k7['plain_ms']:.3f} ms, bound "
        f"{k7['bound_ms']:.4f} ms by {k7['bound_by']}, share of bound "
        f"{k7['bound_ms'] / k7['ms']:.3f}  [{card}]")
    check(k7["bound_ms"] / k7["ms"] <= 1.05, "spectral_nr mmse is under its "
          "bound")
    if profile:
        log(gps_clock_split(torch, device))
    lms = kern["lms_chain"]
    log(f"  lms_chain (the row above: every stage on) by enables, ms: "
        f"{lms['ms_by_enables']}; bounds of what the function needs, ms: "
        f"{lms['bound_ms_by_enables']}  [{card}]")
    for name, ms in lms["ms_by_enables"].items():
        check(lms["bound_ms_by_enables"][name] / ms <= 1.05,
              f"lms_chain {name} is under its bound")
    between_phases(torch)
    log("phase 2: DDC tone fidelity")
    ddc = phase_ddc(torch, device, block=2048)
    between_phases(torch)
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
    between_phases(torch)
    log("phase 3b: the 20.25 kHz chain (rx3.wf3's rate, d2=4), C=4096, "
        "audio_block=2048")
    s3b = phase_slice_20k(torch, device, channels=4096, block=2048)
    log(f"  realtime factor {s3b['realtime_factor']} (signal time / wall "
        f"time of 6 blocks after 2 warm-up blocks, "
        f"{s3b['block_period_ms']} ms per block period, adc_block "
        f"{s3b['adc_block']}); per block median {s3b['ms_median']} ms, min "
        f"{s3b['ms_min']}, max {s3b['ms_max']}; fs_out {s3b['fs_out']} Hz  "
        f"[{card}]")
    log(f"  per-block ms: {[round(v, 2) for v in s3b['ms_blocks']]}")
    between_phases(torch)
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
        f"blocks), wf frame {sv['wf_frame_ms']:.4f} ms, spectral_nr_block "
        f"(two FFTs and kernel 7) {sv['spectral_nr_ms']:.3f} ms, fetch of "
        f"a bucket-32 array {sv['fetch_ms_bucket32']:.4f} ms; bytes fetched "
        f"a block "
        f"{sv['bytes_fetched']}  [{card}]")
    log(f"  served block without waterfall, ms: NR lanes on "
        f"{[round(v, 2) for v in sv['served_ms_nr_on']]}, LMS lane off "
        f"{[round(v, 2) for v in sv['served_ms_lms_off']]}, all NR off "
        f"{[round(v, 2) for v in sv['served_ms_nr_off']]}, LMS on for every "
        f"channel {[round(v, 2) for v in sv['served_ms_lms_every_channel']]}"
        f"  [{card}]")
    if sv["profile"]:
        log(sv["profile"])
    between_phases(torch)
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
        f"{sr['fanout_ms_per_block']:.3f} (with an eager source and a "
        f"waterfall on the engine's stream: 51.0-62.0); what the "
        f"event loop loses: a "
        f"5 ms sleep came back late by mean {sr['loop_lag_ms']['mean']:.3f} "
        f"ms, p99 {sr['loop_lag_ms']['p99']:.3f}, max "
        f"{sr['loop_lag_ms']['max']:.3f} ({sr['loop_lag_ms']['n']} sleeps); "
        f"aiohttp present: {sr['aiohttp']}  [{card}]")
    check(sr["realtime_factor"] >= 1.0, "the server does not hold real time")
    autorun = ["wspr:14095.6", "FT8:14074"]
    between_phases(torch)
    log(f"phase 5 with autorun: the same server with autorun={autorun} "
        f"beside the 32 listeners, {AUTORUN_BLOCKS} blocks (an FT8 capture "
        "completes in its 80th), then the same run without autorun")
    sra = phase_server(torch, device, channels=4096, block=2048,
                       nblocks=AUTORUN_BLOCKS, autorun=autorun)
    between_phases(torch)
    srn = phase_server(torch, device, channels=4096, block=2048,
                       nblocks=AUTORUN_BLOCKS)
    log(f"  with autorun: per block median {sra['ms_median']} ms, min "
        f"{sra['ms_min']}, max {sra['ms_max']}; realtime factor "
        f"{sra['realtime_factor']}; without it in the same call: median "
        f"{srn['ms_median']} ms, factor {srn['realtime_factor']} (phase 5, "
        f"14 blocks: {sr['realtime_factor']}); fan-out "
        f"{sra['fanout_ms_per_block']:.3f} / {srn['fanout_ms_per_block']:.3f}"
        f" ms a block  [{card}]")
    log(f"  per-block ms with autorun: {[round(v, 2) for v in sra['ms_blocks']]}")
    check(sra["realtime_factor"] >= 1.0,
          "the server with autorun does not hold real time")
    between_phases(torch)
    log("phase 6a: GPS alone, cold start, 12 rows, 0.4 s chunks of the "
        "run_server --gps sky on the card")
    g = phase_gps(torch, device)
    med = g["ms_median"]
    log(f"  ms a chunk (median, host clock around a sync): scene "
        f"{med['scene']:.3f}, process without a search (kernel 6, the "
        f"packed fetch, the host's bit sync and nav decode) "
        f"{med['process']:.3f}, of which kernel 6 alone "
        f"{kern['gps_track']['ms']:.3f} (phase 1, same shape), a chunk with "
        f"a search {med['search']:.3f} ({g['searches']} searches), solve "
        f"{med['solve'] if med['solve'] is None else round(med['solve'], 3)}"
        f"; IF/wall {g['if_over_wall']:.3f} over {g['chunks']} chunks  "
        f"[{card}]")
    between_phases(torch)
    log("phase 6b: the server of phase 5 with the GPS receiver beside it "
        "(the run_server --gps sky, paced at real time)")
    gps_rec, _rx, _want, _decoys = make_gps(device, realtime=True)
    srg = phase_server(torch, device, channels=4096, block=2048,
                       nblocks=24, gps=gps_rec)
    log(f"  served by the server with GPS: per block median "
        f"{srg['ms_median']} ms, min {srg['ms_min']}, max {srg['ms_max']}; "
        f"realtime factor {srg['realtime_factor']} (phase 5 without GPS: "
        f"{sr['ms_median']} ms, factor {sr['realtime_factor']}; ratio "
        f"{srg['realtime_factor'] / sr['realtime_factor']:.4f}, kernel 6 at "
        f"K={tracking.CLUSTER}); encode "
        f"{srg['encode_ms_per_block']:.3f}, fan-out "
        f"{srg['fanout_ms_per_block']:.3f} ms a block  [{card}]")
    log(f"  per-block ms: {[round(v, 2) for v in srg['ms_blocks']]}")
    check(srg["realtime_factor"] >= 1.0,
          "the server with GPS does not hold real time")
    between_phases(torch)
    log("phase 7: the decoders' front ends on the card (WSPR, FT8, FT4 "
        "through device taps at C=4096, the off-air WSPR capture, the FFT "
        "row)")
    dec = phase_decoders(torch, device, timer, channels=4096, block=2048,
                         card=card)
    t8 = time.perf_counter()
    between_phases(torch)
    log("phase 8a: the host-only decoders through (2048, 4096) device taps "
        "(FSK, NAVTEX, timecode, FAX, SSTV, Loran-C, ALE, STANAG 4285, HFDL, "
        "DRM)")
    hdec = phase_host_decoders(torch, device, channels=4096, block=2048,
                               card=card)
    between_phases(torch)
    log(f"phase 8b: NAVTEX at {NAVTEX_KHZ:.3f} kHz through the main path, "
        "the server and an EXT client, C=4096, audio_block=2048")
    nav = phase_navtex_server(torch, device, channels=4096, block=2048,
                              card=card)
    log(f"  phase 8 took {time.perf_counter() - t8:.1f} s of wall time")
    t9 = time.perf_counter()
    between_phases(torch)
    log(f"phase 9a: the multi-device engine over a {MESH} (time, chan) mesh "
        "of the one card, C=4096, audio_block=2048, against the unfused "
        "single-device engine")
    mesh = phase_mesh(torch, device, channels=4096, block=2048,
                      profile=profile)
    log(f"  mesh block: median {mesh['ms_median']} ms, min {mesh['ms_min']}, "
        f"max {mesh['ms_max']}; realtime factor {mesh['realtime_factor']} "
        f"(phase 3, one device, fused: median {sl['ms_median']} ms, factor "
        f"{sl['realtime_factor']}); launches a block "
        f"{mesh['launches_per_block']}; peak memory {mesh['peak_mem_gb']} "
        f"GB ({mesh['base_mem_gb']:.3f} GB of it allocated before the "
        f"run, the engine included); one SET {mesh['set_ms']:.3f} ms "
        f"(synchronized)  [{card}]")
    log(f"  per-block ms: {[round(v, 2) for v in mesh['ms_blocks']]}")
    between_phases(torch)
    log("phase 9b: a KiwiServer over the mesh engine (4 SND listeners, one "
        "W/F socket), and run_server --mesh on the card")
    msrv = phase_mesh_server(torch, device, channels=4096, block=2048)
    log(f"  mesh server: median {msrv['ms_median']} ms block start to block "
        f"start, realtime factor {msrv['realtime_factor']} over the blocks "
        f"after the first two  [{card}]")
    between_phases(torch)
    log("phase 9c: stage 2 by FFT correlation (RxParams(stage2=\"fft\")), "
        "C=4096, audio_block=2048")
    s2f = phase_stage2_fft(torch, device, channels=4096, block=2048)
    between_phases(torch)
    log("phase 9d: lms_block (one stage of kernel 5), both modes, "
        "(2048, 4096)")
    lmsb = phase_lms_block(torch, device, timer, channels=4096, block=2048)
    log(f"  lms_block kernel ms: notch {lmsb['notch']['ms']:.4f}, denoise "
        f"{lmsb['denoise']['ms']:.4f}  [{card}]")
    log(f"  phase 9 took {time.perf_counter() - t9:.1f} s of wall time")
    t10 = time.perf_counter()
    between_phases(torch)
    log("phase 10: the compiled step (CUDA graphs) against the eager step, "
        "C=4096, audio_block=2048")
    cmp = phase_compiled(torch, device, channels=4096, block=2048)
    for name, m in cmp["ms"].items():
        log(f"  {name}: median block wall {m['wall_ms']:.3f} ms, host "
            f"{m['host_ms']:.3f} ms (until run_block returned), device "
            f"{m['device_ms']:.3f} ms (CUDA events around the block), over "
            f"the {len(cmp['steady_blocks'])} blocks that replayed  [{card}]")
    log(f"  graphs captured: {cmp['graphs']} (blocks {cmp['captured_at']} "
        f"were a key's first: eager, then captured); capture ms by key "
        f"(program/gates): "
        f"{ {k: round(v, 2) for k, v in cmp['capture_ms'].items()} }; "
        f"bucket {32} prepared on a thread in "
        f"{cmp['prewarm_capture_ms']:.2f} ms  [{card}]")
    log(f"  memory above the eager engine: {cmp['pool_gb']:.3f} GB reserved "
        f"by the run's graphs (reserved after the run minus before, caches "
        f"emptied) + {cmp['buffers_gb']:.3f} GB of input and tap buffers  "
        f"[{card}]")
    log(f"  on the card in one block (torch.profiler): eager "
        f"{cmp['eager_block']['device_ops']} kernels, copies and fills, "
        f"{cmp['eager_block']['device_ms']:.3f} ms; its back half alone "
        f"{cmp['back_half']['device_ops']}, "
        f"{cmp['back_half']['device_ms']:.3f} ms; a replayed block "
        f"{cmp['replayed_block']['device_ops']}, "
        f"{cmp['replayed_block']['device_ms']:.3f} ms  [{card}]")
    log(f"  phase 10 took {time.perf_counter() - t10:.1f} s of wall time")
    t11 = time.perf_counter()
    between_phases(torch)
    log("phase 11: the other compiled programs (CUDA graphs) against eager "
        "instances of themselves, C=4096, audio_block=2048")
    prg = phase_programs(torch, device, channels=4096, block=2048)

    def fmt(m):
        return (f"wall {m['wall_ms']:.3f} / host {m['host_ms']:.3f} / device "
                f"{m['device_ms']:.3f} ms")

    def fmt_mem(part):
        held = part["memory_gb"]
        return (f"memory held (reserved / live tensors): compiled "
                f"{held[True]['reserved']:.3f} / "
                f"{held[True]['allocated']:.3f} GB, eager "
                f"{held[False]['reserved']:.3f} / "
                f"{held[False]['allocated']:.3f} GB, above eager "
                f"{part['memory_above_eager_gb']:.3f} GB")
    src = prg["source"]
    log(f"  11a source ({src['blocks']} blocks, FSK segment rows "
        f"{src['fsk_rows']}, noise): equal to the bit; next_block eager "
        f"{fmt(src['ms']['eager'])}, compiled {fmt(src['ms']['graphs'])}; "
        f"capture ms {src['capture_ms']}; {fmt_mem(src)}  [{card}]")
    blk = prg["block"]
    log(f"  11a compiled run_block over the eager source "
        f"{fmt(blk['eager_source'])}, over the compiled source "
        f"{fmt(blk['compiled_source'])} (measured before the source was "
        f"compiled: host "
        f"10.391 / 10.550 ms)  [{card}]")
    wfr = prg["waterfall"]
    log(f"  11b waterfall (z0, z7, z13, z14 of two blocks; a mask change): "
        f"rows equal to the bit; ingest eager (wf_ingest) "
        f"{fmt(wfr['ms']['eager'])}, compiled {fmt(wfr['ms']['graphs'])} "
        f"(wall and host; the work runs on the chains' stream); four rows' "
        f"frame() ms eager {wfr['frame_ms']['eager']:.3f}, compiled "
        f"{wfr['frame_ms']['graphs']:.3f}; capture ms {wfr['capture_ms']}; "
        f"{fmt_mem(wfr)}; a short "
        f"phase-5 run: fan-out {wfr['server_fanout_ms_per_block']:.3f} ms a "
        f"block (with an eager source: 51.0-62.0), factor "
        f"{wfr['server_realtime_factor']}  [{card}]")
    for name, gp in prg["gps"].items():
        log(f"  11c GPS {name} ({gp['chunks']} chunks of 0.4 s, {gp['rows']}"
            f" rows): sky and tracking equal to the bit; sky eager "
            f"{fmt(gp['ms']['eager']['sky'])}, compiled "
            f"{fmt(gp['ms']['graphs']['sky'])}; process eager "
            f"{fmt(gp['ms']['eager']['process'])}, compiled "
            f"{fmt(gp['ms']['graphs']['process'])}; capture ms "
            f"{gp['capture_ms']}; {fmt_mem(gp)}  [{card}]")
    msh = prg["mesh"]
    log(f"  11d mesh step ({MESH} mesh of the card, {msh['blocks']} blocks, "
        f"a SET and a retune_all; path: {msh['path']}): taps and state equal "
        f"to the bit; eager {fmt(msh['ms']['eager'])}, compiled "
        f"{fmt(msh['ms']['graphs'])}; kernel launches a block "
        f"{msh['launches_per_block']}, {msh['graphs']} graph(s), "
        f"{msh['graph_replays']} replays ({msh['replays_per_block']} a "
        f"block); capture ms {msh['capture_ms']}; {fmt_mem(msh)}  "
        f"[{card}]")
    log(f"  phase 11 took {time.perf_counter() - t11:.1f} s of wall time")
    summary = dict(card=card, build_s=_build.build_seconds, ddc=ddc,
                   server=sr, gps=g, server_gps=srg, slice_20k=s3b,
                   server_autorun={k: v for k, v in sra.items()
                                   if k != "spots"},
                   server_control=srn, decoders=dec,
                   host_decoders=hdec, navtex_server=nav, mesh=mesh,
                   mesh_server=msrv, stage2_fft=s2f, lms_block=lmsb,
                   compiled=cmp, programs=prg,
                   slice={k: v for k, v in sl.items() if k != "profile"},
                   serve={k: v for k, v in sv.items() if k != "profile"},
                   kernels=kern)
    out_dir = HERE / "build"                # listed in .gitignore
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(summary, indent=1))

    log(card)
    # each path's counts were set to 0 just before it and read just after
    paths = {"slice": sl["launches"], "slice_20k": s3b["launches"],
             "serve": sv["launches"], "server": sr["launches"],
             "server_autorun": sra["launches"],
             "server_control": srn["launches"],
             "gps": {"gps_track": g["launches"]},
             "server_gps": srg["launches"],
             "navtex_server": nav["launches"], "mesh": mesh["launches"],
             "mesh_server": msrv["launches"], "compiled": cmp["launches"],
             "programs_block": prg["launches_block"],
             "programs_gps": {"gps_track": prg["launches_gps"]},
             "programs_mesh": prg["launches_mesh"]}

    def per_block(name):
        if name == "gps_track":
            return g["launches"] / g["chunks"]
        if sl["launches_per_block"].get(name):
            return sl["launches_per_block"][name]
        return sv["launches"][name] / sv["blocks"]
    log(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=f"{PKG}/{src}",
             replaces=replaces,
             launches=sum(p.get(name, 0) for p in paths.values()),
             **{f"launches_{k}": p.get(name, 0) for k, p in paths.items()},
             launches_per_block=per_block(name),
             launches_per_block_unfused=sl[
                 "launches_per_block_unfused"].get(name),
             launches_per_block_mesh=mesh["launches_per_block"].get(name),
             max_abs_err=kern[name]["max_abs_err"], ms=kern[name]["ms"],
             ms_host_paced=kern[name]["ms_host_paced"],
             plain_ms=kern[name]["plain_ms"],
             bound_ms=kern[name]["bound_ms"],
             bound_by=kern[name]["bound_by"],
             share_of_bound=kern[name]["share_of_bound"],
             library_ms=kern[name]["library_ms"],
             **{k: kern[name][k] for k in ("library_fft_ms",
                                            "library_fft_peak_gb",
                                            "mesh_shard")
                if k in kern[name]})
        for name, (src, replaces) in KERNEL_SOURCES.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
