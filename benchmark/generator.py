"""The ADC's stand-in: a small ring of distinct float32 blocks, made from
the seed, looped, released free or at the ADC's own rate.

Each block carries the configuration's scene (carriers, an AM signal,
white noise).  Every tone's frequency is moved by less than one cycle
per ring (under 1.5 Hz) to a whole number of cycles per ring, so the
looped stream is continuous; the noise is drawn anew for every block of
the ring.  The seed sets the noise and each tone's starting phase.  The
blocks are made on the device in a few large calls and kept in host
memory, where a capture card would deliver them.

The ADC runs on its own oscillator.  A configuration that states
``adc_ppm`` puts it that far off the nominal ``adc_clock_hz``: the scene
is sampled at ``adc_clock_hz * (1 + adc_ppm * 1e-6)`` (and paced at that
rate), so a tone lies ``-adc_ppm`` off where the nominal clock's tuning
words look for it, which is what a GPS clock correction corrects.
Without the key the ADC runs at the nominal clock.

``next_block`` is what a sample source offers the program's
``ThreadedSource``: it stamps each block's due time, the instant its
last sample would leave the ADC.  Free, a block is released when asked
for and stamped then.  Paced, the first ``warm`` blocks are released at
once (set-up runs them), and from :meth:`AdcRing.start` at t0 the k-th
block after them is released at t0 + (k + 1) x the block period: an open
loop at 1.0x real time.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch


class AdcRing:
    def __init__(self, cfg: dict, adc_block: int, seed: int, device,
                 paced: bool, warm: int = 0):
        self.adc_clock = float(cfg["adc_clock_hz"])
        ppm = cfg.get("adc_ppm")
        self.true_clock = (self.adc_clock if ppm is None
                           else self.adc_clock * (1.0 + float(ppm) * 1e-6))
        self.block = adc_block
        self.paced = paced
        self.period = adc_block / self.true_clock
        scene = cfg["scene"]
        nring = int(cfg["ring_blocks"])
        n = nring * adc_block
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed) % (1 << 63))
        cycles_per_ring = n / self.true_clock
        t = torch.arange(n, dtype=torch.float64, device=device)
        x = torch.zeros(n, dtype=torch.float64, device=device)
        for tone in scene["tones"]:
            f = round(tone["hz"] * cycles_per_ring)       # whole cycles
            ph0 = float(torch.rand((), generator=gen, device=device,
                                   dtype=torch.float64))
            carrier = torch.cos(2 * np.pi * torch.remainder(
                t * (f / n) + ph0, 1.0))
            am = tone.get("am")
            if am:
                fm = round(am["hz"] * cycles_per_ring)
                carrier = carrier * (1.0 + am["depth"] * torch.sin(
                    2 * np.pi * torch.remainder(t * (fm / n), 1.0)))
            x += tone["amplitude"] * carrier
        del t
        x += scene["noise_rms"] * torch.randn(
            n, generator=gen, device=device, dtype=torch.float64)
        self.blocks = [b.numpy() for b in
                       x.float().cpu().reshape(nring, adc_block)]
        del x
        self.due: dict[int, float] = {}
        self._n = 0
        self._t0 = None
        self.warm = warm if paced else 0
        self._go = threading.Event()
        self._stop = threading.Event()
        if not paced:
            self._go.set()

    def block_of(self, n: int) -> np.ndarray:
        """The samples of the stream's block ``n``."""
        return self.blocks[n % len(self.blocks)]

    def start(self, t0: float) -> None:
        """Open the paced loop: the k-th block after the warm ones is due
        at t0 + (k+1) periods."""
        self._t0 = t0
        self._go.set()

    def close(self) -> None:
        self._stop.set()
        self._go.set()

    def next_block(self, n: int) -> np.ndarray:
        if n != self.block:
            raise ValueError(f"blocks are {self.block} samples, not {n}")
        k = self._n
        if k >= self.warm:
            self._go.wait()
        if self.paced and k >= self.warm and not self._stop.is_set():
            due = self._t0 + (k - self.warm + 1) * self.period
            while not self._stop.is_set():
                wait = due - time.monotonic()
                if wait <= 0:
                    break
                self._stop.wait(min(wait, 0.05))
        else:
            due = time.monotonic()
        self.due[k] = due
        self._n += 1
        return self.block_of(k)
