"""ADC sample sources.

Port of the main-path part of :mod:`flydog_sdr_gps_tpu.runtime.source`.
:class:`SampleSource` and :class:`SyntheticSource` are host numpy, as in
the reference.  :class:`DeviceSceneSource` generates the scene on the
device from exact 48-bit phase words, so no sample crosses the host
link.  All sources deliver float32 blocks, full scale +-1.0.
"""

from __future__ import annotations

import numpy as np
import torch

from ..numerology import ADC_CLOCK_NOM
from ..ops import nco


class SampleSource:
    """Produces consecutive float32 ADC blocks; tracks a 48-bit sample
    counter (the reference's ``ticks_A`` timebase, `verilog/kiwi.v`).
    Non-finite samples are sanitized: a NaN would poison the streaming
    filter state for good."""

    def __init__(self, adc_clock: float = ADC_CLOCK_NOM):
        self.adc_clock = adc_clock
        self.ticks = 0                 # 48-bit sample counter

    def next_block(self, n: int) -> np.ndarray:
        x = self._produce(n)
        if not np.all(np.isfinite(x)):
            x = np.nan_to_num(x, nan=0.0, posinf=1.0, neginf=-1.0)
        self.ticks = (self.ticks + n) % (1 << 48)
        return x

    def _produce(self, n: int) -> np.ndarray:
        raise NotImplementedError


class SyntheticSource(SampleSource):
    """Tones + noise scene, host-generated (tests / small setups)."""

    def __init__(self, tones=(), noise_rms: float = 0.0,
                 adc_clock: float = ADC_CLOCK_NOM, seed: int = 0):
        super().__init__(adc_clock)
        self.tones = list(tones)       # (freq_hz, amplitude) or
                                       # (freq_hz, amplitude, mod_fn)
        self.noise_rms = noise_rms
        self._rng = np.random.default_rng(seed)

    def _produce(self, n: int) -> np.ndarray:
        t = (self.ticks + np.arange(n, dtype=np.float64)) / self.adc_clock
        x = np.zeros(n, np.float64)
        for tone in self.tones:
            f, a = tone[0], tone[1]
            carrier = np.cos(2 * np.pi * ((f * t) % 1.0))
            if len(tone) > 2 and tone[2] is not None:
                carrier = carrier * tone[2](t)
            x += a * carrier
        if self.noise_rms:
            x += self.noise_rms * self._rng.standard_normal(n)
        return x.astype(np.float32)


class DeviceSceneSource:
    """Device-resident scene generator (bench / server ingest).

    Tones are ``(freq_hz, amplitude)`` carriers or
    ``(freq_hz, amplitude, ("am", mod_freq_hz, depth))`` AM signals.
    Each carrier and modulator is an exact 48-bit NCO: the host keeps
    its phase as a Python int, and the device builds the block's phase
    words with int64 arithmetic, so the scene stays phase-continuous
    forever.  Noise comes from a seeded ``torch.Generator`` on the
    device.  (The reference's FSK scenes are not ported yet.)
    """

    def __init__(self, tones=(), noise_rms: float = 0.0,
                 adc_clock: float = ADC_CLOCK_NOM, block: int = 512 * 10416,
                 *, device: torch.device | str = "cuda", seed: int = 0):
        self.adc_clock = adc_clock
        self.block = block
        self.ticks = 0
        self.device = torch.device(device)
        self.noise_rms = noise_rms
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._fcws: list[int] = []     # carriers, then AM modulators
        self._tones = []               # (amp, carrier idx, (mod idx, depth))
        for tone in tones:
            f, a = tone[0], float(tone[1])
            self._fcws.append(nco.freq_to_fcw(f, adc_clock))
            ci = len(self._fcws) - 1
            mod = None
            if len(tone) > 2 and tone[2] is not None:
                kind, mf, depth = tone[2]
                if kind != "am":
                    raise ValueError(f"unsupported scene modulation {kind!r}")
                self._fcws.append(nco.freq_to_fcw(mf, adc_clock))
                mod = (len(self._fcws) - 1, float(depth))
            self._tones.append((a, ci, mod))
        self._phis = [0] * len(self._fcws)
        self._n = torch.arange(block, dtype=torch.int64, device=self.device)

    def _cycles(self, i: int) -> torch.Tensor:
        fcw = torch.tensor(self._fcws[i], dtype=torch.int64,
                           device=self.device)
        words = (self._phis[i] + nco.mul_mod48(self._n, fcw)) & nco.MASK48
        return nco.to_cycles(words)

    def next_block(self, n: int | None = None) -> torch.Tensor:
        if n is not None and n != self.block:
            raise ValueError(f"block is {self.block}, asked for {n}")
        two_pi = float(np.float32(2 * np.pi))
        x = torch.zeros(self.block, dtype=torch.float32, device=self.device)
        for amp, ci, mod in self._tones:
            carrier = torch.cos(two_pi * self._cycles(ci))
            if mod is not None:
                mi, depth = mod
                carrier *= 1.0 + depth * torch.sin(two_pi * self._cycles(mi))
            x += amp * carrier
        if self.noise_rms:
            x += self.noise_rms * torch.randn(
                self.block, generator=self._gen, device=self.device)
        for i, fcw in enumerate(self._fcws):
            self._phis[i] = (self._phis[i] + fcw * self.block) % (1 << 48)
        self.ticks = (self.ticks + self.block) % (1 << 48)
        return x
