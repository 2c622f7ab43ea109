"""ADC sample sources.

Port of :mod:`flydog_sdr_gps_tpu.runtime.source`.
:class:`SampleSource`, :class:`SyntheticSource`, the capture replays
:class:`FileSource` and :class:`Int24FileSource` and the
producer-thread wrapper :class:`ThreadedSource` are host numpy, as in
the reference.  :class:`DeviceSceneSource` generates the scene on the
device from exact 48-bit phase words, so no sample crosses the host
link.  All sources deliver float32 blocks, full scale +-1.0.
"""

from __future__ import annotations

import collections
import threading
import time

import numpy as np
import torch

from ..numerology import ADC_CLOCK_NOM, RX_DECIM_12K
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


class FileSource(SampleSource):
    """Replay a raw capture (int16 native-endian or float32), looped.

    The reference's GPS equivalent is GPS_SAMPLES_FROM_FILE
    (`gps/search.cpp:361-379`); this generalizes it to the wideband
    path.
    """

    def __init__(self, path: str, dtype: str = "int16",
                 adc_clock: float = ADC_CLOCK_NOM, loop: bool = True):
        super().__init__(adc_clock)
        self._data = np.fromfile(path, dtype=np.dtype(dtype))
        if dtype == "int16":
            self._data = (self._data.astype(np.float32) / 32768.0)
        else:
            self._data = self._data.astype(np.float32)
        if len(self._data) == 0:
            raise ValueError(f"empty capture {path}")
        self._pos = 0
        self.loop = loop

    def _produce(self, n: int) -> np.ndarray:
        out = np.zeros(n, np.float32)
        got = 0
        while got < n:
            take = min(n - got, len(self._data) - self._pos)
            if take <= 0:
                if not self.loop:
                    break
                self._pos = 0
                continue
            out[got:got + take] = self._data[self._pos:self._pos + take]
            self._pos += take
            got += take
        return out


class Int24FileSource(SampleSource):
    """Replay a packed signed-24-bit little-endian capture, the FPGA's
    native RXO wire format (`RXO_BITS=24`, converted s24->float in
    `rx/data_pump.cpp:145-208`).  Uses the native converter
    (`runtime/native/datapump.c`) when a C compiler built it, numpy
    otherwise."""

    def __init__(self, path: str, scale: float = 2.0 ** -23,
                 iq_swap: bool = False,
                 adc_clock: float = ADC_CLOCK_NOM, loop: bool = True):
        super().__init__(adc_clock)
        raw = np.fromfile(path, dtype=np.uint8)
        n = (len(raw) // 3) * 3
        if n == 0:
            raise ValueError(f"empty capture {path}")
        from . import native
        if native.s24_to_f32 is not None:
            self._data = native.s24_to_f32(raw[:n], scale, iq_swap)
        else:  # pragma: no cover - no compiler available
            b = raw[:n].reshape(-1, 3).astype(np.int32)
            v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
            v = (v << 8) >> 8
            self._data = (v * scale).astype(np.float32)
            if iq_swap:
                d = self._data[:len(self._data) // 2 * 2].reshape(-1, 2)
                self._data = d[:, ::-1].reshape(-1)
        self._pos = 0
        self.loop = loop

    _produce = FileSource._produce


class BlockRing:
    """Single-producer single-consumer ring of float32 blocks (the
    reference's `rx_dpump_t` N_DPBUF ring, `rx/data_pump.h:36-57`): the
    ingest thread pushes, the dispatch loop pops.  A push into a full
    ring drops the NEW block and counts it.  The numpy stand-in (a
    deque under a lock) for `runtime/native`'s C ring, which
    :class:`ThreadedSource` takes whenever a C compiler built it."""

    def __init__(self, block: int, nblocks: int = 32):
        self.block = int(block)
        self.nblocks = int(nblocks)
        self._blocks: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._overruns = 0

    def push(self, x: np.ndarray) -> bool:
        """Returns True if the block was dropped."""
        x = np.array(x, np.float32)
        if x.shape != (self.block,):
            raise ValueError(f"block is {self.block}, got {x.shape}")
        with self._lock:
            if len(self._blocks) >= self.nblocks:
                self._overruns += 1
                return True
            self._blocks.append(x)
            return False

    def pop(self) -> np.ndarray | None:
        with self._lock:
            return self._blocks.popleft() if self._blocks else None

    @property
    def fill(self) -> int:
        return len(self._blocks)

    @property
    def overruns(self) -> int:
        return self._overruns


class ThreadedSource(SampleSource):
    """Decouple ingest from dispatch: a producer thread pulls blocks
    from ``inner`` into the native SPSC ring (:class:`BlockRing` where no
    C compiler is found); ``next_block`` pops.

    This is the data-pump split of the reference (SPI helper process +
    `data_pump` task, `platform/common/spi_dev.cpp:168`,
    `rx/data_pump.cpp:292`): production never blocks on the consumer,
    and a block that finds the ring full is dropped and counted.
    """

    def __init__(self, inner: SampleSource, block: int,
                 nblocks: int = 32):
        super().__init__(inner.adc_clock)
        self.inner = inner
        self.block = block
        from . import native
        self.ring = (native.NativeRing or BlockRing)(block, nblocks)
        self._target_fill = max(nblocks * 3 // 4, 1)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            if self.ring.fill >= self._target_fill:
                self._stop.wait(0.002)
                continue
            self.ring.push(self.inner.next_block(self.block))

    def _produce(self, n: int) -> np.ndarray:
        if n != self.block:
            raise ValueError(f"block is {self.block}, asked for {n}")
        while True:
            x = self.ring.pop()
            if x is not None:
                return x
            time.sleep(0.001)

    @property
    def overruns(self) -> int:
        return self.ring.overruns

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)


class DeviceSceneSource:
    """Device-resident scene generator (bench / server ingest).

    Tones are ``(freq_hz, amplitude)`` carriers,
    ``(freq_hz, amplitude, ("am", mod_freq_hz, depth))`` AM signals, or
    ``(freq_hz, amplitude, ("fsk", baud_audio_frac, tone_spacing_hz,
    symbols, cycle_syms))`` M-FSK transmissions.  Each carrier and
    modulator is an exact 48-bit NCO: the host keeps its phase as a
    Python int, and the device builds the block's phase words with int64
    arithmetic, so the scene stays phase-continuous forever.  Noise
    comes from a seeded ``torch.Generator`` on the device.

    FSK semantics (for decoder soak scenes, e.g. WSPR; ``baud_audio_frac``
    = audio samples per symbol at the 12 kHz channel rate, 8192 for
    WSPR): the transmission repeats every ``cycle_syms`` symbol periods;
    symbols beyond ``len(symbols)`` are idle (carrier off).  Tone n sits
    at ``freq_hz + (symbols[n] - (M-1)/2) * tone_spacing_hz``.  The
    symbol clock is exact integer ticks, and a symbol boundary lands
    mid-block at its exact sample (at most one a block: one symbol
    period is >= 85M ADC ticks, far longer than any block).
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
        self._fsk: list[dict] = []     # FSK transmitter states
        for tone in tones:
            f, a = tone[0], float(tone[1])
            if len(tone) > 2 and tone[2] is not None and \
                    tone[2][0] == "fsk":
                _kind, baud_frac, df, syms, cycle_syms = tone[2]
                m = int(max(syms)) + 1
                self._fsk.append(dict(
                    amp=a, syms=[int(v) for v in syms], cycle=int(cycle_syms),
                    sym_ticks=int(baud_frac) * RX_DECIM_12K,
                    fcws=[nco.freq_to_fcw(f + (v - (m - 1) / 2.0) * float(df),
                                          adc_clock) for v in range(m)],
                    phi=0))
                continue
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

    def _ramp(self, phi: int, fcw: int, n: torch.Tensor) -> torch.Tensor:
        """Phase words ``phi + n*fcw`` mod 2**48 for sample offsets n."""
        w = torch.tensor(fcw, dtype=torch.int64, device=self.device)
        return (phi + nco.mul_mod48(n, w)) & nco.MASK48

    def _cycles(self, i: int) -> torch.Tensor:
        return nco.to_cycles(self._ramp(self._phis[i], self._fcws[i],
                                        self._n))

    def _fsk_block_args(self, st: dict) -> tuple:
        """Host-side FSK symbol clock for one block: the phase word at
        the block's start and at the symbol boundary, the tone words and
        amplitudes before and after it, and the boundary's sample
        (``self.block`` if none falls in this block).  Advances the
        transmitter's phase carry."""
        t0 = self.ticks
        sym_ticks, cycle = st["sym_ticks"], st["cycle"]
        n_tx = len(st["syms"])

        def sym_of(tick):
            s = (tick // sym_ticks) % cycle
            return st["syms"][s] if s < n_tx else None
        s_a = sym_of(t0)
        b = ((t0 // sym_ticks) + 1) * sym_ticks    # next boundary
        brk = b - t0 if b - t0 < self.block else self.block
        s_b = sym_of(b) if brk < self.block else s_a
        fcw_a = st["fcws"][s_a if s_a is not None else 0]
        fcw_b = st["fcws"][s_b if s_b is not None else 0]
        phi0 = st["phi"]
        phi_brk = (phi0 + fcw_a * brk) % (1 << 48)
        st["phi"] = (phi_brk + fcw_b * (self.block - brk)) % (1 << 48)
        return (phi0, phi_brk, fcw_a, fcw_b, brk,
                st["amp"] if s_a is not None else 0.0,
                st["amp"] if s_b is not None else 0.0)

    def fsk_cycle_pos_s(self, idx: int = 0) -> tuple[float, float]:
        """(seconds into the FSK cycle, cycle length in seconds) at the
        CURRENT tick, so that a decoder can align its capture to the
        transmission cadence."""
        st = self._fsk[idx]
        cyc = st["sym_ticks"] * st["cycle"]
        return (self.ticks % cyc) / self.adc_clock, cyc / self.adc_clock

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
        # FSK tones: the ramp of the tone before the symbol boundary up
        # to sample brk, the ramp of the tone after it (restarted at the
        # boundary's carried phase) from there on
        for st in self._fsk:
            phi0, phi_brk, fcw_a, fcw_b, brk, amp_a, amp_b = \
                self._fsk_block_args(st)
            before = self._n < brk
            words = torch.where(
                before, self._ramp(phi0, fcw_a, self._n),
                self._ramp(phi_brk, fcw_b,
                           torch.clamp(self._n - brk, min=0)))
            ampv = torch.where(before, amp_a, amp_b)
            x += ampv * torch.cos(two_pi * nco.to_cycles(words))
        if self.noise_rms:
            x += self.noise_rms * torch.randn(
                self.block, generator=self._gen, device=self.device)
        for i, fcw in enumerate(self._fcws):
            self._phis[i] = (self._phis[i] + fcw * self.block) % (1 << 48)
        self.ticks = (self.ticks + self.block) % (1 << 48)
        return x
