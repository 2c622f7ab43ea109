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

from .. import _graphs
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
    modulator is an exact 48-bit NCO: its phase is an int64 word on the
    device, advanced by ``fcw * block mod 2**48`` each block, and the
    block's phase words are int64 arithmetic, so the scene stays
    phase-continuous forever.  Noise comes from a seeded
    ``torch.Generator`` on the device.

    FSK semantics (for decoder soak scenes, e.g. WSPR; ``baud_audio_frac``
    = audio samples per symbol at the 12 kHz channel rate, 8192 for
    WSPR): the transmission repeats every ``cycle_syms`` symbol periods;
    symbols beyond ``len(symbols)`` are idle (carrier off).  Tone n sits
    at ``freq_hz + (symbols[n] - (M-1)/2) * tone_spacing_hz``.  The
    symbol clock is exact integer ticks, and each symbol boundary lands
    at its exact sample, however many fall in one block (a 100 Bd
    NAVTEX emitter has 17 in a 2048-sample block): the host writes each
    emitter's stretches into a table of fixed capacity (``ceil(block /
    symbol ticks) + 1`` rows, padded with starts at ``block``) through
    one of two pinned buffers.

    The block is one program over buffers the source owns (the reference
    jits ``make``).  ``use_graphs`` (by default on a card, not on the
    CPU): it is a CUDA graph, replayed on the caller's current stream,
    with the noise generator registered with it, and ``next_block``
    returns the output buffer ``out``, which the next block overwrites
    (a consumer that keeps a block past the next one copies it); on the
    CPU ``True`` runs the same body with nothing captured.  ``False``
    runs the body and returns a copy of ``out``.
    """

    def __init__(self, tones=(), noise_rms: float = 0.0,
                 adc_clock: float = ADC_CLOCK_NOM, block: int = 512 * 10416,
                 *, device: torch.device | str = "cuda", seed: int = 0,
                 use_graphs: bool | None = None):
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
        self._n = torch.arange(block, dtype=torch.int64, device=self.device)
        if use_graphs is None:
            use_graphs = self.device.type == "cuda"
        self._alias = use_graphs
        self._graphs = self._compile(use_graphs)

    # -- the block's program: buffers, segment tables --------------------
    def _compile(self, use_graphs: bool) -> _graphs.GraphSet:
        dev = self.device
        self._phi_dev = torch.zeros(len(self._fcws), dtype=torch.int64,
                                    device=dev)
        self._fcw_dev = torch.tensor(self._fcws, dtype=torch.int64,
                                     device=dev)
        self.out = torch.zeros(self.block, dtype=torch.float32, device=dev)
        # FSK segment tables: [starts | phase words | tone words] and the
        # amplitudes, each emitter's ``cap`` rows side by side
        self._fsk_cap = [-(-self.block // st["sym_ticks"]) + 1
                         for st in self._fsk]
        rows = sum(self._fsk_cap)
        self._seg_words = torch.zeros((3, rows), dtype=torch.int64,
                                      device=dev)
        self._seg_amps = torch.zeros(rows, dtype=torch.float32, device=dev)
        pin = dev.type == "cuda"
        # two host buffers in turns, each with the event after its copy
        self._seg_host = [[torch.zeros((3, rows), dtype=torch.int64,
                                       pin_memory=pin),
                           torch.zeros(rows, dtype=torch.float32,
                                       pin_memory=pin), None]
                          for _ in range(2)]
        self._seg_turn = 0
        return _graphs.GraphSet(dev, generators=(self._gen,),
                                enabled=use_graphs)

    def _load_segments(self) -> None:
        """This block's FSK stretches into the device tables: written on
        the host into the pinned buffer the card read two blocks ago,
        then copied without blocking on the current stream."""
        entry = self._seg_host[self._seg_turn]
        words, amps, event = entry
        if event is not None:
            event.synchronize()         # the card has read this buffer
        w, a = words.numpy(), amps.numpy()
        w[0], w[1:], a[:] = self.block, 0, 0.0
        at = 0
        for st, cap in zip(self._fsk, self._fsk_cap):
            starts, phis, fcws, amp = self._fsk_segments(st)
            k = len(starts)
            w[0, at:at + k], w[1, at:at + k], w[2, at:at + k] = (
                starts, phis, fcws)
            a[at:at + k] = amp
            at += cap
        self._seg_words.copy_(words, non_blocking=True)
        self._seg_amps.copy_(amps, non_blocking=True)
        if self.device.type == "cuda":
            entry[2] = torch.cuda.Event()
            entry[2].record(torch.cuda.current_stream(self.device))
        self._seg_turn ^= 1

    def _body(self) -> None:
        """The block into ``out`` from the device buffers; the carrier
        phases advanced."""
        two_pi = float(np.float32(2 * np.pi))
        x, n = self.out, self._n

        def cycles(i):
            return nco.to_cycles((self._phi_dev[i] + nco.mul_mod48(
                n, self._fcw_dev[i])) & nco.MASK48)
        x.zero_()
        for amp, ci, mod in self._tones:
            carrier = torch.cos(two_pi * cycles(ci))
            if mod is not None:
                mi, depth = mod
                carrier *= 1.0 + depth * torch.sin(two_pi * cycles(mi))
            x += amp * carrier
        at = 0
        for cap in self._fsk_cap:
            starts, phis, fcws = self._seg_words[:, at:at + cap]
            amps = self._seg_amps[at:at + cap]
            seg = torch.searchsorted(starts, n, right=True) - 1
            words = (phis[seg] + nco.mul_mod48(n - starts[seg],
                                               fcws[seg])) & nco.MASK48
            x += amps[seg] * torch.cos(two_pi * nco.to_cycles(words))
            at += cap
        if self.noise_rms:
            x += self.noise_rms * torch.randn(
                self.block, generator=self._gen, device=self.device)
        self._phi_dev.copy_((self._phi_dev + nco.mul_mod48(
            self.block, self._fcw_dev)) & nco.MASK48)

    @property
    def graphs(self) -> dict:
        """The compiled block's graphs ({} on the CPU or eager)."""
        return self._graphs.graphs

    def _fsk_segments(self, st: dict) -> tuple:
        """Host-side FSK symbol clock for one block: for each stretch of
        the block that one symbol covers, its first sample, the phase
        word there, its tone word and its amplitude (0 while idle).
        Advances the transmitter's phase carry."""
        t0 = self.ticks
        sym_ticks, cycle = st["sym_ticks"], st["cycle"]
        n_tx = len(st["syms"])
        starts, phis, fcws, amps = [], [], [], []
        phi, at = st["phi"], 0
        while at < self.block:
            k = (t0 + at) // sym_ticks
            s = k % cycle
            sym = st["syms"][s] if s < n_tx else None
            end = min((k + 1) * sym_ticks - t0, self.block)
            fcw = st["fcws"][sym if sym is not None else 0]
            starts.append(at)
            phis.append(phi)
            fcws.append(fcw)
            amps.append(st["amp"] if sym is not None else 0.0)
            phi = (phi + fcw * (end - at)) % (1 << 48)
            at = end
        st["phi"] = phi
        return starts, phis, fcws, amps

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
        if self._fsk:
            self._load_segments()
        self._graphs.run(("scene",), self._body)
        self.ticks = (self.ticks + self.block) % (1 << 48)
        return self.out if self._alias else self.out.clone()
