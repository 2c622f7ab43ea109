"""Native (C) runtime components, built with cc at first use.

The reference's host runtime is C++ throughout; here the Python layer
drives the card while the serial per-sample hot paths (the codecs, the
sample-format converters, the block ring) stay native.  The port's own
copy of the reference package's ``runtime/native``: the same C sources
and the same Python surface (``adpcm_native``, ``s24_to_f32``,
``s16_to_f32``, ``f32_to_s16be``, ``SeqCheck``, ``NativeRing``), each of
which is ``None`` when no C compiler is found, so that callers fall back
to their numpy versions.

Unlike the reference, nothing is built when the module is imported: a
name's library is compiled the first time the name is read (module
``__getattr__``), into ``<checkout>/build/torch_native/<source hash>/``
beside the CUDA kernels' build directory, which git ignores.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(_DIR))), "build", "torch_native")
_lock = threading.Lock()


def _build(name: str) -> str | None:
    src = os.path.join(_DIR, f"{name}.c")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(_BUILD_ROOT, digest, f"lib{name}.so")
    if os.path.exists(so):
        return so
    cc = os.environ.get("CC", "cc")
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [cc, "-O3", "-shared", "-fPIC", "-o", tmp, src]
    try:
        os.makedirs(os.path.dirname(so), exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=60)
        # atomic rename: a concurrent build never loads a half-written file
        os.replace(tmp, so)
        return so
    except Exception:
        return None


def _load_adpcm() -> dict:
    so_path = _build("adpcm")
    _lib = ctypes.CDLL(so_path) if so_path else None
    if _lib is None:  # pragma: no cover - no compiler available
        return dict(adpcm_native=None)
    import numpy as np

    _lib.adpcm_encode.argtypes = [
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]
    _lib.adpcm_decode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int16),
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]
    _lib.adpcm_encode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]

    class adpcm_native:  # noqa: N801 — module-like facade
        @staticmethod
        def encode(samples, state):
            samples = np.ascontiguousarray(samples, np.int16)
            out = np.zeros(len(samples) // 2, np.uint8)
            st = np.array([state.predictor, state.index], np.int32)
            _lib.adpcm_encode(
                samples.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                len(samples),
                st.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            state.predictor, state.index = int(st[0]), int(st[1])
            return out

        @staticmethod
        def encode_batch(samples_2d, states_2d):
            """k channel streams in one call: ``samples_2d`` (k, n)
            int16 row-major, ``states_2d`` (k, 2) int32 mutated in
            place; returns (k, n//2) uint8 packed nibbles."""
            s = np.ascontiguousarray(samples_2d, np.int16)
            st = np.ascontiguousarray(states_2d, np.int32)
            k, n = s.shape
            out = np.zeros((k, n // 2), np.uint8)
            _lib.adpcm_encode_batch(
                s.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                n, k,
                st.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            if st is not states_2d:          # copy was made: write back
                states_2d[...] = st
            return out

        @staticmethod
        def decode(data, state):
            data = np.ascontiguousarray(data, np.uint8)
            out = np.zeros(len(data) * 2, np.int16)
            st = np.array([state.predictor, state.index], np.int32)
            _lib.adpcm_decode(
                data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                len(out),
                st.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            state.predictor, state.index = int(st[0]), int(st[1])
            return out
    return dict(adpcm_native=adpcm_native)


# ---------------------------------------------------------------------------
# datapump: ring buffer + wire-format conversion (datapump.c)
# ---------------------------------------------------------------------------

_DATAPUMP_NAMES = ("s24_to_f32", "s16_to_f32", "f32_to_s16be", "SeqCheck",
                   "NativeRing")


def _load_datapump() -> dict:
    dp_path = _build("datapump")
    _dp = ctypes.CDLL(dp_path) if dp_path else None
    if _dp is None:  # pragma: no cover - no compiler available
        return dict.fromkeys(_DATAPUMP_NAMES)
    import numpy as np

    _dp.dp_s24_to_f32.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_float, ctypes.c_int]
    _dp.dp_s16_to_f32.argtypes = [
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_float, ctypes.c_int]
    _dp.dp_f32_to_s16be.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64, ctypes.c_float]
    _dp.dp_seq_check.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
    _dp.dp_seq_check.restype = ctypes.c_int64
    _dp.dp_ring_new.argtypes = [ctypes.c_int64, ctypes.c_int64]
    _dp.dp_ring_new.restype = ctypes.c_void_p
    _dp.dp_ring_free.argtypes = [ctypes.c_void_p]
    for fn in (_dp.dp_ring_push, _dp.dp_ring_pop):
        fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
        fn.restype = ctypes.c_int
    _dp.dp_ring_fill.argtypes = [ctypes.c_void_p]
    _dp.dp_ring_fill.restype = ctypes.c_int64
    _dp.dp_ring_overruns.argtypes = [ctypes.c_void_p]
    _dp.dp_ring_overruns.restype = ctypes.c_int64

    def s24_to_f32(raw: bytes | "np.ndarray", scale: float,
                   iq_swap: bool = False) -> "np.ndarray":
        raw = np.frombuffer(bytes(raw), np.uint8) \
            if not isinstance(raw, np.ndarray) else \
            np.ascontiguousarray(raw, np.uint8)
        n = len(raw) // 3
        out = np.zeros(n, np.float32)
        _dp.dp_s24_to_f32(
            raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, scale, int(iq_swap))
        return out

    def s16_to_f32(samples: "np.ndarray", scale: float,
                   iq_swap: bool = False) -> "np.ndarray":
        samples = np.ascontiguousarray(samples, np.int16)
        out = np.zeros(len(samples), np.float32)
        _dp.dp_s16_to_f32(
            samples.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(samples), scale, int(iq_swap))
        return out

    def f32_to_s16be(x: "np.ndarray", scale: float = 32767.0) -> bytes:
        x = np.ascontiguousarray(x, np.float32)
        out = np.zeros(2 * len(x), np.uint8)
        _dp.dp_f32_to_s16be(
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(x), scale)
        return out.tobytes()

    class SeqCheck:
        """SND_SEQ_CHECK analogue (`rx/data_pump.cpp:56-143`)."""

        def __init__(self):
            self._st = np.array([-1, 0], np.int64)

        def check(self, seq: int) -> int:
            return int(_dp.dp_seq_check(
                self._st.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_int64)), seq))

        @property
        def total_gaps(self) -> int:
            return int(self._st[1])

    class NativeRing:
        """SPSC float32-block ring (the `rx_dpump_t` N_DPBUF ring,
        `rx/data_pump.h:36-57`): ingest thread pushes, the dispatch
        loop pops.  A push into a full ring drops the NEW block (and
        counts it); consumers chase freshness by draining, like the
        data-pump latency reset."""

        def __init__(self, block: int, nblocks: int = 32):
            self.block = int(block)
            self._h = ctypes.c_void_p(_dp.dp_ring_new(block, nblocks))
            if not self._h:
                raise MemoryError("dp_ring_new")
            self._lock = threading.Lock()   # guards destruction only
            self._free = _dp.dp_ring_free   # survives module teardown

        def push(self, x: "np.ndarray") -> bool:
            x = np.ascontiguousarray(x, np.float32)
            assert len(x) == self.block
            return bool(_dp.dp_ring_push(
                self._h,
                x.ctypes.data_as(ctypes.POINTER(ctypes.c_float))))

        def pop(self) -> "np.ndarray | None":
            out = np.zeros(self.block, np.float32)
            ok = _dp.dp_ring_pop(
                self._h,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            return out if ok else None

        @property
        def fill(self) -> int:
            return int(_dp.dp_ring_fill(self._h))

        @property
        def overruns(self) -> int:
            return int(_dp.dp_ring_overruns(self._h))

        def __del__(self):
            with self._lock:
                if getattr(self, "_h", None):
                    self._free(self._h)
                    self._h = None
    return dict(s24_to_f32=s24_to_f32, s16_to_f32=s16_to_f32,
                f32_to_s16be=f32_to_s16be, SeqCheck=SeqCheck,
                NativeRing=NativeRing)


def __getattr__(name: str):
    """Build and load a name's library the first time it is read."""
    if name == "adpcm_native":
        loader = _load_adpcm
    elif name in _DATAPUMP_NAMES:
        loader = _load_datapump
    else:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    with _lock:
        if name not in globals():
            globals().update(loader())
    return globals()[name]
