"""Build the CUDA kernels in ``csrc/`` and load them with ``ctypes``.

Every ``csrc/*.cu`` file is compiled by one plain ``nvcc`` call into one
shared library with a C interface (no PyTorch headers, so the build
takes seconds).  The library lives under ``<checkout>/build/
torch_kernels/<hash>/``, where the hash covers the sources and the
flags: a fresh checkout builds on its first CUDA call, an unchanged one
reuses the library.  Nothing happens at import time.

Each C entry point takes every pointer and the stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; :func:`check` raises
when that is not 0.  Each wrapper counts its launches through
:func:`count_launch`, which a CUDA graph's capture redirects
(:func:`recording`): a capture launches nothing, and each replay of the
graph credits the launches it recorded.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from .utils.trace import get_trace

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"
# --threads 0: the sources are compiled side by side
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--threads", "0")
LIB_NAME = "libflydog_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures of the entry points (all return int = cudaError_t)
_SIGNATURES = {
    # y, out, phi0, dphi, h2 (host float*), C, k2, d2, m2, stream
    "stage2_rot_c64": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # y, out, h2 (host float*), C, k2, d2, m2, stream
    "stage2_c64": (_P, _P, _P, _I, _I, _I, _I, _P),
    # mag_db, env_seq, env (in/out), hang (in/out), N, C, atk, dec,
    # hang_n, stream
    "agc_envelope_f32": (_P, _P, _P, _P, _I, _I, _F, _F, _I, _P),
    # z, v, phase (in/out), freq (in/out), N, C, g1, g2, fmax, stream
    "sam_pll_c64": (_P, _P, _P, _P, _I, _I, _F, _F, _F, _P),
    # x, y, w_notch, line_notch, w_den, line_den (all four in/out),
    # en_notch, en_den (bytes), N, C, taps, delay, decay and mu of the
    # notch, decay and mu of the denoiser, stream
    "lms_chain_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                      _F, _F, _F, _F, _P),
    # raw, code table, code_phase, code_rate, carr_phase, carr_freq,
    # ip_prev, qp_prev (six in/out), active (bytes), code_len, boc,
    # corr_half, outs, nch, n_ep, epoch, g1, g2, gf, gd, 1/n, fs/2pi,
    # 1/f_L1, chip rate/fs, fc, stream
    "gps_track_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F, _F, _P),
    # nch, int* out (clusters resident at once)
    "gps_track_max_clusters": (_I, _P),
    # spec, its frame and channel strides (complex values), out,
    # psd_smooth in and out, min_ring in and out, xhat2 in and out, nfr,
    # hb, C, min_window, mmse (0/1), alpha, floor_bias, over_subtract,
    # floor^2, floor, a, 1 - a, stream
    "spectral_nr_c64": (_P, _L, _L, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                        _I, _I, _F, _F, _F, _F, _F, _F, _F, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# per thread: the launch counts of a capture in progress (see recording)
_capture = threading.local()
# the counters are bumped from the block loop and from a capturing or
# warming thread at once
_count_lock = threading.Lock()
# wall seconds of the nvcc run made by this process (None: none made)
build_seconds: float | None = None


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    return _BUILD_ROOT / source_hash() / LIB_NAME


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    global build_seconds
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    srcs = [str(p) for p in _sources()]
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *srcs]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed (%d):\n%s\n%s" % (
            res.returncode, " ".join(cmd), res.stderr[-8000:]))
    # atomic rename: a concurrent build never loads a half-written file
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def load(path) -> ctypes.CDLL:
    """A kernel library at ``path`` with the C signatures of the entry
    points it has bound."""
    dll = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(dll, name, None)
        if fn is not None:
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    return dll


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call; the build and
    the load are the tracer's span ``build.load``)."""
    global _lib
    with _lock:
        if _lib is None:
            t0 = time.monotonic_ns()
            _lib = load(build())
            get_trace().span("build.load", -1, t0)
        return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {err}")


def count_launch(fn) -> None:
    """Count one launch of ``fn``'s kernel in ``fn.launches``, or, while
    this thread captures a CUDA graph, in that capture's record."""
    rec = getattr(_capture, "counts", None)
    if rec is None:
        with _count_lock:
            fn.launches += 1
    else:
        rec[fn] = rec.get(fn, 0) + 1


@contextlib.contextmanager
def recording():
    """Collect this thread's kernel launches in a dict ``{wrapper: n}``
    instead of the wrappers' counters (for a graph capture, which runs
    nothing: its replays credit the dict)."""
    if getattr(_capture, "counts", None) is not None:
        raise RuntimeError("a capture is already recording in this thread")
    _capture.counts = counts = {}
    try:
        yield counts
    finally:
        _capture.counts = None


def credit(counts: dict) -> None:
    """Add a recorded capture's launches to the wrappers' counters (one
    replay of its graph)."""
    with _count_lock:
        for fn, n in counts.items():
            fn.launches += n


def require_cuda(t, name: str) -> None:
    """Raise unless ``t`` is a CUDA tensor (a wrapper's kernel branch)."""
    if t.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {t.device}")
