"""Build the CUDA kernels in ``csrc/`` and load them with ``ctypes``.

Every ``csrc/*.cu`` file is compiled by one plain ``nvcc`` call into one
shared library with a C interface (no PyTorch headers, so the build
takes seconds).  The library lives under ``<checkout>/build/
torch_kernels/<hash>/``, where the hash covers the sources and the
flags: a fresh checkout builds on its first CUDA call, an unchanged one
reuses the library.  Nothing happens at import time.

Each C entry point takes every pointer and the stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; :func:`check` raises
when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
LIB_NAME = "libflydog_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
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
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
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


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            dll = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(dll, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = dll
        return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {err}")


def require_cuda(t, name: str) -> None:
    """Raise unless ``t`` is a CUDA tensor (a wrapper's kernel branch)."""
    if t.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {t.device}")
