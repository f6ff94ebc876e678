"""Build the port's CUDA kernels at first use and bind them with ctypes.

``nvcc`` compiles every ``clrs_tpu_torch/csrc/*.cu`` into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds), for ``sm_90a`` with ``--fmad=false`` (the error-free transforms
must not be contracted into fused multiply-adds).  The library lands in
``build/clrs_tpu_torch/`` at the repository root, named by a hash of the
sources and flags, so a changed source is rebuilt.  A failed build raises;
nothing falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "clrs_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_SIGNATURES = {
    # a, out, okf, scratch, B, n, np2, stream
    "clrs_spd_inverse_dd": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, _P],
    # a4, b4, hh, out, G, P2, T, stream
    "clrs_schur_pairs_dd": [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_int, _P],
    # a, b, c, B, n, K, m, stream
    "clrs_matmul_dd": [_P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, _P],
}

_lib = None
build_seconds = None  # wall time of the build this process ran, if any


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libclrs_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library of the current sources exists;
    returns its path."""
    global build_seconds
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           *map(str, cu)]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    build_seconds = time.time() - t0
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library with every entry's signature declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, name: str):
    """Raise on a nonzero cudaError_t returned by a C entry."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
