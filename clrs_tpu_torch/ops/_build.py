"""Build the port's CUDA kernels at first use and bind them with ctypes.

``nvcc`` compiles every ``clrs_tpu_torch/csrc/*.cu`` (a plain C interface,
no PyTorch headers) for ``sm_90a`` with ``--fmad=false`` (the error-free
transforms must not be contracted into fused multiply-adds; the one that
is, the matmul's exact product ``eft.cuh:two_prod_fma``, is written out),
one process
per source, all started together, and links the objects into one shared
library.  The library lands in ``build/clrs_tpu_torch/`` at the repository
root, named by a hash of the sources and flags, so a changed source is
rebuilt; beside it, ``<library>.log`` keeps each source's compile seconds
and ptxas's register and spill report.  A failed build raises; nothing
falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "clrs_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # desc (9 int64: ops/cuda_dd._spd_inverse_plan), a, out, okf, scratch, stream
    "clrs_spd_inverse_xf": [ctypes.c_char_p, _P, _P, _P, _P, _P],
    # desc (16 int64: ops/cuda_xf._panel_plan), t, z, y, okf, scratch, stream
    "clrs_spd_panel_xf": [ctypes.c_char_p, _P, _P, _P, _P, _P, _P],
    # desc (23 int64: ops/cuda_xf._schur_plan), px, py, hh, out, stream
    "clrs_schur_pairs": [ctypes.c_char_p, _P, _P, _P, _P, _P],
    # desc (20 int64: ops/cuda_xf._matmul_plan), a, b, c, stream
    "clrs_matmul_xf": [ctypes.c_char_p, _P, _P, _P, _P],
    # test-only (tests/test_torch_cuda.py): a, b, p, e, p (Dekker), e (Dekker), n, stream
    "clrs_two_prod_pairs": [_P, _P, _P, _P, _P, _P, ctypes.c_longlong, _P],
    # k, entries (ops/cuda_xf._STEPLEN_ENTRY each), count, w, okf, scratch, stream
    "clrs_steplen_xf": [_I, ctypes.c_char_p, _I, _P, _P, _P, _P],
    "clrs_steplen_xf_capacity": [],
    # desc (20 int64: ops/cuda_xf._elemwise_plan), a, b, out, stream
    "clrs_elemwise_xf": [ctypes.c_char_p, _P, _P, _P, _P],
    # desc (10 int64: ops/cuda_dd._wide_plan), a, out, okf, scratch, stream
    "clrs_spd_inverse_dd_wide": [ctypes.c_char_p, _P, _P, _P, _P, _P],
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


def log_path() -> Path:
    return library_path().with_suffix(".log")


def _run(cmd, t0):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    return time.time() - t0, proc.stdout + proc.stderr


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
    shutil.rmtree(tmp, ignore_errors=True)  # a failed build's, in this process
    tmp.mkdir()
    nvcc = _nvcc()
    objs = [tmp / (src.stem + ".o") for src in cu]
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=len(cu)) as pool:
        runs = list(pool.map(
            lambda so: _run([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o",
                             str(so[1]), str(so[0])], t0),
            zip(cu, objs)))
    _run([nvcc, "-shared", "-o", str(tmp / path.name), *map(str, objs)], t0)
    build_seconds = time.time() - t0
    log = [f"build {build_seconds:.2f} s"]
    for src, (secs, out) in zip(cu, runs):
        log += [f"== {src.name}: compiled in {secs:.2f} s", out]
    (tmp / "build.log").write_text("\n".join(log))
    os.replace(tmp / "build.log", log_path())
    os.replace(tmp / path.name, path)
    shutil.rmtree(tmp, ignore_errors=True)
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


def stream(t) -> int:
    """The raw handle of the current stream on t's CUDA device (no Stream
    object is built), for a C entry's stream argument."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def cached_plan(plans: dict, key, make, *args):
    """make(*args), kept in plans under key (emptied at 4096 layouts): a
    kernel's description of its operands' layout, computed once for each."""
    plan = plans.get(key)
    if plan is None:
        if len(plans) >= 4096:
            plans.clear()
        plan = plans[key] = make(*args)
    return plan


def check(rc: int, name: str, k: int = 2):
    """Raise on a nonzero return of a C entry: -1 for a limb count the
    library holds no kernel for, else a cudaError_t of the launch."""
    if rc == -1:
        raise NotImplementedError(f"{name}: no kernel built for k={k}")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
