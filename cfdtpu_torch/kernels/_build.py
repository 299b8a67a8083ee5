"""Build and load the CUDA kernel library.

Each source in cfdtpu_torch/csrc/*.cu is compiled by its own nvcc
process, all started together, and the objects are linked into
cfdtpu_torch/_build/libcfdtpu_kernels.so (a plain C interface, loaded
with ctypes) at first use; the library is rebuilt when a source is
newer than it. Nothing here runs at import time: the CPU tests
import every module on machines without nvcc.

Each C entry point takes raw pointers, sizes, strides, an `is_f64`
flag and the CUDA stream, and returns cudaGetLastError() of its launch.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libcfdtpu_kernels.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

P = ctypes.c_void_p
I64 = ctypes.c_int64
I32 = ctypes.c_int
F64 = ctypes.c_double

# argument signatures of the C entry points (see the .cu files)
SIGNATURES = {
    # A, A strides (4), cols, X, ldx, ns, Kg, R, C, out, n_out, mode,
    # b, x, d, omega, is_f64, stream
    "cfd_sup_spmv": [P, I64, I64, I64, I64, P, P, I64, I64, I64, I64, I64,
                     P, I64, I32, P, P, P, F64, I32, P],
    # src, idx, out, n_in, n_out, K, F, is_f64, stream
    "cfd_ell_sum": [P, P, P, I64, I64, I64, I64, I32, P],
    # u, uprev, p, dofmap, coords, h, phi, dphi, qw, nc, nq,
    # rho, mu, dt, f0, f1, eps, ru_e, rp_e, is_f64, stream
    "cfd_ns_cell_residual_p1": [P, P, P, P, P, P, P, P, P, I64, I64,
                                F64, F64, F64, F64, F64, F64,
                                P, P, I32, P],
    # vals, e1, e2, kcol, inv_duu, contrib, nt, d, is_f64, stream
    "cfd_selfp_triple": [P, P, P, P, P, P, I64, I64, I32, P],
    # x, vals, idx, y, P, L, K, is_f64, stream
    "cfd_patch_spmv": [P, P, P, P, I64, I64, I64, I32, P],
    # inv, x, win, base, out, n, d, s, o, w, n_sub, is_f64, stream
    "cfd_ras_apply": [P, P, P, P, P, I64, I64, I64, I64, I64, I64, I32, P],
}

_lib = None
build_seconds = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    deps = _sources() + glob.glob(os.path.join(CSRC, "*.cuh"))
    return any(os.path.getmtime(s) > built for s in deps)


def build(force: bool = False) -> str:
    """Compile the library if it is missing or stale; returns its path.
    Raises on any compiler failure (no fallback)."""
    global build_seconds
    if not force and not _stale():
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in _sources():
        obj = os.path.join(BUILD_DIR, os.path.basename(src)[:-3]
                           + f".{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(" ".join(cmd) + "\n" + out)
    tmp = f"{LIB_PATH}.{tag}"
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
    if not failed:
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            failed.append(" ".join(link) + "\n" + res.stdout + res.stderr)
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("nvcc failed building the CUDA kernels:\n"
                           + "\n".join(failed))
    os.replace(tmp, LIB_PATH)  # atomic against a concurrent build
    build_seconds = time.perf_counter() - t0
    return LIB_PATH


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
