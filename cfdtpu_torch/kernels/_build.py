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
    # A, A strides (3), cols, ns, Kg, R, C, x0, m0, w0, xa0, x1, m1, xa1,
    # out, n0, R0, n1, mode, b, d, omega, scale, mask, mask_value, xc,
    # agg, w, xhat, cheby w, dprev, dout, add, ca, cc, vec, rpl, CV, KS,
    # lg, is_f64, stream
    "cfd_sup_spmv": [P, I64, I64, I64, P, I32, I32, I32, I32, P, I64, I32,
                     I32, P, I64, I32, P, I64, I32, I64, I32, P, P, F64,
                     P, P, P, P, P, I32, P, P, P, P, P, F64, F64, I32, I32,
                     I32, I32, I32, I32, P],
    # vals, rowptr, cols, n, x, rows, cols view, out, mode, b, scale,
    # mask, mask_value, cheby w, dprev, dout, add, ca, cc, lg, is_f64,
    # stream
    "cfd_bsr_spmv": [P, P, P, I32, P, I32, I32, P, I32, P, P, P, P, P, P, P,
                     P, F64, F64, I32, I32, P],
    # x, y, b, w, dprev, out, dout, n, ca, cc, is_f64, stream
    "cfd_cheby_update": [P, P, P, P, P, P, P, I64, F64, F64, I32, P],
    # src, row_ptr, pos, out, n_out, F, G, loads, is_f64, stream
    "cfd_ell_sum": [P, P, P, P, I64, I64, I32, I32, I32, P],
    # cell pointers (10: u, u_prev, u_prev2, p, dofmap, coords, h, phi,
    # dphi, qw), nc, nq, scalars (9: rho, mu, dt, f0, f1, eps, a0, a1,
    # a2), form, out0, out1, facet blocks nfb, their pointers (10 each),
    # sizes (nf, nq each), options (term, implicit each), scalars (c, c2
    # each), outputs, jacobian, is_f64, stream
    "cfd_ns_element_p1": [P, I64, I64, P, I32, P, P, I32, P, P, P, P, P,
                          I32, I32, P],
    # cell pointers (9: u, u_prev, p, dofmap, coords, h, phi, dphi, qw),
    # nc, nq, scalars (7: rho, mu, dt, f0, f1, f2, eps), out0, out1, facet
    # blocks nfb, their pointers (10 each), sizes, options, scalars,
    # outputs, jacobian, is_f64, stream
    "cfd_ns_element_tet": [P, I64, I64, P, P, P, I32, P, P, P, P, P, I32,
                           I32, P],
    # term, implicit, u, uprev, p, dofmap_u, dofmap_p, coords, phi_u,
    # dphi_u, phi_p, gdphi, normal, dS, h, nf, nq, c, c2, jacobian, out,
    # is_f64, stream
    "cfd_ns_facet_p1": [I32, I32, P, P, P, P, P, P, P, P, P, P, P, P, P,
                        I64, I64, F64, F64, I32, P, I32, P],
    # vals, e1, e2, kcol, inv_duu, contrib, nt, d, is_f64, stream
    "cfd_selfp_triple": [P, P, P, P, P, P, I64, I64, I32, P],
    # x, vals, idx, y, P, L, K, is_f64, stream
    "cfd_patch_spmv": [P, P, P, P, I64, I64, I64, I32, P],
    # inv, x, base, out, n, d, s, o, per_block, blocks, bulk, is_f64, stream
    "cfd_ras_apply": [P, P, P, P, I64, I64, I64, I64, I64, I64, I32, I32, P],
    # xc, agg, x, scale, out, n, width, is_f64, stream
    "cfd_amg_prolong": [P, P, P, P, P, I64, I32, I32, P],
    # V, n, j, w, scale, h, h stride, reorth, exchange, blocks, columns a
    # block, shared bytes, tiny, R, cs, sn, g, stat, tol, m, is_f64,
    # stream
    "cfd_krylov_cgs": [P, I64, I32, P, P, P, I64, I32, P, I32, I32, I32,
                       F64, P, P, P, P, P, P, I32, I32, P],
    # H, m, beta, Z, n, out, blocks, tiny, is_f64, stream
    "cfd_krylov_lsq": [P, I32, P, P, I64, P, I32, F64, I32, P],
    # R, R row stride, g, Z, n, x, j, out, blocks, is_f64, stream
    "cfd_krylov_tri": [P, I64, P, P, I64, P, I32, P, I32, I32, P],
    # inv, v, out, n, d, divide, is_f64, stream
    "cfd_block_jacobi": [P, P, P, I64, I32, I32, I32, P],
    # vals, bs, diag_pos, mask, inv, n, d, is_f64, stream
    "cfd_block_jacobi_inv": [P, I32, P, P, P, I64, I32, I32, P],
    # second, q1, b or q2, z1, z2, r, coef, out, n, tiny, is_f64, stream
    "cfd_amg_gcr2": [I32, P, P, P, P, P, P, P, I64, F64, I32, P],
    # stream (csrc/empty.cu: the launch floor, not a kernel of the port)
    "cfd_empty": [P],
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
