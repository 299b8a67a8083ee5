"""K9 krylov: the Gram-Schmidt step and the small least-squares solve of
GMRES (csrc/krylov.cu).

krylov_cgs(V, w, j, h, reorth): classical Gram-Schmidt of w against the
active basis rows V[:j+1] (none at j = -1, the starting vector), once,
or twice with reorth (CGS2), in place:

    h[:j+1] = the projections (both passes summed)
    h[j+1]  = ||u||,   u = w with its projections removed
    V[j+1]  = u / max(||u||, tiny)

V is (rows, n) row-major; h any 1-D view of at least j+2 entries (the
Hessenberg column H[:, j], or a row of a transposed copy). w is read
only.

krylov_lsq(H, beta, Z): gmres_fixed's least-squares step, Z^T y with y
the solution of the m x m normal equations

    (H^T H + reg I) y = H[0] beta,   reg = max(trace(H^T H) / m, tiny) 1e-12

set to zero unless beta > tiny (an exactly-zero right-hand side gives
y = 0, not NaN). The small system is formed and solved in float64 for
either vector type: the normal equations square H's condition number.

tiny is sqrt of the vector type's smallest normal number, as in cfdtpu.
"""

from __future__ import annotations

import torch

from . import COUNTERS
from ._common import (check_float, check_same_device, is_f64, on_cuda,
                      require, sm_count, stream_handle)

_COUNT_CGS = COUNTERS["krylov_cgs"]
_COUNT_LSQ = COUNTERS["krylov_lsq"]

THREADS = 256  # kThreads in the .cu
MAX_ROWS = 128  # kMaxRows: basis rows (restart + 1) at most
MAX_M = 64  # kMaxM: krylov_lsq's m at most


def tiny(dtype) -> float:
    """cfdtpu's division guard: sqrt of the smallest normal number."""
    return float(torch.finfo(dtype).tiny) ** 0.5


def grid(n: int, sms: int) -> int:
    """Blocks of one pass over n columns: one column a thread, at most two
    blocks a multiprocessor. A plain function of n and the card, so the
    partial sums of two calls meet in the same order."""
    return max(1, min(-(-n // THREADS), 2 * sms))


def krylov_cgs_plain(V, w, j: int, h, reorth: bool) -> None:
    """The plain PyTorch version: cfdtpu's products over the active rows."""
    if j >= 0:
        Va = V[: j + 1]
        hh = Va @ w
        w = w - Va.T @ hh
        if reorth:
            h2 = Va @ w
            w = w - Va.T @ h2
            hh = hh + h2
        h[: j + 1] = hh
    wnorm = torch.sqrt(torch.dot(w, w))
    h[j + 1] = wnorm
    V[j + 1] = w / torch.clamp(wnorm, min=tiny(w.dtype))


def krylov_cgs(V, w, j: int, h, reorth: bool) -> None:
    check_float("V", V)
    check_float("w", w, V.dtype)
    check_float("h", h, V.dtype)
    require(V.dim() == 2 and V.is_contiguous(),
            "krylov_cgs: V must be contiguous (rows, n)")
    rows, n = V.shape
    require(w.dim() == 1 and w.shape[0] == n and w.is_contiguous(),
            f"krylov_cgs: w must be contiguous ({n},)")
    require(-1 <= j <= rows - 2 and j + 1 <= MAX_ROWS,
            f"krylov_cgs: j={j} outside [-1, {min(rows, MAX_ROWS + 1) - 2}]")
    require(h.dim() == 1 and h.shape[0] >= j + 2,
            f"krylov_cgs: h must be 1-D with at least {j + 2} entries")
    check_same_device(("V", V), ("w", w), ("h", h))
    if not on_cuda(V):
        return krylov_cgs_plain(V, w, j, h, reorth)
    from ._build import check, library

    nb = grid(n, sm_count(V.device.index))
    k = j + 1
    scratch = torch.empty((nb * (2 * k + 1) + max(k, 1),), dtype=V.dtype,
                          device=V.device)
    with torch.cuda.device(V.device):
        rc = library().cfd_krylov_cgs(
            V.data_ptr(), n, j, w.data_ptr(), h.data_ptr(), h.stride(0),
            int(bool(reorth)), scratch.data_ptr(), nb, tiny(V.dtype),
            is_f64(V), stream_handle(V))
    _COUNT_CGS.n += 1
    check(rc, "krylov_cgs")


def krylov_lsq_plain(H, beta, Z):
    """The plain PyTorch version: cfdtpu's normal equations
    (la/gmres.py:78-81), formed and solved in float64."""
    m = Z.shape[0]
    t = tiny(Z.dtype)
    Hd = H.double()
    HtH = Hd.T @ Hd
    reg = torch.clamp(torch.trace(HtH) / m, min=t) * 1e-12
    rhs = Hd[0] * beta.reshape(()).double()
    eye = torch.eye(m, dtype=torch.float64, device=H.device)
    y, _ = torch.linalg.solve_ex(HtH + reg * eye, rhs)
    y = torch.where(beta.reshape(()) > t, y.to(Z.dtype),
                    torch.zeros((), dtype=Z.dtype, device=Z.device))
    return Z.T @ y


def krylov_lsq(H, beta, Z):
    check_float("H", H)
    check_float("beta", beta, H.dtype)
    check_float("Z", Z, H.dtype)
    require(Z.dim() == 2 and Z.is_contiguous(),
            "krylov_lsq: Z must be contiguous (m, n)")
    m, n = Z.shape
    require(1 <= m <= MAX_M, f"krylov_lsq: m={m} outside [1, {MAX_M}]")
    require(tuple(H.shape) == (m + 1, m) and H.is_contiguous(),
            f"krylov_lsq: H must be contiguous ({m + 1}, {m})")
    require(beta.numel() == 1, "krylov_lsq: beta must hold one value")
    check_same_device(("H", H), ("beta", beta), ("Z", Z))
    if not on_cuda(Z):
        return krylov_lsq_plain(H, beta, Z)
    from ._build import check, library

    out = torch.empty((n,), dtype=Z.dtype, device=Z.device)
    with torch.cuda.device(Z.device):
        rc = library().cfd_krylov_lsq(
            H.data_ptr(), m, beta.data_ptr(), Z.data_ptr(), n,
            out.data_ptr(), grid(n, sm_count(Z.device.index)),
            tiny(Z.dtype), is_f64(Z), stream_handle(Z))
    _COUNT_LSQ.n += 1
    check(rc, "krylov_lsq")
    return out
