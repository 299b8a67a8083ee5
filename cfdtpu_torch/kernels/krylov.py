"""K9 krylov: the Gram-Schmidt step of GMRES, with FGMRES's Givens
update as an optional tail, and the small solves that end a fixed sweep
or a restart cycle (csrc/krylov.cu).

krylov_cgs(V, w, j, h, reorth, givens=None): classical Gram-Schmidt of
w against the active basis rows V[:j+1] (none at j = -1, the starting
vector), once, or twice with reorth (CGS2), in place:

    h[:j+1] = the projections (both passes summed)
    h[j+1]  = ||u||,   u = w with its projections removed
    V[j+1]  = u / max(||u||, tiny)

V is (rows, n) row-major; h any 1-D view of at least j+2 entries (the
Hessenberg column H[:, j], or a row of a transposed copy). w is read
only. At j = -1 an elementwise `scale` (w's shape) may stand beside w:
the step then normalises u = scale * w, so that after y = A v it is one
power-iteration step of scale * A (la/chebyshev.py). One launch
(cgs_plan gives its grid and whether the active rows
stay in shared memory), which exchanges its block sums through a
buffer kept per device (_exchange): one such launch runs at a time.

With `givens`, FGMRES's cycle state (Givens), the step ends in the
Givens update of the new column, in float64 whatever the vectors' type,
as fgmres did on the host:

    j >= 0: hd = h[:j+2] in float64, rotated by cs[:j], sn[:j]; the new
            rotation cs[j], sn[j] zeroes hd[j+1]; g[j], g[j+1] rotated;
            R[j] = hd (row j of R is column j of the triangle);
            stat[j+1] = (|g[j+1]|, |g[j+1]| > tol and j + 1 < m)
    j = -1: g = ||w|| e1; stat[0] = (||w||, ||w|| > tol and m > 0)

krylov_lsq(H, beta, Z): gmres_fixed's least-squares step, Z^T y with y
the solution of the m x m normal equations

    (H^T H + reg I) y = H[0] beta,   reg = max(trace(H^T H) / m, tiny) 1e-12

set to zero unless beta > tiny (an exactly-zero right-hand side gives
y = 0, not NaN). The small system is formed and solved in float64 for
either vector type: the normal equations square H's condition number.

krylov_lsq_tri(R, g, Z, x, j): the same kernel's triangular mode, the
end of an FGMRES cycle: x + Z[:j]^T y with y the solution of the upper
triangle R[:j,:j] y = g[:j] (R row k is column k), solved in float64.
It counts as a krylov_lsq launch.

tiny is sqrt of the vector type's smallest normal number, as in cfdtpu.
"""

from __future__ import annotations

import torch

from . import COUNTERS
from ._common import (check_float, check_same_device, is_f64, on_cuda,
                      require, sm_count, stream_handle)

_COUNT_CGS = COUNTERS["krylov_cgs"]
_COUNT_SCALED = COUNTERS["krylov_cgs_scaled"]
_COUNT_LSQ = COUNTERS["krylov_lsq"]

THREADS = 256  # kThreads in the .cu
MAX_ROWS = 128  # kMaxRows: basis rows (restart + 1) at most
MAX_M = 64  # kMaxM: krylov_lsq's m at most
MAX_BLOCKS = 160  # kMaxBlocks: blocks of a krylov_cgs step at most
# kSmemCgs: the shared memory a block of krylov_cgs may fill with its
# slice of the active rows and of u (of the 227 KB an H100 block can use)
SMEM_RESIDENT = 200 * 1024


def tiny(dtype) -> float:
    """cfdtpu's division guard: sqrt of the smallest normal number."""
    return float(torch.finfo(dtype).tiny) ** 0.5


def grid(n: int, sms: int) -> int:
    """Blocks of krylov_lsq's pass over n columns: one column a thread,
    at most two blocks a multiprocessor. A plain function of n and the
    card."""
    return max(1, min(-(-n // THREADS), 2 * sms))


def cgs_plan(n: int, j: int, itemsize: int, sms: int
             ) -> tuple[int, int, int]:
    """(blocks, columns a block, dynamic shared bytes) of one krylov_cgs
    step: one block a multiprocessor at most, a contiguous slice of at
    least two columns a thread each (fewer blocks exchange fewer sums,
    which pays at the S stage's 35,425); the bytes are those of the slice
    of the j+1 active rows and of u, or 0 (the streamed path) where they
    exceed SMEM_RESIDENT. The grid is a plain function of n and the card,
    so the partial sums of two calls meet in the same order, on either
    path."""
    nb = max(1, min(sms, MAX_BLOCKS, -(-n // (2 * THREADS))))
    cols = -(-n // nb)
    smem = (j + 2) * cols * itemsize
    return nb, cols, (smem if smem <= SMEM_RESIDENT else 0)


# the exchange of krylov_cgs's block sums: a launch counter, then one
# 64-bit word (a float, or half a double, beside the launch's tag) for
# each block and each row of the three reductions
XCH_WORDS = 1 + (2 * MAX_ROWS + 1) * MAX_BLOCKS * 2
_EXCHANGES: dict[int, torch.Tensor] = {}


def _exchange(device) -> torch.Tensor:
    """The exchange on `device`, zeroed once and kept: each launch reads
    the counter for its tag and adds one, so it serves every launch and
    every graph replay, one launch at a time (the port's single stream).
    Made outside a graph capture (a capture's first call is its eager
    warm-up), so that its zeros are real."""
    idx = device.index
    if idx not in _EXCHANGES:
        require(not torch.cuda.is_current_stream_capturing(),
                "krylov_cgs: first call inside a CUDA graph capture")
        _EXCHANGES[idx] = torch.zeros(XCH_WORDS, dtype=torch.int64,
                                      device=device)
    return _EXCHANGES[idx]


class Givens:
    """FGMRES's rotated Hessenberg state for a restart length m, in
    float64 on the vectors' device: R (m, m+1), row j the rotated column
    j; cs and sn (m,); g (m+1,); stat (m+1, 2), row j+1 (|g[j+1]|,
    continue) after step j and row 0 after the cycle's start; tol (1,),
    the stopping test's absolute tolerance."""

    def __init__(self, m: int, tol: float, device):
        f64 = dict(dtype=torch.float64, device=device)
        self.m = int(m)
        self.R = torch.empty((m, m + 1), **f64)
        self.cs = torch.empty((m,), **f64)
        self.sn = torch.empty((m,), **f64)
        self.g = torch.empty((m + 1,), **f64)
        self.stat = torch.empty((m + 1, 2), **f64)
        self.tol = torch.full((1,), float(tol), **f64)


def givens_plain(h, j: int, G: Givens, gtiny: float) -> None:
    """The plain PyTorch version of the Givens tail, on a float64 copy of
    the column h[:j+2], operation by operation as fgmres did in numpy."""
    m = G.m
    cs, sn, g = G.cs, G.sn, G.g
    st = G.stat[j + 1]
    if j < 0:
        beta = h[0].double()
        g.zero_()
        g[0] = beta
        st[0] = beta
        st[1] = ((beta > G.tol[0]) & (m > 0)).double()
        return
    hd = torch.zeros(m + 1, dtype=torch.float64, device=h.device)
    hd[: j + 2] = h[: j + 2].double()
    for i in range(j):
        t0 = cs[i] * hd[i] + sn[i] * hd[i + 1]
        t1 = -sn[i] * hd[i] + cs[i] * hd[i + 1]
        hd[i], hd[i + 1] = t0, t1
    denom = torch.sqrt(hd[j] * hd[j] + hd[j + 1] * hd[j + 1])
    den = torch.clamp(denom, min=gtiny)
    c, s = hd[j] / den, hd[j + 1] / den
    hd[j], hd[j + 1] = denom, 0.0
    cs[j], sn[j] = c, s
    g1 = -s * g[j]
    g[j] = c * g[j]
    g[j + 1] = g1
    G.R[j] = hd
    st[0] = g1.abs()
    st[1] = ((st[0] > G.tol[0]) & (j + 1 < m)).double()


def krylov_cgs_plain(V, w, j: int, h, reorth: bool,
                     givens: Givens | None = None, scale=None) -> None:
    """The plain PyTorch version: cfdtpu's products over the active rows,
    then the Givens tail."""
    if scale is not None:
        w = scale * w
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
    if givens is not None:
        givens_plain(h, j, givens, tiny(w.dtype))


def krylov_cgs(V, w, j: int, h, reorth: bool,
               givens: Givens | None = None, scale=None) -> None:
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
    if scale is not None:
        check_float("scale", scale, V.dtype)
        require(j == -1 and scale.shape == w.shape and scale.is_contiguous(),
                "krylov_cgs: scale is built for the normalisation (j = -1), "
                "contiguous of w's shape")
    check_same_device(("V", V), ("w", w), ("h", h), ("scale", scale))
    G = givens
    if G is not None:
        require(j + 1 <= G.m <= MAX_ROWS,
                f"krylov_cgs: Givens of m={G.m} for step j={j}")
        check_same_device(("V", V), ("R", G.R))
    if not on_cuda(V):
        return krylov_cgs_plain(V, w, j, h, reorth, G, scale)
    from ._build import check, library

    nb, cols, smem = cgs_plan(n, j, V.element_size(),
                              sm_count(V.device.index))
    tail = ((0,) * 6 + (0,) if G is None else
            (G.R.data_ptr(), G.cs.data_ptr(), G.sn.data_ptr(),
             G.g.data_ptr(), G.stat.data_ptr(), G.tol.data_ptr(), G.m))
    with torch.cuda.device(V.device):
        rc = library().cfd_krylov_cgs(
            V.data_ptr(), n, j, w.data_ptr(),
            None if scale is None else scale.data_ptr(), h.data_ptr(),
            h.stride(0),
            int(bool(reorth)), _exchange(V.device).data_ptr(), nb, cols,
            smem, tiny(V.dtype),
            *tail, is_f64(V), stream_handle(V))
    _COUNT_CGS.n += 1
    if scale is not None:
        _COUNT_SCALED.n += 1
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


def krylov_lsq_tri_plain(R, g, Z, x, j: int):
    """The plain PyTorch version: the triangle solved in float64 by
    torch.linalg.solve_triangular (as fgmres did on the host), then
    x + Z[:j]^T y."""
    y = torch.linalg.solve_triangular(R[:j, :j].T, g[:j, None],
                                      upper=True)[:, 0]
    return x + Z[:j].T @ y.to(Z.dtype)


def krylov_lsq_tri(R, g, Z, x, j: int):
    check_float("Z", Z)
    check_float("x", x, Z.dtype)
    require(R.dtype == torch.float64 and g.dtype == torch.float64,
            "krylov_lsq_tri: R and g must be float64")
    require(Z.dim() == 2 and Z.is_contiguous(),
            "krylov_lsq_tri: Z must be contiguous (m, n)")
    m, n = Z.shape
    require(1 <= j <= min(m, MAX_ROWS - 1),
            f"krylov_lsq_tri: j={j} outside [1, {min(m, MAX_ROWS - 1)}]")
    require(x.dim() == 1 and x.shape[0] == n and x.is_contiguous(),
            f"krylov_lsq_tri: x must be contiguous ({n},)")
    require(R.dim() == 2 and R.shape[0] >= j and R.shape[1] >= j
            and R.stride(1) == 1,
            f"krylov_lsq_tri: R must hold {j} rows of {j} contiguous "
            "values")
    require(g.dim() == 1 and g.shape[0] >= j and g.stride(0) == 1,
            f"krylov_lsq_tri: g must be contiguous with {j} entries")
    check_same_device(("Z", Z), ("x", x), ("R", R), ("g", g))
    if not on_cuda(Z):
        return krylov_lsq_tri_plain(R, g, Z, x, j)
    from ._build import check, library

    out = torch.empty_like(x)
    with torch.cuda.device(Z.device):
        rc = library().cfd_krylov_tri(
            R.data_ptr(), R.stride(0), g.data_ptr(), Z.data_ptr(), n,
            x.data_ptr(), j, out.data_ptr(),
            grid(n, sm_count(Z.device.index)), is_f64(Z), stream_handle(Z))
    _COUNT_LSQ.n += 1
    check(rc, "krylov_lsq_tri")
    return out
