"""Flexible GMRES and fixed-sweep GMRES.

The counterpart of cfdtpu/la/gmres.py. Orthogonalisation is classical
Gram-Schmidt over the active basis rows (CGS2 in fgmres, one pass in
the fieldsplit sweeps): kernel K9's krylov_cgs, one launch a step, which
also normalises the new basis row and writes its Hessenberg column;
gmres_fixed's least-squares step is K9's krylov_lsq.

fgmres: cfdtpu's lax.while_loop becomes a host loop, and its Givens
recurrence stays on the device: each K9 step ends in the Givens update
of the new column (float64, as cfdtpu's host-free loop keeps it in its
state), and the cycle ends in K9's triangular solve and x + Z^T y. The
host reads only the continue flag and |g[j+1]| of each iteration, copied
into pinned memory, one iteration behind: iteration j+1 is queued before
the host waits on iteration j's flag, so the card always has the next
iteration in hand. An iteration queued after the one that converged is
discarded (it writes only past what the cycle's solve reads); none is
queued past the restart length or past maxiter. Beside those, the host
reads ||b|| and the first residual once a solve and ||r|| once a cycle.

gmres_fixed: a fixed trip count and no host reads at all, so the
fieldsplit sweeps inside the preconditioner queue on the device (and
are captured in its CUDA graph, la/schur.py).
"""

from __future__ import annotations

import torch

from ..kernels.krylov import Givens, krylov_cgs, krylov_lsq, krylov_lsq_tri
from ..utils.trace import count, counter, span

# fgmres's lookahead iterations that were queued and then discarded (the
# one after an iteration that converged), summed over every solve: the
# trace module's counter ksp_discarded
DISCARDED = counter("ksp_discarded")


def _identity_precond(v):
    return v


def gmres_fixed(matvec, b, precond=None, m: int = 10,
                reorth: bool = True):
    """Fixed-iteration right-preconditioned GMRES (no convergence test,
    no restart) — the inner solver for the fieldsplit sub-blocks. Safe
    inside an outer flexible GMRES. No host synchronisation."""
    M = precond if precond is not None else _identity_precond
    if m <= 0:
        # preonly semantics (PETSc ksp_type preonly): one application of
        # the preconditioner
        return M(b)
    n = b.shape[0]
    dt = b.dtype
    dev = b.device

    # rows beyond j+1 of V are never read (K9 takes the active rows);
    # H's column j below row j+1 stays zero
    V = torch.empty((m + 1, n), dtype=dt, device=dev)
    Z = torch.empty((m, n), dtype=dt, device=dev)
    H = torch.zeros((m + 1, m), dtype=dt, device=dev)
    beta = torch.empty((1,), dtype=dt, device=dev)
    krylov_cgs(V, b, -1, beta, False)  # V[0] = b / max(||b||, tiny)

    for j in range(m):
        z = M(V[j])
        w = matvec(z)
        Z[j] = z
        krylov_cgs(V, w, j, H[:, j], reorth)

    # least squares min ||beta e1 - H y|| via normal equations (m is
    # small), regularised relative to the spectrum so an exactly-zero rhs
    # yields y = 0, not NaN; then Z^T y
    return krylov_lsq(H, beta, Z)


class _StatReads:
    """The host's reads of the Givens tail's stat rows (|g[j+1]|, the
    continue flag). On the card each row is copied (cudaMemcpyAsync) into
    one of two pinned slots right after the launch that writes it, and
    read once the copy's event has passed: at most two rows are in
    flight, the one waited on and the one after it. On the CPU a row is
    read where it lies."""

    def __init__(self, stat):
        self.stat = stat
        self.cuda = stat.is_cuda
        if self.cuda:
            self.host = torch.empty((2, 2), dtype=torch.float64,
                                    pin_memory=True)
            self.ready = [torch.cuda.Event(), torch.cuda.Event()]

    def queue(self, k: int) -> None:
        if self.cuda:
            self.host[k % 2].copy_(self.stat[k], non_blocking=True)
            self.ready[k % 2].record()

    def wait(self, k: int) -> tuple[float, bool]:
        with span("ksp.wait"):
            if self.cuda:
                self.ready[k % 2].synchronize()
                row = self.host[k % 2]
            else:
                row = self.stat[k]
            res, go = row.tolist()
        return res, go != 0.0


def fgmres(
    matvec,
    b,
    x0=None,
    precond=None,
    restart: int = 30,
    maxiter: int = 1000,
    rtol: float = 1e-5,
    atol: float = 0.0,
):
    """Solve A x = b with flexible right-preconditioned GMRES.

    Stops when ||b - A x|| <= max(rtol*||b||, atol) (the Givens residual
    estimate) or after `maxiter` inner iterations in total, checked
    between restart cycles, as in cfdtpu.

    K9's Gram-Schmidt sweeps read the active basis rows only, as
    cfdtpu's with ortho_chunk > 0 do (the same products in another
    order), so the port has no such option.

    Returns (x, info) with info = {iters, resnorm, converged, discarded}
    as Python numbers (discarded: lookahead iterations queued and not
    used).
    """
    if x0 is None:
        x0 = torch.zeros_like(b)
    M = precond if precond is not None else _identity_precond
    m = int(restart)
    n = b.shape[0]
    dt = b.dtype
    dev = b.device

    def _norm(v):
        return torch.sqrt(torch.dot(v, v))

    # host read: ||b|| and the initial residual, once per solve
    norms = torch.stack([_norm(b), _norm(b - matvec(x0))])
    with span("ksp.wait"):
        bnorm, r0 = (float(v) for v in norms.cpu())
    tol = max(rtol * bnorm, atol)

    V = torch.empty((m + 1, n), dtype=dt, device=dev)
    Z = torch.empty((m, n), dtype=dt, device=dev)
    # K9's unrotated Hessenberg columns, one row each (the Givens tail
    # rotates its own float64 copy into giv.R), and ||r|| of a cycle
    HT = torch.empty((m, m + 1), dtype=dt, device=dev)
    hr = torch.empty((1,), dtype=dt, device=dev)
    giv = Givens(m, tol, dev)
    reads = _StatReads(giv.stat)

    def step(j):
        """Queue inner iteration j; its stat row is j+1."""
        z = M(V[j])
        w = matvec(z)
        Z[j] = z
        # CGS2 against the active rows V[0..j], then the Givens update
        krylov_cgs(V, w, j, HT[j], True, giv)
        reads.queue(j + 1)

    def cycle(x, done):
        """One restart cycle after `done` iterations; returns (x_new,
        resnorm, inner_iters, discarded)."""
        count("ksp_cycles")
        r = b - matvec(x)
        # V[0] = r / max(||r||, tiny), g = ||r|| e1
        krylov_cgs(V, r, -1, hr, False, giv)
        reads.queue(0)
        res, go = reads.wait(0)  # host read: ||r||, once per cycle
        j = wasted = 0
        if go:
            step(0)
        while go:
            # iteration j is queued: queue j+1 before waiting on j
            ahead = j + 1 < m and done + j + 2 <= maxiter
            if ahead:
                step(j + 1)
            res, go = reads.wait(j + 1)
            j += 1
            if not go:
                wasted = int(ahead)
            elif not ahead:
                step(j)
        if j == 0:
            return x, res, 0, 0
        # the back-substitution on the leading j x j triangle, x + Z^T y
        return krylov_lsq_tri(giv.R, giv.g, Z, x, j), res, j, wasted

    x = x0
    res = r0
    iters = discarded = 0
    while res > tol and iters < maxiter:
        x, res, j, wasted = cycle(x, iters)
        iters += j
        discarded += wasted
    DISCARDED.n += discarded
    count("ksp_iters", iters)
    return x, {"iters": iters, "resnorm": res, "converged": res <= tol,
               "discarded": discarded}
