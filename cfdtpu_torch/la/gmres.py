"""Flexible GMRES and fixed-sweep GMRES.

The counterpart of cfdtpu/la/gmres.py. Orthogonalisation is classical
Gram-Schmidt over the active basis rows (CGS2 in fgmres, one pass in
the fieldsplit sweeps): kernel K9's krylov_cgs, which also normalises
the new basis row and writes its Hessenberg column; gmres_fixed's
least-squares step is K9's krylov_lsq.

fgmres: cfdtpu's lax.while_loop becomes a host loop. It synchronises
with the device once per inner iteration — one read of the new
Hessenberg column (j+2 values, the last being ||w||) — and once per
restart cycle for the residual norm ||b - A x||. The Givens rotations
and the back-substitution act on that small host copy, in float64.

gmres_fixed: a fixed trip count and no host reads at all, so the
fieldsplit sweeps inside the preconditioner queue on the device (and
are captured in its CUDA graph, la/schur.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.krylov import krylov_cgs, krylov_lsq, tiny as _tiny


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
    estimate) or after `maxiter` inner iterations in total.

    Returns (x, info) with info = {iters, resnorm, converged} as Python
    numbers.
    """
    if x0 is None:
        x0 = torch.zeros_like(b)
    M = precond if precond is not None else _identity_precond
    m = int(restart)
    n = b.shape[0]
    dt = b.dtype
    dev = b.device
    tiny = _tiny(dt)

    def _norm(v):
        return torch.sqrt(torch.dot(v, v))

    # host read: ||b|| and the initial residual, once per solve
    bnorm, r0 = (float(v) for v in
                 torch.stack([_norm(b), _norm(b - matvec(x0))]).cpu())
    tol = max(rtol * bnorm, atol)

    V = torch.empty((m + 1, n), dtype=dt, device=dev)
    Z = torch.zeros((m, n), dtype=dt, device=dev)
    # the Hessenberg columns, one row each (K9 writes column j into HT[j],
    # so the host reads j+2 contiguous values), and ||r|| of a cycle
    HT = torch.empty((m, m + 1), dtype=dt, device=dev)
    hr = torch.empty((1,), dtype=dt, device=dev)

    def cycle(x):
        """One restart cycle; returns (x_new, resnorm, inner_iters)."""
        r = b - matvec(x)
        krylov_cgs(V, r, -1, hr, False)  # V[0] = r / max(||r||, tiny)
        beta = float(hr[0])  # host read: once per restart cycle
        R = np.zeros((m + 1, m))  # Hessenberg, rotated in place (host)
        g = np.zeros(m + 1)
        g[0] = beta
        cs = np.zeros(m)
        sn = np.zeros(m)
        j = 0
        res = beta
        while j < m and res > tol:
            z = M(V[j])
            w = matvec(z)
            Z[j] = z
            # CGS2 against the active rows V[0..j]
            krylov_cgs(V, w, j, HT[j], True)
            # host read: the new Hessenberg column, once per iteration
            h = np.zeros(m + 1)
            h[: j + 2] = HT[j, : j + 2].cpu().numpy()

            # apply the previous Givens rotations to the new column
            for i in range(j):
                t0 = cs[i] * h[i] + sn[i] * h[i + 1]
                t1 = -sn[i] * h[i] + cs[i] * h[i + 1]
                h[i], h[i + 1] = t0, t1
            # new rotation annihilating h[j+1]
            denom = np.sqrt(h[j] ** 2 + h[j + 1] ** 2)
            c = h[j] / max(denom, tiny)
            s = h[j + 1] / max(denom, tiny)
            h[j] = denom
            h[j + 1] = 0.0
            cs[j] = c
            sn[j] = s
            g1 = -s * g[j]
            g[j] = c * g[j]
            g[j + 1] = g1
            R[:, j] = h
            j += 1
            res = abs(g1)

        # back-substitution on the leading j x j block
        y = np.zeros(m)
        if j > 0:
            Rj = torch.as_tensor(R[:j, :j])
            gj = torch.as_tensor(g[:j])[:, None]
            y[:j] = torch.linalg.solve_triangular(
                Rj, gj, upper=True)[:, 0].numpy()
        y_t = torch.as_tensor(y, dtype=dt, device=dev)
        return x + Z.T @ y_t, res, j

    x = x0
    res = r0
    iters = 0
    while res > tol and iters < maxiter:
        x, res, j = cycle(x)
        iters += j
    return x, {"iters": iters, "resnorm": res, "converged": res <= tol}
