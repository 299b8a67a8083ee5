"""Newton-Krylov with backtracking line search.

The counterpart of cfdtpu/la/newton.py: flexible-GMRES Newton steps,
a halving line search on ||F||, Eisenstat-Walker forcing, and the
pc_lag / jac_lag options. cfdtpu's lax.while_loop is a host loop here;
it reads the residual norms once per Newton iteration (with ||dx|| and
||x + dx||) and once per further line-search trial.

The matrix-free default of cfdtpu (jax.linearize of F) is not ported:
callers pass make_operator. The distributed `shard` argument is not
ported either.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..utils.trace import count, span
from .gmres import fgmres


@dataclass(frozen=True)
class NewtonParams:
    max_it: int = 100
    rtol: float = 1e-8
    atol: float = 1e-10
    stol: float = 1e-8
    ksp_rtol: float = 1e-5
    ksp_atol: float = 0.0
    ksp_restart: int = 60
    ksp_maxiter: int = 1000
    ls_max_halvings: int = 6
    ls_alpha: float = 1e-4
    # Eisenstat-Walker adaptive forcing (PETSc -snes_ksp_ew)
    ew: bool = False
    ew_eta0: float = 0.1
    ew_eta_max: float = 0.9
    ew_gamma: float = 0.9
    ew_alpha: float = 2.0
    # lag the preconditioner: build it once from the initial state and
    # reuse it for every Newton iteration of the step
    pc_lag: bool = False
    # lag the Jacobian too (chord Newton): operator and preconditioner
    # from the initial state for every iteration of the step
    jac_lag: bool = False


def _norms(*vs):
    """Host read of several vector 2-norms in one transfer."""
    with span("norms"):
        return [float(v) for v in
                torch.stack([torch.linalg.vector_norm(v) for v in vs]).cpu()]


def newton_solve(
    F: Callable,
    x0,
    params: NewtonParams = NewtonParams(),
    make_operator: Callable | None = None,
    project: Callable | None = None,
):
    """Solve F(x) = 0 by Newton-Krylov.

    Args:
        F: residual function (n,) -> (n,).
        x0: initial guess.
        make_operator: x -> (matvec, precond | None), the Jacobian action
            and its preconditioner at x.
        project: optional nullspace projector applied to the update.

    Returns:
        (x, stats) with stats = {newton_iters, ksp_iters, ksp_max, fnorm,
        f0norm, converged, ls_failures} as Python numbers plus
        final_residual.
    """
    if make_operator is None:
        raise NotImplementedError(
            "newton_solve needs make_operator (the matrix-free jvp "
            "default of cfdtpu is not ported)"
        )
    p = params

    with span("residual"):
        f = F(x0)
    (fnorm,) = _norms(f)
    f0norm = fnorm
    ftol = max(p.atol, p.rtol * f0norm)

    M_lagged = None
    OP_lagged = None
    if p.jac_lag:
        OP_lagged = make_operator(x0)
    elif p.pc_lag:
        _, M_lagged = make_operator(x0)

    x = x0
    it = 0
    ksp_total = 0
    ksp_max = 0
    lsfail = 0
    eta = p.ew_eta0
    done = fnorm <= ftol
    while not done and it < p.max_it:
        if OP_lagged is not None:
            matvec, M = OP_lagged
        else:
            matvec, M = make_operator(x)
            if M_lagged is not None:
                M = M_lagged
        ksp_rtol = eta if p.ew else p.ksp_rtol
        with span("ksp"):
            dx, info = fgmres(
                matvec, -f, precond=M, restart=p.ksp_restart,
                maxiter=p.ksp_maxiter, rtol=ksp_rtol, atol=p.ksp_atol,
            )
        if project is not None:
            dx = project(dx)

        # backtracking line search on ||F||
        lam = 1.0
        x_new = x + dx
        with span("residual"):
            fnew = F(x_new)
        nnew, dxnorm, xnorm = _norms(fnew, dx, x_new)
        tries = 0
        while (not nnew <= (1.0 - p.ls_alpha * lam) * fnorm
               and tries < p.ls_max_halvings):
            lam *= 0.5
            x_new = x + lam * dx
            with span("residual"):
                fnew = F(x_new)
            nnew, xnorm = _norms(fnew, x_new)
            tries += 1
        ls_failed = nnew > (1.0 - p.ls_alpha * lam) * fnorm

        step_small = lam * dxnorm <= p.stol * max(xnorm, 1e-30)
        # stol-based convergence only counts when the step also
        # decreased ||F||
        converged = nnew <= ftol or (step_small and nnew <= fnorm)
        # Eisenstat-Walker choice 2 with the safeguard
        eta_cand = p.ew_gamma * (nnew / max(fnorm, 1e-300)) ** p.ew_alpha
        guard = p.ew_gamma * eta ** p.ew_alpha
        if guard > 0.1:
            eta_cand = max(eta_cand, guard)
        eta = min(max(eta_cand, 1e-6), p.ew_eta_max)

        x, f, fnorm = x_new, fnew, nnew
        it += 1
        count("newton_iters")
        count("ls_trials", tries)
        ksp_total += info["iters"]
        ksp_max = max(ksp_max, info["iters"])
        lsfail += int(ls_failed)
        done = converged

    stats = {
        "newton_iters": it,
        "ksp_iters": ksp_total,
        "ksp_max": ksp_max,  # most iterations of one linear solve
        "fnorm": fnorm,
        "f0norm": f0norm,
        "converged": bool(done),
        "ls_failures": lsfail,
        "final_residual": f,
    }
    return x, stats
