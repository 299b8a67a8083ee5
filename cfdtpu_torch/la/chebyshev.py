"""Chebyshev polynomial smoothing for the inner solves and the AMG levels.

The counterpart of cfdtpu/la/chebyshev.py. A sweep needs no dot product
at run time, only products and vector updates; its spectrum bound comes
from a short power iteration at preconditioner build.

estimate_lambda_max: 10 power steps of D^-1 A from the alternating +-1
start, then 1.05 lambda. Each step is the operator (K1) and K9's
normalisation with D^-1 as its elementwise scale; lambda stays on the
card, a (1,) tensor: nothing here reads the host. Where cfdtpu floors
||D^-1 A v|| at 1e-300 (0 in float32), K9 floors it at
sqrt(finfo.tiny): a zero product gives v = 0 and lambda = 0 on both.

chebyshev_fixed: m steps on the interval [f lambda, lambda] from x0 = 0.
With theta = lambda (1 + f) / 2 and delta = lambda (1 - f) / 2,
sigma1 = theta / delta = (1 + f) / (1 - f) depends on f alone, so the
rho recurrence and every step's two coefficients are host numbers
(cheby_coeffs), and the one vector a sweep needs is

    w = inv_diag / theta = 2 / (1 + f) * inv_diag / lambda  (cheby_scale)

built once per preconditioner build. In those terms cfdtpu's steps read

    x0 = d0 = w b
    d_k = a_k d_{k-1} + c_k w (b - A x_{k-1}),  x_k = x_{k-1} + d_k
    a_k = rho_k rho_{k-1},  c_k = 2 rho_k sigma1,
    rho_0 = 1 / sigma1,  rho_k = 1 / (2 sigma1 - rho_{k-1})

Where the operator is one K1 launch (an AMG level, Auu with its
Dirichlet rows) a step is that launch in K1's cheby mode (`step`);
otherwise (the SELFP S, two launches) the operator runs first and
cheby_update does the step's vector work. x0 = w b is K1's input scale
(never stored) or, before another operator, K10 at d = 1.
"""

from __future__ import annotations

import torch

from ..kernels.block_jacobi import block_jacobi
from ..kernels.krylov import krylov_cgs
from ..kernels.sup_spmv import cheby_update

POWER_STEPS = 10
SAFETY = 1.05


def estimate_lambda_max(matvec, inv_diag, iters: int = POWER_STEPS):
    """The largest eigenvalue of diag(inv_diag) A by power iteration from
    the alternating-sign start, times 1.05; a (1,) tensor on the card."""
    n = inv_diag.shape[0]
    v0 = torch.ones(n, dtype=inv_diag.dtype, device=inv_diag.device)
    v0[1::2] = -1.0
    V = [torch.empty((1, n), dtype=v0.dtype, device=v0.device)
         for _ in range(2)]
    beta = torch.empty((1,), dtype=v0.dtype, device=v0.device)
    krylov_cgs(V[0], v0, -1, beta, False)  # v0 / ||v0||
    for i in range(iters):
        # V[1] = D^-1 A v / ||D^-1 A v||, beta = ||D^-1 A v||
        krylov_cgs(V[(i + 1) % 2], matvec(V[i % 2][0]), -1, beta, False,
                   scale=inv_diag)
    return SAFETY * beta


def cheby_scale(inv_diag, lam, lam_min_frac: float):
    """w = inv_diag / theta, theta = lambda (1 + f) / 2: the sweep's one
    vector (lam a (1,) tensor; no host read)."""
    return inv_diag * ((2.0 / (1.0 + lam_min_frac)) / lam)


def cheby_coeffs(m: int, lam_min_frac: float) -> list[tuple[float, float]]:
    """(a_k, c_k) of steps k = 1 .. m-1 (host numbers)."""
    f = float(lam_min_frac)
    sigma1 = (1.0 + f) / (1.0 - f)
    rho = 1.0 / sigma1
    out = []
    for _ in range(m - 1):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        out.append((rho_new * rho, 2.0 * rho_new * sigma1))
        rho = rho_new
    return out


def chebyshev_fixed(matvec, b, w, m: int, lam_min_frac: float, step=None):
    """m Chebyshev steps for A x = b from x0 = 0 (cfdtpu's
    chebyshev_fixed with w = cheby_scale(inv_diag, lam_max, f)).

    step(x, b, scale, dprev, a, c, d_out) -> x + d, one K1 launch in
    cheby mode on the operator (x read as scale * x where scale is given,
    dprev None: d_{k-1} is that x; d written into d_out where given);
    without it, matvec and cheby_update."""
    coeffs = cheby_coeffs(m, lam_min_frac)
    if step is not None:
        if not coeffs:
            return block_jacobi(w.reshape(-1, 1, 1), b)
        x, scale, d = b, w, None
        for i, (a, c) in enumerate(coeffs):
            d_out = None if i == len(coeffs) - 1 else torch.empty_like(b)
            x = step(x, b, scale, d, a, c, d_out)
            scale, d = None, d_out
        return x
    x = block_jacobi(w.reshape(-1, 1, 1), b)  # x0 = d0 = w b
    d = None
    for i, (a, c) in enumerate(coeffs):
        d_out = None if i == len(coeffs) - 1 else torch.empty_like(b)
        x = cheby_update(x, matvec(x), b, w, d, a, c, d_out)
        d = d_out
    return x
