"""K9 (kernels/krylov.py) through the port's GMRES against cfdtpu (JAX).

On the CPU the wrappers take their plain versions: krylov_cgs (the
Gram-Schmidt step, once or twice) and krylov_lsq (the normal equations
of gmres_fixed and Z^T y). They are held here inside the port's
gmres_fixed and fgmres against cfdtpu/la/gmres.py on small dense
systems made with numpy, and alone against numpy.

Tolerances: float64 on both sides, the same algorithm; only the order
of the sums differs. gmres_fixed chains m sweeps and one m x m solve
(1e-12 relative); fgmres must take the same iterations and reach x
within 1e-10 (its tolerance test and restarts amplify the last digits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdtpu.la.gmres import fgmres as jax_fgmres
from cfdtpu.la.gmres import gmres_fixed as jax_gmres_fixed

from cfdtpu_torch import kernels
from cfdtpu_torch.kernels.krylov import (krylov_cgs, krylov_cgs_plain,
                                         krylov_lsq, krylov_lsq_plain, tiny)
from cfdtpu_torch.la.gmres import fgmres, gmres_fixed

torch.set_num_threads(1)

N = 60


def _system(seed):
    """A nonsymmetric, diagonally dominant A, a Jacobi-like right
    preconditioner and a right-hand side."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, N)) / np.sqrt(N) + 3.0 * np.eye(N)
    dinv = 1.0 / (np.diag(A) + 0.1 * rng.standard_normal(N))
    b = rng.standard_normal(N)
    return A, dinv, b


def _both(A, dinv):
    jA, jd = jnp.asarray(A), jnp.asarray(dinv)
    tA, td = torch.as_tensor(A), torch.as_tensor(dinv)
    return ((lambda v: jA @ v), (lambda v: v * jd),
            (lambda v: tA @ v), (lambda v: v * td))


def _close(got, ref, rtol):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-300)
    assert np.abs(got - ref).max() <= rtol * scale


@pytest.mark.parametrize("reorth", [False, True])
@pytest.mark.parametrize("m", [1, 5, 10])
def test_gmres_fixed_matches_cfdtpu(m, reorth):
    A, dinv, b = _system(m)
    jmv, jpc, tmv, tpc = _both(A, dinv)
    ref = jax_gmres_fixed(jmv, jnp.asarray(b), precond=jpc, m=m,
                          reorth=reorth)
    kernels.reset_counts()
    got = gmres_fixed(tmv, torch.as_tensor(b), precond=tpc, m=m,
                      reorth=reorth)
    _close(got, ref, 1e-12)
    # CPU tensors: the plain versions, no kernel launch
    assert kernels.counts()["krylov_cgs"] == 0
    assert kernels.counts()["krylov_lsq"] == 0


@pytest.mark.parametrize("reorth", [False, True])
def test_gmres_fixed_zero_rhs(reorth):
    """An exactly-zero right-hand side gives exactly zero (the
    regularised normal equations and the beta > tiny mask), as in
    cfdtpu."""
    A, dinv, _ = _system(3)
    jmv, jpc, tmv, tpc = _both(A, dinv)
    ref = np.asarray(jax_gmres_fixed(jmv, jnp.zeros(N), precond=jpc, m=5,
                                     reorth=reorth))
    got = gmres_fixed(tmv, torch.zeros(N, dtype=torch.float64),
                      precond=tpc, m=5, reorth=reorth)
    assert np.array_equal(ref, np.zeros(N))
    assert torch.equal(got, torch.zeros(N, dtype=torch.float64))


@pytest.mark.parametrize("restart", [4, 30])
def test_fgmres_matches_cfdtpu(restart):
    """Equal iteration counts and x within 1e-10, with restarts (4) and
    without (30)."""
    A, dinv, b = _system(11)
    jmv, jpc, tmv, tpc = _both(A, dinv)
    jx, jinfo = jax_fgmres(jmv, jnp.asarray(b), precond=jpc,
                           restart=restart, maxiter=200, rtol=1e-10)
    tx, tinfo = fgmres(tmv, torch.as_tensor(b), precond=tpc,
                       restart=restart, maxiter=200, rtol=1e-10)
    assert tinfo["iters"] == int(jinfo["iters"])
    assert tinfo["converged"] and bool(jinfo["converged"])
    _close(tx, jx, 1e-10)


@pytest.mark.parametrize("reorth", [False, True])
@pytest.mark.parametrize("j", [-1, 0, 3])
def test_krylov_cgs_plain_against_numpy(j, reorth):
    """One step on an orthonormal basis: h, ||u|| and V[j+1] as numpy
    computes them; rows past j+1 and H entries past j+1 untouched."""
    rng = np.random.default_rng(7 + j)
    rows, n = 6, 40
    q, _ = np.linalg.qr(rng.standard_normal((n, rows)))
    V0 = q.T.copy()
    w = rng.standard_normal(n)
    V = torch.as_tensor(V0)
    h = torch.full((rows,), -7.0, dtype=torch.float64)
    krylov_cgs(V, torch.as_tensor(w), j, h, reorth)
    Va = V0[: j + 1]
    u, hh = w.copy(), np.zeros(j + 1)
    for _ in range(2 if reorth else 1):
        p = Va @ u
        u = u - Va.T @ p
        hh += p
    nrm = np.linalg.norm(u)
    np.testing.assert_allclose(h[: j + 1].numpy(), hh, rtol=0, atol=1e-13)
    assert abs(float(h[j + 1]) - nrm) <= 1e-13 * nrm
    np.testing.assert_allclose(V[j + 1].numpy(), u / nrm, rtol=0,
                               atol=1e-13)
    assert torch.equal(V[j + 2:], torch.as_tensor(V0[j + 2:]))
    assert bool((h[j + 2:] == -7.0).all())


def test_krylov_cgs_zero_vector():
    """A zero w leaves V[j+1] = 0 (division by tiny, not by zero)."""
    V = torch.zeros((3, 8), dtype=torch.float64)
    V[0, 0] = 1.0
    h = torch.zeros(3, dtype=torch.float64)
    krylov_cgs_plain(V, torch.zeros(8, dtype=torch.float64), 0, h, True)
    assert torch.equal(V[1], torch.zeros(8, dtype=torch.float64))
    assert float(h[1]) == 0.0
    assert tiny(torch.float64) > 0.0


@pytest.mark.parametrize("m", [1, 5, 20])
def test_krylov_lsq_plain_against_numpy(m):
    """Z^T y with y from the regularised normal equations of H (a well
    conditioned Hessenberg matrix: the normal equations square its
    condition number, and two solvers agree to cond * eps)."""
    rng = np.random.default_rng(m)
    H = np.triu(rng.standard_normal((m + 1, m)), -1) + 4.0 * np.eye(m + 1, m)
    Z = rng.standard_normal((m, 30))
    beta = 1.7
    HtH = H.T @ H
    reg = max(np.trace(HtH) / m, tiny(torch.float64)) * 1e-12
    y = np.linalg.solve(HtH + reg * np.eye(m), H[0] * beta)
    got = krylov_lsq(torch.as_tensor(H), torch.tensor([beta],
                                                      dtype=torch.float64),
                     torch.as_tensor(Z))
    _close(got, Z.T @ y, 1e-12)
    zero = krylov_lsq_plain(torch.as_tensor(H),
                            torch.zeros(1, dtype=torch.float64),
                            torch.as_tensor(Z))
    assert torch.equal(zero, torch.zeros(30, dtype=torch.float64))


@pytest.mark.parametrize("call", ["cgs", "lsq"])
def test_krylov_wrappers_refuse_bad_shapes(call):
    V = torch.zeros((4, 10), dtype=torch.float64)
    with pytest.raises(ValueError):
        if call == "cgs":
            krylov_cgs(V, torch.zeros(10, dtype=torch.float64), 3,
                       torch.zeros(5, dtype=torch.float64), False)
        else:
            krylov_lsq(torch.zeros((4, 4), dtype=torch.float64),
                       torch.ones(1, dtype=torch.float64), V)
