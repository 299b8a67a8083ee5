"""K9 (kernels/krylov.py) through the port's GMRES against cfdtpu (JAX).

On the CPU the wrappers take their plain versions: krylov_cgs (the
Gram-Schmidt step, once or twice, with fgmres's Givens update as its
tail) and krylov_lsq (the normal equations of gmres_fixed and Z^T y; in
its triangular mode fgmres's back-substitution and x + Z^T y). They are
held here inside the port's gmres_fixed and fgmres against
cfdtpu/la/gmres.py on small dense systems made with numpy, and alone
against numpy. fgmres queues each iteration one ahead of the host's
read of the last one's flag, on the CPU too: the tests below hold the
discarded iteration to changing nothing.

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
from cfdtpu_torch.kernels.krylov import (Givens, cgs_plan, krylov_cgs,
                                         krylov_cgs_plain, krylov_lsq,
                                         krylov_lsq_plain, krylov_lsq_tri,
                                         krylov_lsq_tri_plain, tiny)
from cfdtpu_torch.la import gmres as tgmres
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


def _iters_unrestarted(jmv, jpc, b, rtol):
    """cfdtpu's iterations to rtol in one cycle (restart 60 > N)."""
    _, info = jax_fgmres(jmv, jnp.asarray(b), precond=jpc, restart=N,
                         maxiter=N, rtol=rtol)
    return int(info["iters"])


# restart, maxiter, rtol, zero rhs; "last of cycle" takes as restart the
# iterations that one cycle needs, so that it converges at j = m - 1
FGMRES_CASES = {
    "4": (4, 200, 1e-10, False),
    "30": (30, 200, 1e-10, False),
    "last_of_cycle": (None, 200, 1e-8, False),
    "maxiter": (4, 6, 1e-14, False),
    "zero_rhs": (30, 200, 1e-10, True),
}


@pytest.mark.parametrize("case", list(FGMRES_CASES))
def test_fgmres_matches_cfdtpu(case):
    """Equal iteration counts, convergence and x within 1e-10: with
    restarts (4) and without (30); converging at the cycle's last step
    (nothing queued past the restart length); cut by maxiter between two
    cycles (the second cycle runs to its end, as cfdtpu's inner loop
    tests only j < m and res > tol; nothing queued past maxiter); and a
    zero right-hand side (no iteration, x = x0 = 0)."""
    restart, maxiter, rtol, zero = FGMRES_CASES[case]
    A, dinv, b = _system(11)
    if zero:
        b = np.zeros(N)
    jmv, jpc, tmv, tpc = _both(A, dinv)
    if restart is None:
        restart = _iters_unrestarted(jmv, jpc, b, rtol)
    jx, jinfo = jax_fgmres(jmv, jnp.asarray(b), precond=jpc,
                           restart=restart, maxiter=maxiter, rtol=rtol)
    calls = [0]

    def counted(v):
        calls[0] += 1
        return tpc(v)

    tx, tinfo = fgmres(tmv, torch.as_tensor(b), precond=counted,
                       restart=restart, maxiter=maxiter, rtol=rtol)
    assert tinfo["iters"] == int(jinfo["iters"])
    assert tinfo["converged"] == bool(jinfo["converged"])
    assert calls[0] == tinfo["iters"] + tinfo["discarded"]
    _close(tx, jx, 1e-10)
    if case in ("last_of_cycle", "maxiter", "zero_rhs"):
        assert tinfo["discarded"] == 0
    if case == "last_of_cycle":
        assert tinfo["iters"] == restart and tinfo["converged"]
    if case == "maxiter":
        assert tinfo["iters"] == 8 and not tinfo["converged"]
    if case == "zero_rhs":
        assert tinfo["iters"] == 0
        assert torch.equal(tx, torch.zeros(N, dtype=torch.float64))


@pytest.mark.parametrize("restart", [5, 30])
def test_fgmres_discarded_iteration_changes_nothing(restart):
    """The iteration queued after the one that converged is discarded:
    its preconditioner call returning NaN changes neither x (bitwise)
    nor the iterations, and it is the only call past the used ones."""
    A, dinv, b = _system(11)
    _, _, tmv, tpc = _both(A, dinv)
    kw = dict(restart=restart, maxiter=200, rtol=1e-10)
    before = tgmres.DISCARDED.n
    x1, info1 = fgmres(tmv, torch.as_tensor(b), precond=tpc, **kw)
    assert info1["discarded"] == 1 and info1["converged"]
    assert tgmres.DISCARDED.n == before + 1
    calls = [0]

    def poisoned(v):
        calls[0] += 1
        out = tpc(v)
        return out * float("nan") if calls[0] > info1["iters"] else out

    x2, info2 = fgmres(tmv, torch.as_tensor(b), precond=poisoned, **kw)
    assert calls[0] == info1["iters"] + 1
    assert info2["iters"] == info1["iters"]
    assert info2["resnorm"] == info1["resnorm"]
    assert torch.equal(x1, x2)


def _arnoldi(m, seed, steps):
    """`steps` CGS2 steps with the Givens tail (the plain versions) on a
    random A: V, the unrotated H (m+1, m) and the Givens state."""
    rng = np.random.default_rng(seed)
    n = 40
    A = torch.as_tensor(rng.standard_normal((n, n)) + 2.0 * np.eye(n))
    r = torch.as_tensor(rng.standard_normal(n))
    V = torch.zeros((m + 1, n), dtype=torch.float64)
    H = torch.zeros((m + 1, m), dtype=torch.float64)
    hr = torch.zeros(1, dtype=torch.float64)
    G = Givens(m, 1e-300, "cpu")
    krylov_cgs(V, r, -1, hr, False, G)
    for j in range(steps):
        krylov_cgs(V, A @ V[j], j, H[:, j], True, G)
    return V, H, G, float(hr[0])


@pytest.mark.parametrize("steps", [1, 5, 12])
def test_givens_plain_against_numpy(steps):
    """The plain Givens tail after `steps` steps: R is the triangle of a
    QR factorisation of H (numpy's, its rows' signs aligned), |g[j+1]|
    the least-squares residual min ||beta e1 - H y|| (numpy lstsq), the
    rotations unitary, and the flags continue below m and stop at it."""
    m = 12
    V, H, G, beta = _arnoldi(m, steps, steps)
    k = steps
    Hk = H[: k + 1, :k].numpy()
    _, Rq = np.linalg.qr(Hk)
    Rq = np.sign(np.diag(Rq))[:, None] * Rq
    Rg = G.R[:k, :k].numpy().T
    np.testing.assert_allclose(Rg, Rq, rtol=0, atol=1e-12 * np.abs(Rq).max())
    assert np.allclose(np.tril(Rg, -1), 0.0, rtol=0, atol=0)
    e1 = np.zeros(k + 1)
    e1[0] = beta
    y = np.linalg.lstsq(Hk, e1, rcond=None)[0]
    res = np.linalg.norm(e1 - Hk @ y)
    assert abs(float(G.stat[k, 0]) - res) <= 1e-12 * beta
    assert abs(abs(float(G.g[k])) - res) <= 1e-12 * beta
    c, s = G.cs[:k].numpy(), G.sn[:k].numpy()
    np.testing.assert_allclose(c * c + s * s, 1.0, rtol=0, atol=1e-14)
    assert float(G.stat[0, 0]) == beta and float(G.stat[0, 1]) == 1.0
    assert float(G.stat[k, 1]) == (1.0 if k < m else 0.0)
    # the rotated column is R's, the unrotated one K9's h
    assert torch.equal(G.R[:k, k + 1:], torch.zeros(k, m - k))


def test_givens_plain_start_and_stop():
    """j = -1 starts the cycle (g = beta e1, stat row 0), and the flag
    stops at |g[j+1]| <= tol and at j + 1 = m."""
    G = Givens(3, 0.5, "cpu")
    G.g.fill_(7.0)
    V = torch.zeros((4, 6), dtype=torch.float64)
    hr = torch.zeros(1, dtype=torch.float64)
    krylov_cgs_plain(V, torch.full((6,), 0.1, dtype=torch.float64), -1, hr,
                     False, G)
    beta = float(hr[0])
    assert G.g.tolist() == [beta, 0.0, 0.0, 0.0]
    assert G.stat[0].tolist() == [beta, 0.0]  # beta = 0.245 <= tol
    G.tol.fill_(0.0)
    krylov_cgs_plain(V, torch.ones(6, dtype=torch.float64), -1, hr, False, G)
    assert G.stat[0].tolist() == [float(hr[0]), 1.0]
    h = torch.zeros(4, dtype=torch.float64)
    for j in range(3):
        krylov_cgs_plain(V, torch.arange(6.0, dtype=torch.float64) ** j, j,
                         h, True, G)
        assert float(G.stat[j + 1, 1]) == (1.0 if j + 1 < 3 else 0.0)


@pytest.mark.parametrize("j", [1, 5, 20])
def test_krylov_lsq_tri_plain_against_numpy(j):
    """The triangular mode: x + Z[:j]^T y with R[:j,:j] y = g[:j] (row k
    of R is column k of the triangle), numpy's solve, 1e-12."""
    rng = np.random.default_rng(j)
    m, n = 24, 30
    U = np.triu(rng.standard_normal((m, m))) + 4.0 * np.eye(m)
    R = np.zeros((m, m + 1))
    R[:, :m] = U.T
    g = rng.standard_normal(m + 1)
    Z, x = rng.standard_normal((m, n)), rng.standard_normal(n)
    y = np.linalg.solve(U[:j, :j], g[:j])
    args = [torch.as_tensor(a) for a in (R, g, Z, x)]
    kernels.reset_counts()
    got = krylov_lsq_tri(*args, j)
    _close(got, x + Z[:j].T @ y, 1e-12)
    assert torch.equal(got, krylov_lsq_tri_plain(*args, j))
    assert kernels.counts()["krylov_lsq"] == 0


def test_cgs_plan_resident_and_streamed():
    """The Gram-Schmidt step's host plan on a 132-multiprocessor card:
    one block a multiprocessor at most and at least 512 columns a block,
    a contiguous slice each; the FGMRES site (j = 19) and the S stage (70
    blocks) resident in shared memory, restart 60 in float32 too, in
    float64 streamed; a short vector one block."""
    n, sms = 106275, 132
    assert cgs_plan(n, 19, 4, sms) == (132, 806, 21 * 806 * 4)
    assert cgs_plan(35425, 4, 4, sms) == (70, 507, 6 * 507 * 4)
    assert cgs_plan(n, 59, 8, sms) == (132, 806, 0)
    assert cgs_plan(n, 59, 4, sms)[2] == 61 * 806 * 4
    assert cgs_plan(n, 62, 4, sms)[2] == 0
    assert cgs_plan(n, 4, 8, sms)[2] == 6 * 806 * 8
    assert cgs_plan(40, 3, 8, sms) == (1, 40, 5 * 40 * 8)
    for nn in (1, 255, 257, 35425, 106275, 10 ** 6):
        nb, cols, _ = cgs_plan(nn, 0, 4, sms)
        assert nb * cols >= nn > (nb - 1) * cols


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


@pytest.mark.parametrize("call", ["cgs", "lsq", "givens", "tri"])
def test_krylov_wrappers_refuse_bad_shapes(call):
    V = torch.zeros((4, 10), dtype=torch.float64)
    with pytest.raises(ValueError):
        if call == "cgs":
            krylov_cgs(V, torch.zeros(10, dtype=torch.float64), 3,
                       torch.zeros(5, dtype=torch.float64), False)
        elif call == "lsq":
            krylov_lsq(torch.zeros((4, 4), dtype=torch.float64),
                       torch.ones(1, dtype=torch.float64), V)
        elif call == "givens":  # a cycle state shorter than the step
            krylov_cgs(V, torch.zeros(10, dtype=torch.float64), 2,
                       torch.zeros(4, dtype=torch.float64), False,
                       Givens(2, 0.0, "cpu"))
        else:  # a triangle in float32
            krylov_lsq_tri(torch.eye(4, 5), torch.ones(5, dtype=torch.float64),
                           V, torch.zeros(10, dtype=torch.float64), 2)
