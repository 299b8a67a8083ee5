"""The non-AMG inner methods of the Schur preconditioner against cfdtpu
(JAX): the numeric state of gmres, chebyshev and chebyshev_p (d_p, the
Chebyshev bounds lambda_u and lambda_p, no SELFP AMG), their
preconditioner applications, make_schur_precond, and the solver's
choices around them (pc_inner_p's default of 30 without AMG, 10 with it;
the SELFP structure and hierarchy built for the AMG family only); and
ksp_ortho_chunk held to tests/test_gmres_ortho_chunk.py's behaviour.
DFG 2D-1 at res_scale 1.0 (9,861 DOF), float64, on one assembled
Jacobian at a developed-looking state made with numpy; the wrappers take
their plain versions on the CPU.

Tolerances: float64 on both sides running the same algorithm, the sums
in another order: the bounds (ten power steps) and the applications
(fixed GMRES sweeps, Chebyshev sweeps of up to 30 steps) 1e-11;
ortho_chunk's solves 1e-8, as cfdtpu's own test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdtpu.la.gmres import fgmres as jax_fgmres
from cfdtpu.la.schur import (build_schur_state as jax_build_state,
                             make_schur_precond as jax_make_schur_precond,
                             make_schur_precond_from_state as jax_make_pc)
from cfdtpu.scenarios.dfg_1 import DFG1Benchmark as JaxDFG

from cfdtpu_torch.la.gmres import fgmres
from cfdtpu_torch.la.schur import (build_schur_state, make_schur_precond,
                                   make_schur_precond_from_state)
from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark as TorchDFG

torch.set_num_threads(1)

METHODS = ("gmres", "chebyshev", "chebyshev_p")


def T(a):
    return torch.as_tensor(np.array(a))


def assert_close(got, ref, rtol):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    scale = max(np.abs(ref).max(), 1e-300)
    assert err <= rtol * scale, f"max err {err:.3e} vs scale {scale:.3e}"


@pytest.fixture(scope="module")
def case():
    kw = dict(dt=0.05, T=1.0, res_scale=1.0, dtype="float64",
              pc_inner_method="gmres", stats_every=1)
    js = JaxDFG("stabilized_schur", **kw).solver
    ts = TorchDFG("stabilized_schur", device="cpu", **kw).solver
    n_u, n_p = ts.V.num_dofs, ts.Q.num_dofs
    y = ts.V.dof_coords[:, 1]
    rng = np.random.default_rng(77)
    prof = np.stack([1.2 * y * (0.41 - y) / 0.41 ** 2, 0 * y], axis=1)
    u = prof + 0.01 * rng.standard_normal((n_u, 2))
    up = prof + 0.01 * rng.standard_normal((n_u, 2))
    p = 0.01 * rng.standard_normal(n_p)
    mask = np.zeros(2 * n_u + n_p, dtype=bool)
    for d0 in range(2):
        mask[ts.bc_dofs_u.astype(np.int64) * 2 + d0] = True
    mask[2 * n_u + ts.bc_dofs_p.astype(np.int64)] = True
    jvals = js._nodebsr.assemble(*js.form.element_jacobians(
        jnp.asarray(u), jnp.asarray(p), (jnp.asarray(up),), js.params()))
    tvals = ts._nodebsr.assemble(*ts.form.element_jacobians(
        T(u), T(p), (T(up),), ts.params()))
    return {"js": js, "ts": ts, "mask": mask, "jvals": jvals,
            "tvals": tvals, "b": rng.standard_normal(2 * n_u + n_p)}


def _pair(case, method, m_u=6, m_p=30):
    js, ts, mask = case["js"], case["ts"], case["mask"]
    nuf = ts.form.n_u_flat
    kw = dict(m_u=m_u, m_p=m_p, full=True, inner_method=method)
    jmu, jmp = jnp.asarray(mask[:nuf]), jnp.asarray(mask[nuf:])
    tmu, tmp = T(mask[:nuf]), T(mask[nuf:])
    jstate = jax_build_state(js._nodebsr, case["jvals"], (), jmu, False,
                             bc_mask_p=jmp, **kw)
    tstate = build_schur_state(ts._nodebsr, case["tvals"], tmu, False,
                               bc_mask_p=tmp, **kw)
    jpc = jax_make_pc(js._nodebsr, jstate, jmu, False, bc_mask_p=jmp, **kw)
    tpc = make_schur_precond_from_state(ts._nodebsr, tstate, tmu, False,
                                        bc_mask_p=tmp, **kw)
    return jstate, tstate, jpc, tpc


@pytest.mark.parametrize("method", METHODS)
def test_state_matches_cfdtpu(case, method):
    """The same keys (no SELFP AMG outside the AMG family), d_u, d_p and
    the Chebyshev bounds, (1,) tensors (1e-11)."""
    jstate, tstate, _, _ = _pair(case, method)
    assert set(tstate) == set(jstate) - {"Ab"}
    assert "sp_built" not in tstate
    assert_close(tstate["d_u"], jstate["d_u"], 1e-15)
    assert_close(tstate["d_p"], jstate["d_p"], 1e-15)
    for key in ("lam_u", "lam_p"):
        assert (key in tstate) == (key in jstate)
        if key in tstate:
            assert tstate[key].shape == (1,)
            assert_close(tstate[key], np.reshape(np.asarray(jstate[key]),
                                                 (1,)), 1e-11)


@pytest.mark.parametrize("m_u,m_p", [(6, 30), (3, 5)])
@pytest.mark.parametrize("method", METHODS)
def test_precond_apply_matches_cfdtpu(case, method, m_u, m_p):
    _, _, jpc, tpc = _pair(case, method, m_u, m_p)
    b = case["b"]
    assert_close(tpc(T(b)), jax.jit(jpc)(jnp.asarray(b)), 1e-11)


@pytest.mark.parametrize("method", ["gmres", "chebyshev"])
def test_make_schur_precond_matches_cfdtpu(case, method):
    """make_schur_precond: state and closure in one call (1e-11)."""
    js, ts, mask = case["js"], case["ts"], case["mask"]
    nuf = ts.form.n_u_flat
    kw = dict(m_u=6, m_p=10, full=False, inner_method=method)
    jpc = jax_make_schur_precond(js._nodebsr, case["jvals"], (),
                                 jnp.asarray(mask[:nuf]), False,
                                 bc_mask_p=jnp.asarray(mask[nuf:]), **kw)
    tpc = make_schur_precond(ts._nodebsr, case["tvals"], T(mask[:nuf]),
                             False, bc_mask_p=T(mask[nuf:]), **kw)
    b = case["b"]
    assert_close(tpc(T(b)), jax.jit(jpc)(jnp.asarray(b)), 1e-11)


@pytest.mark.parametrize("method,m_p,sp", [("gmres", 30, False),
                                           ("chebyshev_p", 30, False),
                                           ("amg_p", 10, True)])
def test_solver_pc_choices(method, m_p, sp):
    """pc_inner_p's default (cfdtpu/solvers/stabilized_schur.py:407-422:
    10 with AMG, 30 without) and the SELFP structure and hierarchy only
    where an AMG method needs them (:359-367)."""
    kw = dict(dt=0.05, T=0.05, res_scale=2.5, dtype="float64",
              pc_inner_method=method)
    ts = TorchDFG("stabilized_schur", device="cpu", **kw).solver
    assert ts._pc_kw["m_p"] == m_p
    nb = ts._nodebsr
    assert (nb._sp is not None) == (nb._sp_amg_h is not None) == sp


def _system(n=120, seed=0):
    rng = np.random.RandomState(seed)
    A = np.eye(n) * 4.0 + 0.5 * rng.randn(n, n) / np.sqrt(n)
    return A, rng.randn(n)


@pytest.mark.parametrize("chunk,n,seed,restart,rtol", [
    (4, 120, 0, 30, 1e-10), (8, 120, 0, 30, 1e-10), (64, 120, 0, 30, 1e-10),
    (512, 120, 3, 10, 1e-10), (4, 200, 7, 8, 1e-8)])
def test_ortho_chunk_matches_cfdtpu(chunk, n, seed, restart, rtol):
    """ksp_ortho_chunk: the port's fgmres (K9 sweeps the active rows, so
    it has no such option) gives cfdtpu's chunked solve's iterations, x
    within 1e-8 and a true residual within rtol
    (tests/test_gmres_ortho_chunk.py)."""
    A, b = _system(n, seed)
    x, info = fgmres(lambda v: T(A) @ v, T(b), restart=restart, rtol=rtol)
    jx, jinfo = jax_fgmres(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                           restart=restart, rtol=rtol, ortho_chunk=chunk)
    assert info["converged"] and info["iters"] == int(jinfo["iters"])
    assert np.allclose(x.numpy(), np.asarray(jx), atol=1e-8)
    r = b - A @ x.numpy()
    assert np.linalg.norm(r) <= 10 * rtol * np.linalg.norm(b)
