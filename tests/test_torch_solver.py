"""cfdtpu_torch linear algebra against cfdtpu (JAX) on the assembled
DFG 2D-1 Jacobian at res_scale 1.0, float64: element Jacobians, the
fixed-sweep and flexible GMRES, the SELFP-AMG V-cycle and the amg_p
Schur preconditioner.

Tolerances: both sides are float64 running the same algorithm; only
the order of floating-point sums differs (~1e-15 relative per
operation). The Jacobian is one jacfwd sweep (1e-11); the V-cycle
chains a few dozen sums (1e-11); the Krylov solves compound the
differences over their iterations (1e-10), and must take the same
number of iterations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdtpu.la.gmres import fgmres as jax_fgmres
from cfdtpu.la.gmres import gmres_fixed as jax_gmres_fixed
from cfdtpu.la.schur import (build_schur_state as jax_build_state,
                             make_schur_precond_from_state as jax_make_pc)
from cfdtpu.scenarios.dfg_1 import DFG1Benchmark as JaxDFG

from cfdtpu_torch.la.gmres import fgmres, gmres_fixed
from cfdtpu_torch.la.schur import (build_schur_state,
                                   make_schur_precond_from_state)
from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark as TorchDFG

torch.set_num_threads(1)

SLICE = dict(pc_inner_method="amg_p", pc_inner_u=6, pc_inner_p=10,
             snes_lag_jacobian=True, pc_lag_steps=4, stats_every=1,
             ksp_restart=20)


def assert_close(got, ref, rtol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-300)
    err = np.abs(got - ref).max()
    assert err <= rtol * scale, f"max err {err:.3e} vs scale {scale:.3e}"


def T(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def case():
    kw = dict(dt=0.05, T=1.0, res_scale=1.0, dtype="float64", **SLICE)
    js = JaxDFG("stabilized_schur", **kw).solver
    ts = TorchDFG("stabilized_schur", device="cpu", **kw).solver
    n_u, n_p = ts.V.num_dofs, ts.Q.num_dofs
    # a developed-looking state: the channel's inlet profile everywhere
    # plus a small seeded perturbation
    y = ts.V.dof_coords[:, 1]
    rng = np.random.default_rng(2024)
    prof = np.stack([1.2 * y * (0.41 - y) / 0.41 ** 2, 0 * y], axis=1)
    st = {
        "u": prof + 0.01 * rng.standard_normal((n_u, 2)),
        "up": prof + 0.01 * rng.standard_normal((n_u, 2)),
        "p": 0.01 * rng.standard_normal(n_p),
        "b": rng.standard_normal(2 * n_u + n_p),
    }
    mask = np.zeros(2 * n_u + n_p, dtype=bool)
    for d0 in range(2):
        mask[ts.bc_dofs_u.astype(np.int64) * 2 + d0] = True
    mask[2 * n_u + ts.bc_dofs_p.astype(np.int64)] = True

    jA = js.form.element_jacobians(jnp.asarray(st["u"]),
                                   jnp.asarray(st["p"]),
                                   (jnp.asarray(st["up"]),), js.params())
    tA = ts.form.element_jacobians(T(st["u"]), T(st["p"]), (T(st["up"]),),
                                   ts.params())
    jvals = js._nodebsr.assemble(*jA)
    tvals = ts._nodebsr.assemble(*tA)
    pc_kw = dict(m_u=6, m_p=10, full=True, inner_method="amg_p")
    nuf = 2 * n_u
    jstate = jax_build_state(js._nodebsr, jvals, (), jnp.asarray(mask[:nuf]),
                             False, bc_mask_p=jnp.asarray(mask[nuf:]),
                             **pc_kw)
    tstate = build_schur_state(ts._nodebsr, tvals, T(mask[:nuf]), False,
                               bc_mask_p=T(mask[nuf:]), **pc_kw)
    jpc = jax_make_pc(js._nodebsr, jstate, jnp.asarray(mask[:nuf]), False,
                      bc_mask_p=jnp.asarray(mask[nuf:]), **pc_kw)
    tpc = make_schur_precond_from_state(ts._nodebsr, tstate, T(mask[:nuf]),
                                        False, bc_mask_p=T(mask[nuf:]),
                                        **pc_kw)
    jm, tm = jnp.asarray(mask), T(mask)

    def jmatvec(v):
        y = js._nodebsr.apply_element_matrices(jvals, (), v)
        return jnp.where(jm, v, y)

    def tmatvec(v):
        y = ts._nodebsr.apply_element_matrices(tvals, (), v)
        return torch.where(tm, v, y)

    return {"js": js, "ts": ts, "st": st, "mask": mask, "jA": jA,
            "tA": tA, "jvals": jvals, "tvals": tvals, "jstate": jstate,
            "tstate": tstate, "jpc": jpc, "tpc": tpc, "jmatvec": jmatvec,
            "tmatvec": tmatvec}


def test_element_jacobians(case):
    """vmap(jacfwd) of the plain cell and facet kernels."""
    (jc, jb), (tc, tb) = case["jA"], case["tA"]
    assert_close(tc, jc, 1e-11)
    assert len(jb) == len(tb) == 1
    np.testing.assert_array_equal(np.asarray(jb[0][0]), tb[0][0].numpy())
    assert_close(tb[0][1], jb[0][1], 1e-11)


def test_selfp_amg_values(case):
    """Sp (K4 + K2) and its Galerkin level values, as built for the PC."""
    js_lv, jc = case["jstate"]["sp_built"]
    ts_lv, tc = case["tstate"]["sp_built"]
    assert len(js_lv) == len(ts_lv)
    for (jev, jd, _), (tev, td, *_) in zip(js_lv, ts_lv):
        assert_close(tev, jev, 1e-11)
        assert_close(td, jd, 1e-11)
    assert_close(tc, jc, 1e-10)


def test_amg_vcycle(case):
    ja = case["js"]._nodebsr.sp_amg()
    ta = case["ts"]._nodebsr.sp_amg()
    r = np.random.default_rng(5).standard_normal(case["ts"].Q.num_dofs)
    ref = ja.v_cycle(case["jstate"]["sp_built"], jnp.asarray(r))
    got = ta.v_cycle(case["tstate"]["sp_built"], T(r))
    assert_close(got, ref, 1e-11)


def test_schur_precond_apply(case):
    b = case["st"]["b"]
    ref = jax.jit(case["jpc"])(jnp.asarray(b))
    got = case["tpc"](T(b))
    assert_close(got, ref, 1e-10)


@pytest.mark.parametrize("reorth", [False, True])
def test_gmres_fixed(case, reorth):
    """The u-block sweep of the preconditioner: gmres_fixed on the
    BC-masked A_uu with node-block Jacobi, m = 6."""
    ts, js = case["ts"], case["js"]
    nuf = ts.form.n_u_flat
    mu = case["mask"][:nuf]
    r = case["st"]["b"][:nuf]

    def jAuu(v):
        y = js._nodebsr.apply_sub_block(case["jvals"], (), v, "uu")
        return jnp.where(jnp.asarray(mu), v, y)

    def tAuu(v):
        y = ts._nodebsr.apply_sub_block(case["tvals"], (), v, "uu")
        return torch.where(T(mu), v, y)

    jM = js._nodebsr.uu_block_jacobi(case["jvals"], jnp.asarray(mu))
    tM = ts._nodebsr.uu_block_jacobi(case["tvals"], T(mu))
    ref = jax.jit(lambda v: jax_gmres_fixed(jAuu, v, precond=jM, m=6,
                                            reorth=reorth))(jnp.asarray(r))
    got = gmres_fixed(tAuu, T(r), precond=tM, m=6, reorth=reorth)
    assert_close(got, ref, 1e-10)


@pytest.mark.parametrize("restart", [20, 5])
def test_fgmres_schur(case, restart):
    """The outer Krylov solve of a Newton step: flexible GMRES on the
    assembled Jacobian with the amg_p Schur preconditioner. restart=5
    exercises the restart cycles."""
    b = case["st"]["b"]
    ref_x, ref_info = jax.jit(
        lambda v: jax_fgmres(case["jmatvec"], v, precond=case["jpc"],
                             restart=restart, maxiter=200, rtol=1e-5)
    )(jnp.asarray(b))
    got_x, info = fgmres(case["tmatvec"], T(b), precond=case["tpc"],
                         restart=restart, maxiter=200, rtol=1e-5)
    assert bool(ref_info["converged"]) and info["converged"]
    assert info["iters"] == int(ref_info["iters"])
    assert_close(got_x, ref_x, 1e-10)
    np.testing.assert_allclose(info["resnorm"], float(ref_info["resnorm"]),
                               rtol=1e-8)


def test_pressure_nullspace_test_agrees(case):
    """The numeric constant-pressure nullspace test (run at setup when no
    pressure Dirichlet condition exists) gives cfdtpu's verdict on the
    same initial Jacobian."""
    assert (case["ts"]._test_pressure_nullspace()
            == case["js"]._test_pressure_nullspace())


@pytest.mark.parametrize("default", ["build_schur_state",
                                     "make_schur_precond_from_state"])
def test_inner_method_defaults_to_gmres(case, default):
    """Without inner_method each function takes cfdtpu's default,
    "gmres": the application equals cfdtpu's default one (1e-10) and,
    bit for bit, the port's with inner_method="gmres" given."""
    js, ts, mask = case["js"], case["ts"], case["mask"]
    nuf = ts.form.n_u_flat
    jmu, jmp = jnp.asarray(mask[:nuf]), jnp.asarray(mask[nuf:])
    tmu, tmp = T(mask[:nuf]), T(mask[nuf:])
    kw = dict(m_u=6, m_p=10, full=True)
    jstate = jax_build_state(js._nodebsr, case["jvals"], (), jmu, False,
                             bc_mask_p=jmp, **kw)
    jpc = jax_make_pc(js._nodebsr, jstate, jmu, False, bc_mask_p=jmp, **kw)
    given = dict(kw, inner_method="gmres")
    st_kw = kw if default == "build_schur_state" else given
    pc_kw = kw if default == "make_schur_precond_from_state" else given
    tstate = build_schur_state(ts._nodebsr, case["tvals"], tmu, False,
                               bc_mask_p=tmp, **st_kw)
    assert set(tstate) == set(jstate) - {"Ab"} == {"A", "d_u", "d_p"}
    tpc = make_schur_precond_from_state(ts._nodebsr, tstate, tmu, False,
                                        bc_mask_p=tmp, **pc_kw)
    ref_pc = make_schur_precond_from_state(
        ts._nodebsr, build_schur_state(ts._nodebsr, case["tvals"], tmu,
                                       False, bc_mask_p=tmp, **given),
        tmu, False, bc_mask_p=tmp, **given)
    b = case["st"]["b"]
    got = tpc(T(b))
    assert_close(got, jax.jit(jpc)(jnp.asarray(b)), 1e-10)
    assert torch.equal(got, ref_pc(T(b)))
