"""The rasamg_sup preconditioner's parts against cfdtpu (JAX): the RAS
window maps, build and apply (la/ras.py), the velocity block AMG
(la/amg.py BlockAMG, block transfers, V-cycle with and without the RAS
fine smoother), NodeBSR.uu_vals, and the Schur preconditioner apply for
each of the six AMG-family inner methods. DFG 2D-1 at res_scale 1.0
(9,861 DOF), float64, on one assembled Jacobian at a developed-looking
state made with numpy.

Tolerances: the static maps are the same numpy code on the same inputs,
so they must be equal. The values are float64 on both sides running the
same algorithm; only the order of the sums differs (~1e-15 relative per
operation). RAS build inverts 80x80 blocks (LAPACK in both, 1e-12 of the
largest entry); the V-cycles chain a few dozen sums and one dense
coarsest inverse (1e-11); the preconditioner applies chain V-cycles and
fixed GMRES sweeps (1e-10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdtpu.la.amg import BlockAMG as JaxBlockAMG
from cfdtpu.la.schur import (build_schur_state as jax_build_state,
                             make_schur_precond_from_state as jax_make_pc)
from cfdtpu.scenarios.dfg_1 import DFG1Benchmark as JaxDFG

from cfdtpu_torch.la.amg import BlockAMG
from cfdtpu_torch.la.schur import (SUPPORTED_INNER, build_schur_state,
                                   make_schur_precond_from_state)
from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark as TorchDFG

torch.set_num_threads(1)

# the configuration bench.py runs (bench.py:64-74)
BENCH = dict(pc_inner_method="rasamg_sup", pc_inner_u=0, pc_inner_p=5,
             pc_ras_size=32, snes_lag_jacobian=True, pc_lag_steps=4,
             stats_every=1, ksp_restart=20)
RAS = (32, 4)


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
    kw = dict(dt=0.05, T=1.0, res_scale=1.0, dtype="float64", **BENCH)
    js = JaxDFG("stabilized_schur", **kw).solver
    ts = TorchDFG("stabilized_schur", device="cpu", **kw).solver
    n_u, n_p = ts.V.num_dofs, ts.Q.num_dofs
    y = ts.V.dof_coords[:, 1]
    rng = np.random.default_rng(2025)
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
    nuf = 2 * n_u
    juu = js._nodebsr.uu_vals(jvals, jnp.asarray(mask[:nuf]))
    tuu = ts._nodebsr.uu_vals(tvals, T(mask[:nuf]))
    return {"js": js, "ts": ts, "st": st, "mask": mask, "jvals": jvals,
            "tvals": tvals, "juu": juu, "tuu": tuu}


# -- static maps ----------------------------------------------------------
@pytest.mark.parametrize("s,o", [RAS, (16, 4)])
def test_ras_maps_identical(case, s, o):
    jr = case["js"]._nodebsr.uu_ras(s, o)
    tr = case["ts"]._nodebsr.uu_ras(s, o)
    assert (jr.n_sub, jr.m, jr._n_cand) == (tr.n_sub, tr.m, tr._n_cand)
    np.testing.assert_array_equal(np.asarray(jr._pos), tr._pos)
    np.testing.assert_array_equal(np.asarray(jr._win), tr._win.numpy())
    np.testing.assert_array_equal(np.asarray(jr._eye_add),
                                  tr._eye_add.numpy())


def test_block_amg_maps_identical(case):
    """Aggregates, coarse graphs, per-level supernode columns and block
    positions of the velocity hierarchy the bench's solver builds."""
    ja = case["js"]._nodebsr.uu_amg(fine_smoother=case["js"]._nodebsr
                                    .uu_ras(*RAS))
    ta = case["ts"]._nodebsr.uu_amg(fine_smoother=case["ts"]._nodebsr
                                    .uu_ras(*RAS))
    assert len(ja.levels) == len(ta.levels) >= 1
    assert ja.n_coarsest == ta.n_coarsest <= 400
    for jl, tl in zip(ja.levels, ta.levels):
        np.testing.assert_array_equal(np.asarray(jl.agg), tl.agg.numpy())
        for x, y in zip(jl.coarse_coo, tl.coarse_coo):
            np.testing.assert_array_equal(np.asarray(x), y)
    for k, ((jm, _), (tm, _)) in enumerate(zip(ja.sup, ta.sup)):
        np.testing.assert_array_equal(np.asarray(jm.sup_cols),
                                      tm.sup_cols.numpy())
        if k < len(ta.levels):
            np.testing.assert_array_equal(
                np.asarray(ja._bpos[k]).reshape(-1), ta._bpos[k].numpy())


def test_block_positions_uniform_identical(case):
    from cfdtpu.la.superell import SuperMaps as JMaps

    from cfdtpu_torch.la.superell import SuperMaps as TMaps

    tb = case["ts"]._nodebsr
    row = tb.block_row_np.astype(np.int64)
    col = tb.block_col_np.astype(np.int64)
    for g in (4, 8):
        jm, tm = JMaps(row, col, tb.n_nodes, g), TMaps(row, col, tb.n_nodes, g)
        np.testing.assert_array_equal(jm.block_positions_uniform(row, col, 2),
                                      tm.block_positions_uniform(row, col, 2))


# -- values -----------------------------------------------------------------
def test_uu_vals(case):
    assert_close(case["tuu"], case["juu"], 1e-12)


def test_ras_build_and_apply(case):
    jr = case["js"]._nodebsr.uu_ras(*RAS)
    tr = case["ts"]._nodebsr.uu_ras(*RAS)
    jinv = jr.build(case["juu"])
    tinv = tr.build(case["tuu"])
    assert torch.isfinite(tinv).all()
    assert_close(tinv, jinv, 1e-12)
    x = np.random.default_rng(8).standard_normal(case["ts"].form.n_u_flat)
    ref = jr.apply(jinv, jnp.asarray(x))
    assert_close(tr.apply(tinv, T(x)), ref, 1e-12)
    # the smoother's fused x + RAS(r)
    base = np.random.default_rng(9).standard_normal(x.shape)
    assert_close(tr.apply(tinv, T(x), base=T(base)), base + ref, 1e-12)


@pytest.fixture(scope="module")
def block_amgs(case):
    """BlockAMG with and without the RAS fine smoother, built on the
    masked velocity blocks in both packages. coarse_size 40 (not 400)
    gives this 3,287-node graph three levels, as 106k DOF has."""
    jb, tb = case["js"]._nodebsr, case["ts"]._nodebsr
    out = {}
    for name, use_ras in (("plain", False), ("ras", True)):
        jh = JaxBlockAMG(np.asarray(jb.block_row), np.asarray(jb.block_col),
                         jb.n_nodes, d=2, coarse_size=40,
                         fine_smoother=jb.uu_ras(*RAS) if use_ras else None)
        th = BlockAMG(tb.block_row_np, tb.block_col_np, tb.n_nodes, d=2,
                      coarse_size=40,
                      fine_smoother=tb.uu_ras(*RAS) if use_ras else None)
        assert len(th.levels) == len(jh.levels) >= 3
        out[name] = (jh, jh.build(case["juu"]), th, th.build(case["tuu"]))
    return out


@pytest.mark.parametrize("smoother", ["plain", "ras"])
def test_block_amg_build(block_amgs, smoother):
    _, (jlv, jci, jras), _, (tlv, tci, tras) = block_amgs[smoother]
    assert len(jlv) == len(tlv)
    for (jev, jd, _), (tev, td) in zip(jlv, tlv):
        assert_close(tev, jev, 1e-11)
        assert_close(td, jd, 1e-11)
    assert_close(tci, jci, 1e-11)
    assert (tras is None) == (smoother == "plain")
    if tras is not None:
        assert_close(tras, jras, 1e-12)


@pytest.mark.parametrize("smoother", ["plain", "ras"])
def test_block_amg_vcycle(case, block_amgs, smoother):
    jh, jbuilt, th, tbuilt = block_amgs[smoother]
    r = np.random.default_rng(13).standard_normal(case["ts"].form.n_u_flat)
    ref = jh.v_cycle(jbuilt, jnp.asarray(r))
    assert_close(th.v_cycle(tbuilt, T(r)), ref, 1e-11)
    assert_close(th.v_cycle(tbuilt, T(r), kcycle=False), ref, 1e-11)


@pytest.mark.parametrize("level", [0, 1])
def test_block_transfers(case, block_amgs, level):
    """restrict_block / prolong_block / coarsen_block_vals (K2 widths d
    and d*d, a gather) vs cfdtpu's segment sums."""
    jh, _, th, _ = block_amgs["plain"]
    jl, tl = jh.levels[level], th.levels[level]
    rng = np.random.default_rng(17 + level)
    n = th.coo[level][2]
    r = rng.standard_normal(2 * n)
    xc = rng.standard_normal(2 * tl.n_coarse)
    v = rng.standard_normal((len(th.coo[level][0]), 2, 2))
    assert_close(tl.restrict_block(T(r), 2), jl.restrict_block(
        jnp.asarray(r), 2), 1e-12)
    assert_close(tl.prolong_block(T(xc), 2), jl.prolong_block(
        jnp.asarray(xc), 2), 0)
    assert_close(tl.coarsen_block_vals(T(v)), jl.coarsen_block_vals(
        jnp.asarray(v)), 1e-12)


def test_unported_cycles_raise(block_amgs):
    _, _, th, tbuilt = block_amgs["ras"]
    with pytest.raises(NotImplementedError):
        th.v_cycle(tbuilt, torch.zeros(2 * th.coo[0][2],
                                       dtype=torch.float64), kcycle=True)
    for kw in ({"kcycle": True}, {"cheby": 2}, {"wcycle": True}):
        with pytest.raises(NotImplementedError):
            th.set_cycle(**kw)


# -- the Schur preconditioner -------------------------------------------------
METHODS = [(m, 3) for m in SUPPORTED_INNER] + [("rasamg_sup", 0)]


@pytest.mark.parametrize("method,m_u", METHODS,
                         ids=[f"{m}-mu{u}" for m, u in METHODS])
def test_schur_precond_apply(case, method, m_u):
    js, ts, mask = case["js"], case["ts"], case["mask"]
    nuf = ts.form.n_u_flat
    pc_kw = dict(m_u=m_u, m_p=5, full=True, inner_method=method,
                 ras_opts=RAS)
    jmu, jmp = jnp.asarray(mask[:nuf]), jnp.asarray(mask[nuf:])
    jstate = jax_build_state(js._nodebsr, case["jvals"], (), jmu, False,
                             bc_mask_p=jmp, **pc_kw)
    jpc = jax_make_pc(js._nodebsr, jstate, jmu, False, bc_mask_p=jmp,
                      **pc_kw)
    tstate = build_schur_state(ts._nodebsr, case["tvals"], T(mask[:nuf]),
                               False, bc_mask_p=T(mask[nuf:]), **pc_kw)
    tpc = make_schur_precond_from_state(ts._nodebsr, tstate, T(mask[:nuf]),
                                        False, bc_mask_p=T(mask[nuf:]),
                                        **pc_kw)
    assert set(tstate) == set(jstate) - {"Ab", "d_p"}
    b = case["st"]["b"]
    ref = jax.jit(jpc)(jnp.asarray(b))
    assert_close(tpc(T(b)), ref, 1e-10)
