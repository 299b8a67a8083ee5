"""The preconditioner application's new kernel paths against cfdtpu (JAX):
K8 (the coarse-grid correction x + P xc), both AMG V-cycles at
n_smooth 1 (K1's input scale takes the first pre-smooth) and 2 in their
fused form (the correction read in the first post-smooth's K1 gather,
K1's prolong option; on BlockAMG's RAS level that launch also stores
it), the same cycles bit for bit against K8 then K1 on the CPU, and
K1's epilogue options at their solver sites: the
fieldsplit sub-blocks Auu and Aup, the SELFP Schur action S, the
near-true Schur action of the *_sup methods, r_p - Apu z_u and the
outer matvec. DFG 2D-1 at res_scale 1.0 (9,861 DOF), float64, on one
assembled Jacobian at a developed-looking state made with numpy; the
wrappers take their plain versions on the CPU.

Tolerances: K8 and the single operator applies sum the same products in
another order (1e-12 relative); the V-cycles chain a few dozen sums and
one dense coarsest inverse, and the near-true S one V-cycle (1e-11).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdtpu.la.amg import AMG as JaxAMG
from cfdtpu.la.amg import BlockAMG as JaxBlockAMG
from cfdtpu.la.schur import _sub_ops as jax_sub_ops
from cfdtpu.scenarios.dfg_1 import DFG1Benchmark as JaxDFG

from cfdtpu_torch import kernels
from cfdtpu_torch.kernels.amg_prolong import amg_prolong
from cfdtpu_torch.la import amg as amg_module
from cfdtpu_torch.la.amg import AMG, BlockAMG
from cfdtpu_torch.la.schur import _near_true_schur, _safe, _sub_ops
from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark as TorchDFG

torch.set_num_threads(1)

BENCH = dict(pc_inner_method="rasamg_sup", pc_inner_u=0, pc_inner_p=5,
             pc_ras_size=32, snes_lag_jacobian=True, pc_lag_steps=4,
             stats_every=1, ksp_restart=20)
RAS = (32, 4)


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
    kw = dict(dt=0.05, T=1.0, res_scale=1.0, dtype="float64", **BENCH)
    js = JaxDFG("stabilized_schur", **kw).solver
    ts = TorchDFG("stabilized_schur", device="cpu", **kw).solver
    n_u, n_p = ts.V.num_dofs, ts.Q.num_dofs
    y = ts.V.dof_coords[:, 1]
    rng = np.random.default_rng(606)
    prof = np.stack([1.2 * y * (0.41 - y) / 0.41 ** 2, 0 * y], axis=1)
    u = prof + 0.01 * rng.standard_normal((n_u, 2))
    up = prof + 0.01 * rng.standard_normal((n_u, 2))
    p = 0.01 * rng.standard_normal(n_p)
    mask = np.zeros(2 * n_u + n_p, dtype=bool)
    for d0 in range(2):
        mask[ts.bc_dofs_u.astype(np.int64) * 2 + d0] = True
    mask[2 * n_u + ts.bc_dofs_p.astype(np.int64)] = True
    jnb, tnb = js._nodebsr, ts._nodebsr
    jvals = jnb.assemble(*js.form.element_jacobians(
        jnp.asarray(u), jnp.asarray(p), (jnp.asarray(up),), js.params()))
    tvals = tnb.assemble(*ts.form.element_jacobians(T(u), T(p), (T(up),),
                                                    ts.params()))
    nuf = 2 * n_u
    tmask = T(mask)
    d_full = tnb.jacobian_diagonal(tvals, ())
    inv_d_u = 1.0 / _safe(torch.where(tmask[:nuf], 1.0, d_full[:nuf]))
    sp = tnb.sp_vals(tvals, torch.where(tmask[:nuf], 0.0, inv_d_u))
    # identity rows at the pressure-Dirichlet dofs (la/schur.py)
    mp = tmask[nuf:]
    sp = torch.where(mp[tnb._sp_row], 0.0, sp)
    sp[tnb._sp_diag_pos] = torch.where(mp, 1.0, sp[tnb._sp_diag_pos])
    uu = tnb.uu_vals(tvals, tmask[:nuf])
    return {"js": js, "ts": ts, "jnb": jnb, "tnb": tnb, "jvals": jvals,
            "tvals": tvals, "mask": mask, "inv_d_u": inv_d_u.numpy(),
            "sp": sp.numpy(), "uu": uu.numpy(), "rng": rng}


def _amg_pair(case, n_smooth):
    tnb = case["tnb"]
    sp_row, sp_col, _ = tnb.sp_structure()
    # coarse_size 40: more than one level on this graph (800 gives one)
    kw = dict(agg_row=tnb.block_row_np, agg_col=tnb.block_col_np,
              n_smooth=n_smooth, coarse_size=40)
    return (JaxAMG(sp_row, sp_col, tnb.n_nodes, **kw),
            AMG(sp_row, sp_col, tnb.n_nodes, device="cpu", **kw))


def _block_pair(case, n_smooth, ras):
    """coarse_size 40 gives this graph three levels, as 106k DOF has."""
    jnb, tnb = case["jnb"], case["tnb"]
    jb = JaxBlockAMG(np.asarray(jnb.block_row), np.asarray(jnb.block_col),
                     jnb.n_nodes, d=2, coarse_size=40, n_smooth=n_smooth,
                     fine_smoother=jnb.uu_ras(*RAS) if ras else None)
    tb = BlockAMG(tnb.block_row_np, tnb.block_col_np, tnb.n_nodes, d=2,
                  coarse_size=40, n_smooth=n_smooth, device="cpu",
                  fine_smoother=tnb.uu_ras(*RAS) if ras else None)
    return jb, tb


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("which", ["amg L0", "amg L1", "block L0",
                                   "block L1"])
def test_amg_prolong_matches_cfdtpu(case, which, scaled):
    """K8's plain version: base + xc[agg] against cfdtpu's
    AMGLevel.prolong / prolong_block plus the add (the base s * b, s =
    omega / d, against cfdtpu's omega * b / d)."""
    kind, lvl = which.split()
    k = int(lvl[1])
    if kind == "amg":
        jh, th = _amg_pair(case, 1)
        width = 1
    else:
        jh, th = _block_pair(case, 1, False)
        width = 2
    jl, tl = jh.levels[k], th.levels[k]
    rng = np.random.default_rng(31 + k)
    n = th.coo[k][2] * width
    xc = rng.standard_normal(tl.n_coarse * width)
    x = rng.standard_normal(n)
    d = 0.5 + rng.random(n)
    omega = th.omega
    jp = (jl.prolong(jnp.asarray(xc)) if width == 1
          else jl.prolong_block(jnp.asarray(xc), width))
    if scaled:
        ref = omega * jnp.asarray(x) / jnp.asarray(d) + jp
        got = amg_prolong(T(xc), tl.agg, width, T(x), T(omega / d))
    else:
        ref = jnp.asarray(x) + jp
        got = tl.prolong_add(T(xc), T(x), width=width)
    assert tl.agg.dtype == torch.int32
    assert_close(got, ref, 1e-12)


@pytest.mark.parametrize("n_smooth", [1, 2])
def test_selfp_amg_vcycle_matches_cfdtpu(case, n_smooth):
    jh, th = _amg_pair(case, n_smooth)
    jbuilt = jh.build(jnp.asarray(case["sp"]))
    tbuilt = th.build(T(case["sp"]))
    for (_, jd, _), (_, td, ts, _) in zip(jbuilt[0], tbuilt[0]):
        assert_close(td, jd, 1e-12)
        assert_close(ts, th.omega / np.asarray(jd), 1e-12)
    r = np.random.default_rng(41 + n_smooth).standard_normal(
        case["tnb"].n_nodes)
    kernels.reset_counts()
    got = th.v_cycle(tbuilt, T(r))
    assert_close(got, jh.v_cycle(jbuilt, jnp.asarray(r)), 1e-11)
    assert kernels.counts()["amg_prolong"] == 0  # CPU: plain versions


def _unfused_v_cycle(h, built, b, block):
    """The cycle as it ran before K1's prolong option: K8 (prolong_add)
    stores x + P xc, then the post-smooths read it."""
    level_vals, coarse_inv = built[0], built[1]
    ras_inv = built[2] if block else None
    w = h.d if block else 1
    mv = h._matvec

    def jacobi(k, vals, dg, x, b, **kw):
        return mv(k, vals, x, "jacobi", b, dg, **kw)

    def smooth(k, vals, dg, x, b, iters):
        for _ in range(iters):
            if k == 0 and ras_inv is not None:
                r = mv(k, vals, x, "residual", b)
                x = h.fine_smoother.apply(ras_inv, r, base=x)
            else:
                x = jacobi(k, vals, dg, x, b)
        return x

    def descend(k, b):
        if k == len(h.levels):
            return coarse_inv @ b
        vals, dg, s = level_vals[k][:3]
        lvl = h.levels[k]
        if k == 0 and ras_inv is not None:
            x = h.fine_smoother.apply(ras_inv, b)
            x = smooth(k, vals, dg, x, b, h.n_smooth - 1)
            scale = None
        elif h.n_smooth == 1:
            x, scale = b, s
        else:
            x = smooth(k, vals, dg, jacobi(k, vals, dg, b, b, scale=s), b,
                       h.n_smooth - 2)
            scale = None
        r = mv(k, vals, x, "residual", b, scale=scale)
        rc = lvl.restrict_block(r, w) if block else lvl.restrict(r)
        x = lvl.prolong_add(descend(k + 1, rc), x, width=w, scale=scale)
        return smooth(k, vals, dg, x, b, h.n_smooth)

    return descend(0, b)


@pytest.mark.parametrize("kind", ["amg", "block", "block + ras"])
@pytest.mark.parametrize("n_smooth", [1, 2])
def test_vcycle_fold_equals_k8_then_k1(case, kind, n_smooth, monkeypatch):
    """On the CPU the fused cycle is K8's plain version then K1's, as the
    cycle ran before the fold: bit for bit, and no K8 call left."""
    if kind == "amg":
        h = _amg_pair(case, n_smooth)[1]
        built = h.build(T(case["sp"]))
        n = case["tnb"].n_nodes
    else:
        h = _block_pair(case, n_smooth, kind == "block + ras")[1]
        built = h.build(T(case["uu"]))
        n = case["tnb"].n_u_flat
    r = T(np.random.default_rng(53 + n_smooth).standard_normal(n))
    calls = []
    k8 = amg_module.amg_prolong
    monkeypatch.setattr(amg_module, "amg_prolong",
                        lambda *a: calls.append(1) or k8(*a))
    got = h.v_cycle(built, r)
    assert not calls
    assert torch.equal(got, _unfused_v_cycle(h, built, r, kind != "amg"))
    assert len(calls) == len(h.levels) > 1


@pytest.mark.parametrize("ras", [False, True])
@pytest.mark.parametrize("n_smooth", [1, 2])
def test_block_amg_vcycle_matches_cfdtpu(case, n_smooth, ras):
    jh, th = _block_pair(case, n_smooth, ras)
    jbuilt = jh.build(jnp.asarray(case["uu"]))
    tbuilt = th.build(T(case["uu"]))
    r = np.random.default_rng(43 + n_smooth).standard_normal(
        case["tnb"].n_u_flat)
    assert_close(th.v_cycle(tbuilt, T(r)),
                 jh.v_cycle(jbuilt, jnp.asarray(r)), 1e-11)


def _ops(case, with_p_mask=True):
    ts, mask = case["ts"], case["mask"]
    nuf = case["tnb"].n_u_flat
    mp = mask[nuf:] if with_p_mask else None
    jops = jax_sub_ops(case["jnb"], case["jvals"], (),
                       jnp.asarray(mask[:nuf]),
                       None if mp is None else jnp.asarray(mp), False,
                       jnp.asarray(case["inv_d_u"]))
    tops = _sub_ops(case["tnb"], case["tvals"], T(mask[:nuf]),
                    None if mp is None else T(mp), False,
                    T(case["inv_d_u"]))
    assert ts.pin_pressure is False
    return dict(zip(("Auu", "Aup", "Apu", "App", "S"), jops)), dict(
        zip(("Auu", "Aup", "Apu", "App", "S"), tops))


@pytest.mark.parametrize("op", ["Auu", "Aup", "S", "S without p rows",
                                "r_p - Apu z_u", "outer matvec"])
def test_k1_options_match_cfdtpu(case, op):
    """Each site is one K1 call with its mask, scale or residual option,
    against cfdtpu's apply plus the elementwise ops around it."""
    tnb = case["tnb"]
    nuf, n_p = tnb.n_u_flat, tnb.n_nodes
    rng = np.random.default_rng(sum(map(ord, op)))
    vu, vp = rng.standard_normal(nuf), rng.standard_normal(n_p)
    jo, to = _ops(case, with_p_mask=op != "S without p rows")
    if op == "Auu":
        got, ref = to["Auu"](T(vu)), jo["Auu"](jnp.asarray(vu))
    elif op == "Aup":
        got, ref = to["Aup"](T(vp)), jo["Aup"](jnp.asarray(vp))
    elif op.startswith("S"):
        got, ref = to["S"](T(vp)), jo["S"](jnp.asarray(vp))
    elif op == "r_p - Apu z_u":
        got = to["Apu"](T(vu), mode="residual", b=T(vp))
        ref = jnp.asarray(vp) - jo["Apu"](jnp.asarray(vu))
    else:
        v = rng.standard_normal(nuf + n_p)
        mask = case["mask"]
        got = tnb.apply_element_matrices(case["tvals"], (), T(v),
                                         mask=T(mask), mask_value=T(v))
        ref = jnp.where(jnp.asarray(mask), jnp.asarray(v),
                        case["jnb"].apply_element_matrices(
                            case["jvals"], (), jnp.asarray(v)))
    assert_close(got, ref, 1e-12)


def test_near_true_schur_matches_cfdtpu(case):
    """App v - Apu where(bc_u, 0, V(Aup v)), p-Dirichlet rows v, with
    the rasamg_sup block V-cycle (cfdtpu/la/schur.py:287-300)."""
    jh, th = _block_pair(case, 1, True)
    jbuilt = jh.build(jnp.asarray(case["uu"]))
    tbuilt = th.build(T(case["uu"]))
    jo, to = _ops(case)
    nuf = case["tnb"].n_u_flat
    mask = case["mask"]
    S = _near_true_schur(th, tbuilt, to["Aup"], to["Apu"], to["App"],
                         T(mask[:nuf]), T(mask[nuf:]), False)
    vp = np.random.default_rng(47).standard_normal(case["tnb"].n_nodes)
    jv = jnp.asarray(vp)
    z = jh.v_cycle(jbuilt, jo["Aup"](jv), kcycle=False)
    z = jnp.where(jnp.asarray(mask[:nuf]), 0.0, z)
    ref = jnp.where(jnp.asarray(mask[nuf:]), jv, jo["App"](jv) - jo["Apu"](z))
    assert_close(S(T(vp)), ref, 1e-11)
