"""cfdtpu_torch kernels: each plain PyTorch version (what a CPU tensor
runs) against its cfdtpu (JAX) counterpart on the DFG 2D-1 mesh at
res_scale 1.0, float64, from one random state made with numpy.

K1 sup_spmv      NodeBSR applies (full, uu/up/pu/pp, p-coupled) and the
                 AMG level matvec with its residual / l1-Jacobi epilogues
K2 ell_sum       every SortedScatter of the slice
K3 cell residual the element residuals and the full residual
K4 selfp_triple  NodeBSR.sp_vals

Tolerance: both sides are float64 and run the same algorithm; only the
order of the floating-point sums differs (einsum / segment sums vs
torch's reductions), so results agree to ~1e-15 relative. The checks
use 1e-12 relative to the largest magnitude of the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdtpu.scenarios.dfg_1 import DFG1Benchmark as JaxDFG

from cfdtpu_torch import kernels
from cfdtpu_torch.kernels.ell_sum import ell_sum_plain
from cfdtpu_torch.kernels.ns_cell_residual import ns_cell_residual_plain
from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark as TorchDFG

torch.set_num_threads(1)

RTOL = 1e-12
SLICE = dict(pc_inner_method="amg_p", pc_inner_u=6, pc_inner_p=10,
             snes_lag_jacobian=True, pc_lag_steps=4, stats_every=1,
             ksp_restart=20)


def assert_close(got, ref, rtol=RTOL):
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
    rng = np.random.default_rng(1234)
    n_u, n_p = ts.V.num_dofs, ts.Q.num_dofs
    st = {
        "u": 0.3 * rng.standard_normal((n_u, 2)),
        "up": 0.3 * rng.standard_normal((n_u, 2)),
        "p": rng.standard_normal(n_p),
        "v": rng.standard_normal(n_u * 2 + n_p),
        "b": rng.standard_normal(n_u * 2 + n_p),
    }
    jprm = js.params()
    A_cells, A_blocks = js.form.element_jacobians(
        jnp.asarray(st["u"]), jnp.asarray(st["p"]),
        (jnp.asarray(st["up"]),), jprm)
    jvals = js._nodebsr.assemble(A_cells, A_blocks)
    tvals = {k: T(v) for k, v in jvals.items()}  # JAX values, as tensors
    kernels.reset_counts()
    return {"js": js, "ts": ts, "st": st, "jvals": jvals, "tvals": tvals}


def test_cell_residual_elements(case):
    """K3's plain version against cfdtpu's vmapped cell kernel."""
    js, ts, st = case["js"], case["ts"], case["st"]
    jf, tf = js.form, ts.form
    dm = np.asarray(jf.dofmap_u)
    ru_j, rp_j = jax.vmap(jf._kernel, in_axes=(0, 0, 0, 0, 0, None))(
        jnp.asarray(st["u"])[dm], jnp.asarray(st["p"])[dm],
        (jnp.asarray(st["up"])[dm],), jf.cell_coords, jf.cell_h,
        js.params())
    prm = ts.params()
    ru_t, rp_t = ns_cell_residual_plain(
        T(st["u"]), T(st["up"]), T(st["p"]), tf.dofmap_u, tf.dofmap_p,
        tf.cell_coords, tf.cell_h, tf.tabs, prm["rho"], prm["mu"],
        prm["dt"], prm["f"], tf.eps)
    assert_close(ru_t, ru_j)
    assert_close(rp_t, rp_j)


def test_full_residual(case):
    """K3 + K2 + the natural-correction facet block: form.residual."""
    js, ts, st = case["js"], case["ts"], case["st"]
    ru_j, rp_j = js.form.residual(
        jnp.asarray(st["u"]), jnp.asarray(st["p"]),
        (jnp.asarray(st["up"]),), js.params())
    ru_t, rp_t = ts.form.residual(T(st["u"]), T(st["p"]), (T(st["up"]),),
                                  ts.params())
    assert_close(ru_t, ru_j)
    assert_close(rp_t, rp_j)


def test_assembly(case):
    """Element blocks -> node blocks (K2) -> supernode placement."""
    ts, st = case["ts"], case["st"]
    A_cells, A_blocks = ts.form.element_jacobians(
        T(st["u"]), T(st["p"]), (T(st["up"]),), ts.params())
    vals = ts._nodebsr.assemble(A_cells, A_blocks)
    for key in ("coo", "sup"):
        assert_close(vals[key], case["jvals"][key])


@pytest.mark.parametrize("which", ["uu", "up", "pu", "pp"])
def test_sup_spmv_sub_blocks(case, which):
    """K1 on the strided sub-block views vs NodeBSR.apply_sub_block."""
    js, ts, st = case["js"], case["ts"], case["st"]
    n_uf = ts.form.n_u_flat
    v = st["v"][:n_uf] if which[1] == "u" else st["v"][n_uf:]
    ref = js._nodebsr.apply_sub_block(case["jvals"], (), jnp.asarray(v),
                                      which)
    got = ts._nodebsr.apply_sub_block(case["tvals"], (), T(v), which)
    assert_close(got, ref)


def test_sup_spmv_full_and_p_coupled(case):
    js, ts, st = case["js"], case["ts"], case["st"]
    jb, tb = js._nodebsr, ts._nodebsr
    ref = jb.apply_element_matrices(case["jvals"], (), jnp.asarray(st["v"]))
    got = tb.apply_element_matrices(case["tvals"], (), T(st["v"]))
    assert_close(got, ref)
    vp = st["v"][ts.form.n_u_flat:]
    for g, r in zip(tb.apply_p_coupled(case["tvals"], T(vp)),
                    jb.apply_p_coupled(case["jvals"], jnp.asarray(vp))):
        assert_close(g, r)


@pytest.mark.parametrize("level", [0, 1])
def test_sup_spmv_amg_matvec_and_epilogues(case, level):
    """AMG level matvec (K1 at g=8) vs AMG._matvec, and the fused
    epilogues vs their composition: residual b - A x, l1-Jacobi update
    x + omega (b - A x) / d."""
    js, ts = case["js"], case["ts"]
    ja, ta = js._nodebsr.sp_amg(), ts._nodebsr.sp_amg()
    sp = js._nodebsr.sp_vals(case["jvals"])
    for k in range(level):
        sp = ja.levels[k].coarsen_vals(sp)
    m = ta.coo[level][2]
    rng = np.random.default_rng(7 + level)
    x, b = rng.standard_normal(m), rng.standard_normal(m)
    d = 1.0 + rng.random(m)
    jsup = ja._place(level, sp)
    tsup = ta._place(level, T(sp))
    assert_close(tsup, jsup)
    ax = ja._matvec(level, jsup, jnp.asarray(x))
    assert_close(ta._matvec(level, tsup, T(x)), ax)
    assert_close(ta._matvec(level, tsup, T(x), mode="residual", b=T(b)),
                 jnp.asarray(b) - ax)
    assert_close(
        ta._matvec(level, tsup, T(x), mode="jacobi", b=T(b), d=T(d)),
        jnp.asarray(x) + ja.omega * (jnp.asarray(b) - ax) / jnp.asarray(d))


def _scatters(js, ts):
    jb, tb = js._nodebsr, ts._nodebsr
    ja, ta = jb.sp_amg(), tb.sp_amg()
    return {
        "residual_u": (js.form._scatter_u, ts.form._scatter_u, 2),
        "residual_p": (js.form._scatter_p, ts.form._scatter_p, 0),
        "assembly": (jb._assemble_scatter, tb._assemble_scatter, 9),
        "selfp": (jb._sp_scatter, tb._sp_scatter, 0),
        "amg_restrict": (None, ta.levels[0]._restrict, 0),
        "amg_coarsen": (None, ta.levels[0]._coarsen, 0),
    }, ja


@pytest.mark.parametrize("name", ["residual_u", "residual_p", "assembly",
                                  "selfp", "amg_restrict", "amg_coarsen"])
def test_ell_sum_scatters(case, name):
    """K2's plain version vs cfdtpu's SortedScatter / AMG segment sums."""
    scat, ja = _scatters(case["js"], case["ts"])
    jsc, tsc, width = scat[name]
    rng = np.random.default_rng(11)
    shape = (tsc.n_in,) + ((width,) if width else ())
    vals = rng.standard_normal(shape)
    got = ell_sum_plain(T(vals), tsc.row_ptr, tsc.pos, tsc.K)
    if name == "amg_restrict":
        ref = ja.levels[0].restrict(jnp.asarray(vals))
    elif name == "amg_coarsen":
        ref = ja.levels[0].coarsen_vals(jnp.asarray(vals))
    else:
        ref = jsc(jnp.asarray(vals))
    assert_close(got, ref)
    assert_close(tsc(T(vals)), ref)


@pytest.mark.parametrize("with_inv", [False, True])
def test_selfp_triple_sp_vals(case, with_inv):
    """K4 (+ K2 + the App add) vs NodeBSR.sp_vals."""
    js, ts = case["js"], case["ts"]
    inv = None
    if with_inv:
        rng = np.random.default_rng(3)
        inv = rng.standard_normal(ts.form.n_u_flat)
    ref = js._nodebsr.sp_vals(case["jvals"],
                              None if inv is None else jnp.asarray(inv))
    got = ts._nodebsr.sp_vals(case["tvals"], None if inv is None else T(inv))
    assert_close(got, ref)


def test_cpu_tensors_launch_no_kernel(case):
    """Everything above ran on CPU tensors: no launch was counted."""
    ts, st = case["ts"], case["st"]
    ts.form.residual(T(st["u"]), T(st["p"]), (T(st["up"]),), ts.params())
    ts._nodebsr.apply_element_matrices(case["tvals"], (), T(st["v"]))
    assert kernels.counts() == {name: 0 for name in kernels.COUNTERS}


def test_cell_kernel_rejects_non_p1_on_cuda_path():
    """The CUDA kernel covers P1 only: a CellTabs that is not P1 reports
    so (the wrapper raises on CUDA tensors for it, never falls back)."""
    from cfdtpu_torch.elements import LagrangeElement, quadrature
    from cfdtpu_torch.kernels.ns_cell_residual import CellTabs

    xi, w = quadrature("triangle", 5)
    el = LagrangeElement.create("triangle", 2)
    phi, dphi, d2phi = el.tabulate(xi, nderiv=2)
    tabs = CellTabs.create(w, phi, dphi, d2phi, phi, dphi, dphi, True,
                           "cpu", torch.float64)
    assert not tabs.p1


def test_superell_sup_matvec_and_place_scalar(case):
    """la/superell.py: place_scalar (plain unique-index placement) and
    sup_matvec (K1) on the SELFP graph's g=8 maps vs cfdtpu's."""
    from cfdtpu.la import superell as jsup

    from cfdtpu_torch.la import superell as tsup

    js, ts = case["js"], case["ts"]
    ja, ta = js._nodebsr.sp_amg(), ts._nodebsr.sp_amg()
    (jmaps, _), (tmaps, _) = ja.sup[0], ta.sup[0]
    row, col, m = ta.coo[0]
    sp = js._nodebsr.sp_vals(case["jvals"])
    jv = jsup.place_scalar(jmaps, row, col, sp)
    tv = tsup.place_scalar(tmaps, row, col, T(sp))
    assert_close(tv, jv)
    x = np.random.default_rng(21).standard_normal(m)
    assert_close(tsup.sup_matvec(tmaps, tv, T(x)),
                 jsup.sup_matvec(jmaps, jv, jnp.asarray(x)))


@pytest.mark.parametrize("which", ["full", "uu", "up", "pu", "pp", "diag"])
def test_form_element_block_operator(case, which):
    """StabilizedNSForm's element-block operator (the path of the
    pressure-nullspace test): applies and the assembled diagonal."""
    js, ts, st = case["js"], case["ts"], case["st"]
    jA = js.form.element_jacobians(jnp.asarray(st["u"]),
                                   jnp.asarray(st["p"]),
                                   (jnp.asarray(st["up"]),), js.params())
    facet_dmf = ts.form._facet_blocks[0]["dofmap_flat"]
    tA = (T(jA[0]), [(facet_dmf, T(jA[1][0][1]))])
    n_uf = ts.form.n_u_flat
    if which == "full":
        ref = js.form.apply_element_matrices(*jA, jnp.asarray(st["v"]))
        got = ts.form.apply_element_matrices(*tA, T(st["v"]))
    elif which == "diag":
        ref = js.form.jacobian_diagonal(*jA)
        got = ts.form.jacobian_diagonal(*tA)
    else:
        v = st["v"][:n_uf] if which[1] == "u" else st["v"][n_uf:]
        ref = js.form.apply_sub_block(*jA, jnp.asarray(v), which)
        got = ts.form.apply_sub_block(*tA, T(v), which)
    assert_close(got, ref)
