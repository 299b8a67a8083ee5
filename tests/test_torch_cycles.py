"""The AMG cycle family against cfdtpu (JAX): the power iteration and the
Chebyshev sweep of la/chebyshev.py (plain and through K1's cheby mode),
K11's plain version against cfdtpu's _gcr2, K10's plain version against
NodeBSR.uu_block_jacobi, and the AMG and BlockAMG cycles with the
W-cycle, the K-cycle, Chebyshev smoothing (degree 1, 2, 3) and all
three together, at n_smooth 1 and 2, with and without the RAS fine
smoother (BlockAMG's in tests/test_torch_block_cycles.py). Oracles of
the port alone: the W-cycle contracts at least as hard as the V-cycle
(cfdtpu's tests/test_solver.py:185-247), and the W-cycle's sum in K1's
epilogue equals the plain add bit for bit.
DFG 2D-1 at res_scale 1.0 (9,861 DOF), float64, on one assembled
Jacobian at a developed-looking state made with numpy; the wrappers take
their plain versions on the CPU.

Tolerances: float64 on both sides running the same algorithm, the sums
in another order: the single products and K10 1e-12; the power
iteration (ten products), the sweeps and the cycles (a few dozen sums,
a dense coarsest inverse, the K-cycle's dot products) 1e-11.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdtpu.la.amg import AMG as JaxAMG
from cfdtpu.la.amg import BlockAMG as JaxBlockAMG
from cfdtpu.la.amg import _gcr2 as jax_gcr2
from cfdtpu.la.chebyshev import chebyshev_fixed as jax_chebyshev
from cfdtpu.la.chebyshev import estimate_lambda_max as jax_lambda
from cfdtpu.scenarios.dfg_1 import DFG1Benchmark as JaxDFG

from cfdtpu_torch.kernels.amg_gcr2 import gcr2_first, gcr2_second
from cfdtpu_torch.kernels.block_jacobi import (block_jacobi,
                                               block_jacobi_inv)
from cfdtpu_torch.la import amg as amg_module
from cfdtpu_torch.la.amg import AMG, BlockAMG
from cfdtpu_torch.la.chebyshev import (cheby_scale, chebyshev_fixed,
                                       estimate_lambda_max)
from cfdtpu_torch.la.schur import _safe, _sub_ops
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
    rng = np.random.default_rng(909)
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
    mp = tmask[nuf:]
    sp = torch.where(mp[tnb._sp_row], 0.0, sp)
    sp[tnb._sp_diag_pos] = torch.where(mp, 1.0, sp[tnb._sp_diag_pos])
    uu = tnb.uu_vals(tvals, tmask[:nuf])
    return {"js": js, "ts": ts, "jnb": jnb, "tnb": tnb, "jvals": jvals,
            "tvals": tvals, "mask": mask, "inv_d_u": inv_d_u,
            "sp": sp.numpy(), "uu": uu.numpy()}


def _hierarchies(case, kind, n_smooth):
    """cfdtpu's and the port's hierarchy of `kind` (coarse_size 40: three
    levels on this graph, as 106k DOF has) and their input values."""
    tnb, jnb = case["tnb"], case["jnb"]
    if kind == "amg":
        sp_row, sp_col, _ = tnb.sp_structure()
        kw = dict(agg_row=tnb.block_row_np, agg_col=tnb.block_col_np,
                  n_smooth=n_smooth, coarse_size=40)
        return (JaxAMG(sp_row, sp_col, tnb.n_nodes, **kw),
                AMG(sp_row, sp_col, tnb.n_nodes, device="cpu", **kw),
                case["sp"])
    ras = kind == "block + ras"
    jh = JaxBlockAMG(np.asarray(jnb.block_row), np.asarray(jnb.block_col),
                     jnb.n_nodes, d=2, coarse_size=40, n_smooth=n_smooth,
                     fine_smoother=jnb.uu_ras(*RAS) if ras else None)
    th = BlockAMG(tnb.block_row_np, tnb.block_col_np, tnb.n_nodes, d=2,
                  coarse_size=40, n_smooth=n_smooth, device="cpu",
                  fine_smoother=tnb.uu_ras(*RAS) if ras else None)
    return jh, th, case["uu"]


@pytest.fixture(scope="module")
def hier(case):
    cache = {}

    def get(kind, n_smooth):
        key = (kind, n_smooth)
        if key not in cache:
            cache[key] = _hierarchies(case, kind, n_smooth)
        return cache[key]

    return get


def _set(jh, th, kcycle=False, wcycle=False, cheby=0):
    jh.kcycle, jh.wcycle, jh.cheby_degree = kcycle, wcycle, cheby
    th.set_cycle(kcycle=kcycle, wcycle=wcycle, cheby=cheby)


# -- la/chebyshev.py ------------------------------------------------------
def _level0(case):
    """The SELFP matrix's product and l1-Jacobi diagonal at the port's
    level 0 (K1), and the same product in cfdtpu."""
    _, th, sp = _hierarchies(case, "amg", 1)
    ev = th._place(0, T(sp))
    d = th._l1_diag(0, ev)
    jh = JaxAMG(*case["tnb"].sp_structure()[:2], case["tnb"].n_nodes,
                agg_row=case["tnb"].block_row_np,
                agg_col=case["tnb"].block_col_np, coarse_size=40)
    jev = jh._place(0, jnp.asarray(sp))
    return (lambda v: th._matvec(0, ev, v)), (
        lambda v: jh._matvec(0, jev, v)), d, th, ev


@pytest.mark.parametrize("op", ["selfp", "auu"])
def test_estimate_lambda_max(case, op):
    """Ten power steps (K1, then K9's scaled normalisation) against
    cfdtpu's estimate_lambda_max: a (1,) tensor, no host read."""
    if op == "selfp":
        mv, jmv, d, _, _ = _level0(case)
        inv = 1.0 / d
    else:
        ts, mask = case["ts"], case["mask"]
        nuf = ts.form.n_u_flat
        Auu = _sub_ops(case["tnb"], case["tvals"], T(mask[:nuf]), None,
                       False, case["inv_d_u"])[0]
        y = case["jnb"].apply_sub_block
        jm = jnp.asarray(mask[:nuf])

        def jmv(v):
            return jnp.where(jm, v, y(case["jvals"], (), v, "uu"))

        mv, inv = Auu, case["inv_d_u"]
    lam = estimate_lambda_max(mv, inv)
    assert lam.shape == (1,)
    ref = jax_lambda(jmv, jnp.asarray(inv.numpy()), inv.shape[0],
                     jnp.float64)
    assert_close(lam, np.reshape(np.asarray(ref), (1,)), 1e-11)


def test_estimate_lambda_max_zero_product():
    """A zero product: K9's tiny floor gives v = 0 and lambda = 0, as
    cfdtpu's 1e-300 floor does in float64 (no NaN)."""
    inv = torch.ones(40, dtype=torch.float64)
    lam = estimate_lambda_max(lambda v: torch.zeros_like(v), inv)
    ref = jax_lambda(lambda v: jnp.zeros_like(v), jnp.ones(40), 40,
                     jnp.float64)
    assert float(lam[0]) == float(ref) == 0.0


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("frac", [0.06, 0.25])
def test_chebyshev_fixed(case, frac, m, fused):
    """m steps on [frac, 1] lambda against cfdtpu's chebyshev_fixed: the
    operator then cheby_update, or each step one K1 launch in its cheby
    mode (x0 = w b read through K1's input scale)."""
    mv, jmv, d, th, ev = _level0(case)
    inv = 1.0 / d
    lam = estimate_lambda_max(mv, inv)
    b = np.random.default_rng(7 + m).standard_normal(d.shape[0])
    w = cheby_scale(inv, lam, frac)

    def step(x, b, scale, dprev, a, c, d_out):
        return th._matvec(0, ev, x, mode="cheby", b=b, scale=scale,
                          cheb=(w, dprev, a, c), d_out=d_out)

    got = chebyshev_fixed(mv, T(b), w, m, frac, step=step if fused else None)
    ref = jax_chebyshev(jmv, jnp.asarray(b), jnp.asarray(inv.numpy()),
                        jnp.asarray(lam.numpy()[0]), m=m, lam_min_frac=frac)
    assert_close(got, ref, 1e-11)


# -- K11, K10 -------------------------------------------------------------
def test_gcr2_matches_cfdtpu(case):
    """K11's two launches (plain versions) between the products and the
    preconditioner calls against cfdtpu's _gcr2."""
    mv, jmv, d, _, _ = _level0(case)
    inv = 1.0 / d
    b = np.random.default_rng(3).standard_normal(d.shape[0])

    def M(v):
        return inv * v

    z1 = M(T(b))
    q1 = mv(z1)
    r, coef = gcr2_first(q1, T(b))
    z2 = M(r)
    got = gcr2_second(q1, mv(z2), z1, z2, r, coef)
    jinv = jnp.asarray(inv.numpy())
    ref = jax_gcr2(jmv, lambda v: jinv * v, jnp.asarray(b))
    assert_close(got, ref, 1e-11)


def test_block_jacobi_matches_cfdtpu(case):
    """K10's plain versions: the masked inverses and the apply against
    cfdtpu's uu_block_jacobi; at d = 1 the apply is v * (1 / d)."""
    mask = case["mask"]
    nuf = case["ts"].form.n_u_flat
    tnb = case["tnb"]
    inv = block_jacobi_inv(case["tvals"]["coo"], tnb._diag_pos,
                           T(mask[:nuf]), 2)
    v = np.random.default_rng(4).standard_normal(nuf)
    ref = case["jnb"].uu_block_jacobi(case["jvals"],
                                      jnp.asarray(mask[:nuf]))(
        jnp.asarray(v))
    assert_close(block_jacobi(inv, T(v)), ref, 1e-12)
    assert_close(tnb.uu_block_jacobi(case["tvals"], T(mask[:nuf]))(T(v)),
                 ref, 1e-12)
    dp = 0.5 + np.random.default_rng(5).random(40)
    x = np.random.default_rng(6).standard_normal(40)
    assert_close(block_jacobi(T(1.0 / dp).reshape(-1, 1, 1), T(x)), x / dp,
                 1e-15)


# -- the cycles -----------------------------------------------------------
CYCLES = {
    "W": dict(wcycle=True),
    "K": dict(kcycle=True),
    "cheby1": dict(cheby=1),
    "cheby2": dict(cheby=2),
    "cheby3": dict(cheby=3),
    "W+K+cheby2": dict(wcycle=True, kcycle=True, cheby=2),
}
CASES = ([(c, 1) for c in CYCLES]
         + [(c, 2) for c in ("W", "K", "cheby2", "W+K+cheby2")])


def check_cycle(hier, kind, cycle, n_smooth):
    """cfdtpu's and the port's cycle of `kind` with the options of
    CYCLES[cycle]: each level's lambda (Chebyshev), the cycle, and with
    the K-cycle on, the cycle forced linear (kcycle=False)."""
    jh, th, vals = hier(kind, n_smooth)
    _set(jh, th, **CYCLES[cycle])
    try:
        jbuilt = jh.build(jnp.asarray(vals))
        tbuilt = th.build(T(vals))
        for jl, tl in zip(jbuilt[0], tbuilt[0]):
            assert (jl[2] is None) == (tl[3] is None)
            if tl[3] is not None:  # lambda of each Chebyshev level
                assert_close(tl[3][0], np.reshape(np.asarray(jl[2]), (1,)),
                             1e-11)
        n = th.coo[0][2] * th.width
        r = np.random.default_rng(61 + n_smooth).standard_normal(n)
        got = th.v_cycle(tbuilt, T(r))
        assert_close(got, jh.v_cycle(jbuilt, jnp.asarray(r)), 1e-11)
        if "K" in cycle:  # forced linear: W or V as cfdtpu
            assert_close(th.v_cycle(tbuilt, T(r), kcycle=False),
                         jh.v_cycle(jbuilt, jnp.asarray(r), kcycle=False),
                         1e-11)
    finally:
        _set(jh, th)


@pytest.mark.parametrize("cycle,n_smooth", CASES)
def test_cycle_matches_cfdtpu(case, hier, cycle, n_smooth):
    """The SELFP AMG (BlockAMG: tests/test_torch_block_cycles.py)."""
    check_cycle(hier, "amg", cycle, n_smooth)


def test_wcycle_sum_in_epilogue_equals_plain_add(case, hier, monkeypatch):
    """K1's add option (x2 + x1 in the second visit's last launch) equals
    the reference's separate x1 + x2 bit for bit."""
    jh, th, vals = hier("amg", 1)
    _set(jh, th, wcycle=True)
    try:
        built = th.build(T(vals))
        r = T(np.random.default_rng(5).standard_normal(th.coo[0][2]))
        fused = th.v_cycle(built, r)
        spmv, adds = amg_module.sup_spmv, []

        def apart(*a, add=None, **kw):
            y = spmv(*a, **kw)
            if add is not None:
                adds.append(1)
                y = add + y
            return y

        monkeypatch.setattr(amg_module, "sup_spmv", apart)
        assert torch.equal(th.v_cycle(built, r), fused)
        assert len(adds) == 2 ** (len(th.levels) - 1) - 1 > 0
    finally:
        _set(jh, th)


def test_wcycle_contracts_at_least_as_v():
    """cfdtpu's oracle (tests/test_solver.py:185-247) on the port: the
    SELFP matrix of the Stokes-like operator (u = 0) on a 16 x 16 unit
    square, six stationary iterations with the hierarchy's cycle and the
    mean removed (the pressure is pinned): the V-cycle contracts below
    0.05, and the W-cycle at least as hard (1.05 times)."""
    from cfdtpu_torch.forms import StabilizedNSForm
    from cfdtpu_torch.la.nodebsr import NodeBSR
    from cfdtpu_torch.mesh import create_unit_square
    from cfdtpu_torch.spaces import FunctionSpace

    mesh = create_unit_square(16, 16)
    V, Q = FunctionSpace(mesh, 1, 2), FunctionSpace(mesh, 1)
    form = StabilizedNSForm(V, Q, device="cpu", dtype=np.float64)
    bsr = NodeBSR(form)
    prm = {"dt": 0.01, "rho": 1.0, "mu": 0.01, "f": (0.0, 0.0)}
    u = torch.zeros((V.num_dofs, 2), dtype=torch.float64)
    p0 = torch.zeros(Q.num_dofs, dtype=torch.float64)
    vals = bsr.assemble(*form.element_jacobians(u, p0, (u,), prm))
    sp = bsr.sp_vals(vals)
    amg = bsr.sp_amg()
    built = amg.build(sp)
    row, col, _ = amg.coo[0]
    row, col = torch.as_tensor(row).long(), torch.as_tensor(col).long()

    def mv(x):
        return torch.zeros_like(x).index_add_(0, row, sp * x[col])

    b = T(np.random.RandomState(0).randn(bsr.n_nodes))
    b = b - b.mean()
    rels = {}
    for w in (False, True):
        amg.set_cycle(wcycle=w)
        x, r = torch.zeros_like(b), b
        for _ in range(6):
            x = x + amg.v_cycle(built, r)
            x = x - x.mean()
            r = b - mv(x)
            r = r - r.mean()
        rels[w] = float(torch.linalg.vector_norm(r)
                        / torch.linalg.vector_norm(b))
    amg.set_cycle(wcycle=False)
    assert rels[False] < 0.05, rels
    assert rels[True] <= 1.05 * rels[False], rels
