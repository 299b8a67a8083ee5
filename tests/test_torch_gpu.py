"""cfdtpu_torch CUDA kernels against their plain versions, on the card.

Marked `gpu`: each test skips where torch has no CUDA device (the
kernels are CUDA C++ with no interpret mode). On a machine with a card:

    python -m pytest tests/test_torch_gpu.py -m gpu -q

Inputs are the DFG 2D-1 maps at res_scale 2.5 in float64 and a random
state made with numpy. Tolerance 1e-12 relative: float64 on both sides,
only the order of the sums differs.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

RTOL = 1e-12


@pytest.fixture(scope="module")
def sc():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark

    return DFG1Benchmark("stabilized_schur", dt=0.05, T=1.0,
                         res_scale=2.5, dtype="float64", device="cuda",
                         pc_lag_steps=4, snes_lag_jacobian=True)


def _close(got, ref):
    err = float((got - ref).abs().max())
    assert err <= RTOL * float(ref.abs().max()), err


def _state(s, seed=0):
    rng = np.random.default_rng(seed)
    n_u, n_p = s.V.num_dofs, s.Q.num_dofs
    return (s.tensor(0.3 * rng.standard_normal((n_u, 2))),
            s.tensor(0.3 * rng.standard_normal((n_u, 2))),
            s.tensor(rng.standard_normal(n_p)))


def test_kernels_match_plain_and_count(sc):
    from cfdtpu_torch import kernels
    from cfdtpu_torch.kernels.ell_sum import ell_sum, ell_sum_plain
    from cfdtpu_torch.kernels.ns_cell_residual import (
        ns_cell_residual_p1, ns_cell_residual_plain)
    from cfdtpu_torch.kernels.selfp_triple import (selfp_triple,
                                                   selfp_triple_plain)
    from cfdtpu_torch.kernels.sup_spmv import sup_spmv, sup_spmv_plain

    s = sc.solver
    f, nb = s.form, s._nodebsr
    u, up, p = _state(s)
    prm = s.params()
    kernels.reset_counts()
    args = (u, up, p, f.dofmap_u, f.dofmap_p, f.cell_coords, f.cell_h,
            f.tabs, prm["rho"], prm["mu"], prm["dt"], prm["f"], f.eps)
    for g, r in zip(ns_cell_residual_p1(*args),
                    ns_cell_residual_plain(*args)):
        _close(g, r)
    vals = nb.assemble(*f.element_jacobians(u, p, (up,), prm))
    X = nb._sup_rows(s.tensor(np.ones(nb.n_u_flat + nb.n_nodes)))
    cols = nb._sup.sup_cols
    _close(sup_spmv(vals["sup"], cols, X),
           sup_spmv_plain(vals["sup"], cols, X,
                          vals["sup"].shape[0] * vals["sup"].shape[2]))
    src = s.tensor(np.arange(nb._assemble_scatter.n_in * 9.0)
                   .reshape(-1, 9))
    idx = nb._assemble_scatter.ell_idx
    _close(ell_sum(src, idx), ell_sum_plain(src, idx))
    inv = s.tensor(np.ones((nb.n_nodes, 2)))
    sargs = (vals["coo"], nb._sp_e1, nb._sp_e2, nb._sp_K, inv)
    _close(selfp_triple(*sargs), selfp_triple_plain(*sargs))
    torch.cuda.synchronize()
    n = kernels.counts()
    assert all(n[k] > 0 for k in ("ns_cell_residual_p1", "sup_spmv",
                                  "ell_sum", "selfp_triple"))


def test_step_on_card_matches_cpu(sc):
    """One float64 step through the kernels equals the plain versions
    (CPU) in iteration counts and state."""
    from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark

    cpu = DFG1Benchmark("stabilized_schur", dt=0.05, T=1.0, res_scale=2.5,
                        dtype="float64", device="cpu", pc_lag_steps=4,
                        snes_lag_jacobian=True)
    out = []
    for scen in (sc, cpu):
        s = scen.solver
        s.solveStep()
        out.append((s.last_stats["newton_iters"], s.last_stats["ksp_iters"],
                    s.u_sol.cpu().numpy()))
    assert out[0][:2] == out[1][:2]
    rel = np.linalg.norm(out[0][2] - out[1][2]) / np.linalg.norm(out[1][2])
    assert rel < 1e-9


def test_new_kernels_match_plain_and_count(sc):
    """K5 patch_spmv and K6 ras_apply (plain and with its add epilogue)
    against their plain versions, in float64 and float32."""
    from cfdtpu_torch import kernels
    from cfdtpu_torch.kernels.patch_spmv import patch_spmv, patch_spmv_plain
    from cfdtpu_torch.kernels.ras_apply import ras_apply, ras_apply_plain

    s = sc.solver
    nb = s._nodebsr
    rng = np.random.default_rng(1)
    kernels.reset_counts()
    for dt, tol in ((torch.float64, RTOL), (torch.float32, 1e-5)):
        x = torch.as_tensor(rng.standard_normal((64, 128)), dtype=dt,
                            device="cuda")
        vals = torch.as_tensor(rng.standard_normal((64, 128, 8)), dtype=dt,
                               device="cuda")
        idx = torch.as_tensor(rng.integers(0, 128, (64, 128, 8)),
                              dtype=torch.int32, device="cuda")
        got, ref = patch_spmv(x, vals, idx), patch_spmv_plain(x, vals, idx)
        assert float((got - ref).abs().max()) <= tol * float(
            ref.abs().max())
        for so in ((32, 4), (16, 4), (7, 3)):
            ras = nb.uu_ras(*so)
            inv = torch.as_tensor(rng.standard_normal(
                (ras.n_sub, ras.m, ras.m)), dtype=dt, device="cuda")
            v = torch.as_tensor(rng.standard_normal(nb.n_u_flat), dtype=dt,
                                device="cuda")
            for base in (None, v * 0.5):
                got = ras_apply(inv, v, ras._win, ras.s, ras.o, ras.d, base)
                ref = ras_apply_plain(inv, v, ras._win, ras.s, ras.o, ras.d,
                                      base)
                assert float((got - ref).abs().max()) <= tol * float(
                    ref.abs().max())
    torch.cuda.synchronize()
    assert kernels.counts()["patch_spmv"] == 2
    assert kernels.counts()["ras_apply"] == 12


def test_residual_bitwise_repeatable():
    """Two float32 residual calls on one state are bitwise equal (the
    facet term is a K2 reduction, not an atomic index_add)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark

    s = DFG1Benchmark("stabilized_schur", dt=0.05, T=1.0, res_scale=1.0,
                      dtype="float32", device="cuda").solver
    u, up, p = _state(s, seed=3)
    a = s.form.residual(u, p, (up,), s.params())
    b = s.form.residual(u, p, (up,), s.params())
    assert all(torch.equal(x, y) for x, y in zip(a, b))
