"""BDF2 in cfdtpu_torch against cfdtpu (JAX): K14's plain cell body
(ns_cell_residual_bdf2_p1 and ns_cell_jacobian_bdf2_p1 on CPU tensors)
against StabilizedNSFormBDF2's cell kernel, the BDF2 form with its
natural correction at u (K7's implicit mode) against cfdtpu's, the
stabilized_schur_bdf2 solver on the DFG 2D-1 slice at res_scale 1.5
(4,461 DOF, float64, the solver's default options) for 3 steps (BDF1,
then BDF2), and a resume from a cfdtpu checkpoint with u_prev2 (BDF2
goes on) and without it (the first step after the resume is BDF1, as
in cfdtpu).

Tolerances: 1e-12 relative to the largest magnitude of the reference
for the element layer (float64, only the order of the sums differs);
equal Newton and KSP counts per step and the state within 1e-8
relative for the slices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdtpu.scenarios.dfg_1 import DFG1Benchmark as JaxDFG

from cfdtpu_torch import kernels
from cfdtpu_torch.io.state import load_reference_checkpoint
from cfdtpu_torch.kernels.ns_cell_residual import (ns_cell_jacobian_bdf2_p1,
                                                   ns_cell_residual_bdf2_p1)
from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark as TorchDFG

torch.set_num_threads(1)

RTOL = 1e-12
TOL = 1e-8
SOLVER = "stabilized_schur_bdf2"
ELEM_KW = dict(dt=0.05, T=1.0, res_scale=1.5, dtype="float64")
SLICE_KW = dict(ELEM_KW, stats_every=1)
BDF = {"bdf1": (1.0, -1.0, 0.0), "bdf2": (1.5, -2.0, 0.5)}


@pytest.fixture(scope="module")
def pair():
    kernels.reset_counts()
    return (JaxDFG(SOLVER, **ELEM_KW).solver,
            TorchDFG(SOLVER, device="cpu", **ELEM_KW).solver)


def _state(ts, seed):
    rng = np.random.default_rng(seed)
    n_u, n_p = ts.V.num_dofs, ts.Q.num_dofs
    u, up, up2 = (0.3 * rng.standard_normal((n_u, 2)) for _ in range(3))
    if seed % 2:
        up[: n_u // 3] = 0.0  # cells at rest: tau's eps guard
    return u, up, up2, rng.standard_normal(n_p)


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= rtol * scale, f"max err {err:.3e} vs scale {scale:.3e}"


def _prm(solver, bdf):
    solver._bdf = BDF[bdf]
    return solver.params()


def _cell_args(ts, u, up, up2, p, prm):
    f, T = ts.form, torch.as_tensor
    return (T(u), T(up), T(up2), T(p), f.dofmap_u, f.dofmap_p, f.cell_coords,
            f.cell_h, f.tabs, prm["rho"], prm["mu"], prm["dt"], prm["f"],
            f.eps, (prm["bdf_a0"], prm["bdf_a1"], prm["bdf_a2"]))


@pytest.mark.parametrize("bdf", list(BDF))
@pytest.mark.parametrize("seed", [0, 1])
def test_bdf2_cell_residual_matches_cfdtpu(pair, seed, bdf):
    """K14's plain residual against vmap of StabilizedNSFormBDF2's cell
    kernel."""
    js, ts = pair
    u, up, up2, p = _state(ts, seed)
    J = jnp.asarray
    f = js.form
    ref = jax.vmap(f._kernel, in_axes=(0, 0, 0, 0, 0, None))(
        J(u)[f.dofmap_u], J(p)[f.dofmap_p],
        (J(up)[f.dofmap_u], J(up2)[f.dofmap_u]), f.cell_coords, f.cell_h,
        _prm(js, bdf))
    got = ns_cell_residual_bdf2_p1(*_cell_args(ts, u, up, up2, p,
                                               _prm(ts, bdf)))
    assert len(got) == 2
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("bdf", list(BDF))
@pytest.mark.parametrize("seed", [0, 1])
def test_bdf2_cell_jacobian_matches_cfdtpu(pair, seed, bdf):
    js, ts = pair
    u, up, up2, p = _state(ts, seed)
    J = jnp.asarray
    A_cells, _ = js.form.element_jacobians(J(u), J(p), (J(up), J(up2)),
                                           _prm(js, bdf))
    got = ns_cell_jacobian_bdf2_p1(*_cell_args(ts, u, up, up2, p,
                                               _prm(ts, bdf)))
    _close(got, A_cells)


@pytest.mark.parametrize("bdf", list(BDF))
def test_bdf2_form_matches_cfdtpu(pair, bdf):
    """The BDF2 form (K14 with the natural correction at u in its
    launch): assembled residual and every element Jacobian block."""
    js, ts = pair
    assert [b["term"].implicit for b in ts.form._facet_blocks] == [True]
    u, up, up2, p = _state(ts, 2)
    J, T = jnp.asarray, torch.as_tensor
    jprm, tprm = _prm(js, bdf), _prm(ts, bdf)
    ref = js.form.residual(J(u), J(p), (J(up), J(up2)), jprm)
    got = ts.form.residual(T(u), T(p), (T(up), T(up2)), tprm)
    for g, r in zip(got, ref):
        _close(g, r)
    A_c, ((_, A_f),) = js.form.element_jacobians(J(u), J(p),
                                                 (J(up), J(up2)), jprm)
    got_c, ((_, got_f),) = ts.form.element_jacobians(T(u), T(p),
                                                     (T(up), T(up2)), tprm)
    _close(got_c, A_c)
    _close(got_f, A_f)


def test_bdf2_params(pair):
    """prm carries the coefficients and pcd_theta (cfdtpu's keys)."""
    js, ts = pair
    for bdf in BDF:
        tprm, jprm = _prm(ts, bdf), _prm(js, bdf)
        for key in ("bdf_a0", "bdf_a1", "bdf_a2", "pcd_theta", "dt"):
            assert tprm[key] == float(jprm[key]), key


def march(sc, steps):
    """Advance `steps` checked steps; returns the counts, each step's
    coefficients, and the state as numpy."""
    s = sc.solver
    counts, coefs = [], []
    for _ in range(steps):
        s.solveStep()
        assert s.last_stats["converged"]
        counts.append((int(s.last_stats["newton_iters"]),
                       int(s.last_stats["ksp_iters"])))
        coefs.append(tuple(float(a) for a in s._bdf))
        s.u_prev, s.p_prev = s.u_sol, s.p_sol
    return {"counts": counts, "coefs": coefs, "u": np.array(s.u_sol),
            "p": np.array(s.p_sol), "u_prev2": np.array(s.u_prev2)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    ckpt, lost = str(d / "checkpoint.npz"), str(d / "no_history.npz")
    jsc = JaxDFG(SOLVER, **SLICE_KW)
    out = {"jax": march(jsc, 3)}
    tsc = TorchDFG(SOLVER, device="cpu", **SLICE_KW)
    out["port"] = march(tsc, 3)
    # a cfdtpu checkpoint after 2 steps, and the same without u_prev2
    jsc2 = JaxDFG(SOLVER, **SLICE_KW)
    march(jsc2, 2)
    jsc2.save_checkpoint(ckpt, 0.1, 2)
    with np.load(ckpt) as data:
        assert "u_prev2" in data.files
        np.savez(lost, **{k: data[k] for k in data.files if k != "u_prev2"})
    for tag, path in (("with", ckpt), ("without", lost)):
        jr = JaxDFG(SOLVER, **SLICE_KW)
        jr.load_checkpoint(path)
        out[f"jax_{tag}"] = march(jr, 1)
        tr = TorchDFG(SOLVER, device="cpu", **SLICE_KW)
        assert load_reference_checkpoint(path, tr) == (0.1, 2)
        assert getattr(tr.solver, "_resume_lost_history", False) == (
            tag == "without")
        out[f"port_{tag}"] = march(tr, 1)
    return out


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


LEGS = {"from_rest": ("jax", "port"),
        "resumed_with_u_prev2": ("jax_with", "port_with"),
        "resumed_without_u_prev2": ("jax_without", "port_without")}


@pytest.mark.parametrize("leg", list(LEGS))
def test_bdf2_slice_counts_and_scheme_equal(runs, leg):
    j, p = LEGS[leg]
    assert runs[p]["counts"] == runs[j]["counts"]
    want = {"from_rest": ["bdf1", "bdf2", "bdf2"],
            "resumed_with_u_prev2": ["bdf2"],
            "resumed_without_u_prev2": ["bdf1"]}[leg]
    assert runs[p]["coefs"] == [BDF[k] for k in want]


@pytest.mark.parametrize("leg", list(LEGS))
def test_bdf2_slice_state_matches(runs, leg):
    j, p = LEGS[leg]
    for key in ("u", "p", "u_prev2"):
        assert np.isfinite(runs[p][key]).all()
        assert _rel(runs[p][key], runs[j][key]) < TOL, key


def test_cpu_tensors_launch_no_kernel(pair):
    assert kernels.counts() == {name: 0 for name in kernels.COUNTERS}
