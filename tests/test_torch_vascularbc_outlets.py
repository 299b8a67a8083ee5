"""The remaining vascular outlet solvers of cfdtpu_torch against cfdtpu
(JAX) on cfdtpu's small tagged channel (as tests/test_torch_vascularbc.py),
float64 on the CPU, 2 steps from rest each:

- stabilized_schur_vascularbc_strong: the curl-curl form (K15), the
  weak pressure and Nitsche at the inlet only (K16, K17); the outlet
  pressure a Dirichlet condition set after each step to R |Q| / 2 from
  the flux of u_sol, measured on a flux-only block (no term, no launch;
  cfdtpu adds a block of zeros there): the Dirichlet values the solver
  imposes, step by step, are cfdtpu's and are what the pressure takes
  on the outlet;
- stabilized_schur_vascularbc_cbc and _ddn: the curl-curl form, a
  parabolic inlet (v_max 1) and the convective or directional
  do-nothing outlet (K18).

Tolerance: equal Newton and KSP counts per step, the state within 1e-8
relative, the outlet pressures within 1e-10.
"""

import numpy as np
import pytest
import torch

from test_torch_variants import ChannelScenario as TorchChannel
from test_variants import ChannelScenario as JaxChannel, _parabolic

torch.set_num_threads(1)

TOL = 1e-8
P_TOL = 1e-10


def march(sc, steps):
    """2 steps; logs the outlet pressure Dirichlet values each step
    imposes (the last bcp's, re-evaluated by _bc_values)."""
    s = sc.solver
    counts, imposed = [], []
    bc_values = s._bc_values

    def logged():
        out = bc_values()
        imposed.append(np.array(out[1]))
        return out

    s._bc_values = logged
    for _ in range(steps):
        s.solveStep()
        assert s.last_stats["converged"]
        counts.append((int(s.last_stats["newton_iters"]),
                       int(s.last_stats["ksp_iters"])))
        s.u_prev, s.p_prev = s.u_sol, s.p_sol
    return {"counts": counts, "imposed": imposed, "u": np.array(s.u_sol),
            "p": np.array(s.p_sol), "solver": s}


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


@pytest.fixture(scope="module")
def strong():
    kw = dict(dt=0.05, T=1.0, p_inlet=1.0, R_resistance=0.5)
    return (march(JaxChannel("stabilized_schur_vascularbc_strong", **kw), 2),
            march(TorchChannel("stabilized_schur_vascularbc_strong", **kw),
                  2))


def test_strong_counts_and_state_match_cfdtpu(strong):
    j, t = strong
    assert t["counts"] == j["counts"]
    assert _rel(t["u"], j["u"]) < TOL and _rel(t["p"], j["p"]) < TOL


def test_strong_outlet_is_a_flux_block_without_a_launch(strong):
    """The form's terms are the inlet's two; the outlet is a flux-only
    block, which facet_flux reads as cfdtpu's zero block."""
    j, t = strong
    ts, js = t["solver"], j["solver"]
    assert [b["name"] for b in ts.form._facet_blocks] == [
        "weak_pressure_in", "nitsche_in"]
    assert [b["name"] for b in ts.form._flux_blocks] == ["outlet_flux"]
    q_t = ts.outlet_flux()
    q_j = js.outlet_flux()
    assert q_t > 0 and abs(q_t - q_j) <= P_TOL * abs(q_j)


def test_strong_outlet_dirichlet_values_step_by_step(strong):
    """Step 1 imposes initial_ffr p_inlet / 2 = 0.4 on the outlet's
    pressure dofs; step 2 the value _post_step set from step 1's flux
    (DirichletBC.update re-evaluates the callable every step), in both
    packages; the pressure takes those values on the outlet (to Newton's
    tolerance: the Dirichlet rows' residual is p - value)."""
    j, t = strong
    assert len(t["imposed"]) == len(j["imposed"]) == 2
    assert np.all(t["imposed"][0] == 0.4)
    assert not np.allclose(t["imposed"][1], 0.4)
    for got, ref in zip(t["imposed"], j["imposed"]):
        assert got.shape == ref.shape and len(np.unique(got)) == 1
        assert np.abs(got - ref).max() <= P_TOL * np.abs(ref).max()
    ts = t["solver"]
    dofs = ts.bc_dofs_p
    assert len(dofs) > 0
    np.testing.assert_allclose(t["p"][dofs], t["imposed"][1], rtol=TOL)


@pytest.mark.parametrize("name", ["stabilized_schur_vascularbc_cbc",
                                  "stabilized_schur_vascularbc_ddn"])
def test_convective_outlets_match_cfdtpu(name):
    kw = dict(dt=0.05, T=1.0, inlet_velocity=_parabolic, v_max=1.0)
    j = march(JaxChannel(name, **kw), 2)
    t = march(TorchChannel(name, **kw), 2)
    assert t["counts"] == j["counts"]
    assert _rel(t["u"], j["u"]) < TOL and _rel(t["p"], j["p"]) < TOL
    ts = t["solver"]
    (block,) = ts.form._facet_blocks
    assert block["term"].term == name[-3:]


def test_cbc_requires_v_max():
    with pytest.raises(ValueError, match="v_max is required"):
        TorchChannel("stabilized_schur_vascularbc_cbc", dt=0.05, T=0.1,
                     inlet_velocity=_parabolic)
