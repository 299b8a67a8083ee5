"""The vascular outlet solvers of cfdtpu_torch against cfdtpu (JAX) on
cfdtpu's small tagged channel (tests/test_variants.py ChannelScenario,
rebuilt on the port in tests/test_torch_variants.py: 2 x 0.5, 24 x 6
cells, 525 DOF), float64 on the CPU, 2 steps from rest each, the
solvers' default options:

- stabilized_schur_velocity_vascular_backflow (sigma form, parabolic
  inlet, v_max 1; the resistance pressure 0.5 p_c (K16), the viscous
  traction (K12) and the backflow (K13) on the outlet; p_c from the
  flux of u_prev after each step);
- stabilized_schur_vascularbc, _weak and _backflow (the curl-curl form,
  K15; the weak pressure p_inlet / 2 at the inlet (K16), curl Nitsche
  (K17) at the inlet and, but for _weak, the outlet; the outlet's weak
  pressure from the flux of u_sol after each step (vascularbc, _weak)
  or fixed at initial_ffr p_inlet / 2 with the backflow term beside it
  (_backflow, five blocks)).

Tolerance: equal Newton and KSP counts per step, the state within 1e-8
relative (float64 on both sides, only the order of the sums differs),
the fixed-point pressures within 1e-10, step by step.
"""

import numpy as np
import pytest
import torch

from test_torch_variants import ChannelScenario as TorchChannel
from test_variants import ChannelScenario as JaxChannel, _parabolic

torch.set_num_threads(1)

TOL = 1e-8
P_TOL = 1e-10
CASES = {
    "stabilized_schur_velocity_vascular_backflow": (
        dict(inlet_velocity=_parabolic, v_max=1.0, R_resistance=0.5),
        ["resistance_out", "viscous_out", "backflow_out"], "p_c"),
    "stabilized_schur_vascularbc": (
        dict(p_inlet=1.0, R_resistance=0.5),
        ["weak_pressure_in", "weak_pressure_out", "nitsche_in",
         "nitsche_out"], "p_outlet_w"),
    "stabilized_schur_vascularbc_weak": (
        dict(p_inlet=1.0, R_resistance=0.5),
        ["weak_pressure_in", "weak_pressure_out", "nitsche_in"],
        "p_outlet_w"),
    "stabilized_schur_vascularbc_backflow": (
        dict(p_inlet=1.0),
        ["weak_pressure_in", "weak_pressure_out", "nitsche_in",
         "nitsche_out", "backflow_out"], "p_outlet_w"),
}


def march(sc, steps, key):
    s = sc.solver
    counts, fixed = [], []
    for _ in range(steps):
        s.solveStep()
        assert s.last_stats["converged"]
        counts.append((int(s.last_stats["newton_iters"]),
                       int(s.last_stats["ksp_iters"])))
        fixed.append(float(getattr(s, key)))
        s.u_prev, s.p_prev = s.u_sol, s.p_sol
    return {"counts": counts, "fixed": np.array(fixed),
            "u": np.array(s.u_sol), "p": np.array(s.p_sol),
            "blocks": [b["name"] for b in s.form._facet_blocks],
            "pin": s.pin_pressure}


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


@pytest.fixture(scope="module", params=list(CASES))
def runs(request):
    kw, blocks, key = CASES[request.param]
    kw = dict(kw, dt=0.05, T=1.0)
    return request.param, {
        "jax": march(JaxChannel(request.param, **kw), 2, key),
        "port": march(TorchChannel(request.param, **kw), 2, key)}


def test_counts_and_state_match_cfdtpu(runs):
    name, r = runs
    assert r["port"]["counts"] == r["jax"]["counts"]
    assert r["port"]["blocks"] == r["jax"]["blocks"] == CASES[name][1]
    assert r["port"]["pin"] == r["jax"]["pin"]
    assert np.abs(r["port"]["u"]).max() > 1e-3  # the flow has started
    assert _rel(r["port"]["u"], r["jax"]["u"]) < TOL
    assert _rel(r["port"]["p"], r["jax"]["p"]) < TOL


def test_fixed_point_pressures_match_cfdtpu(runs):
    """p_c (velocity_vascular_backflow) or the outlet's weak pressure
    (vascularbc, _weak; _backflow's stays initial_ffr p_inlet / 2)
    after each step."""
    name, r = runs
    got, ref = r["port"]["fixed"], r["jax"]["fixed"]
    assert np.abs(got - ref).max() <= P_TOL * max(np.abs(ref).max(), 1e-300)
    if name.endswith("_backflow") and "velocity" not in name:
        assert (got == 0.4).all()
    else:
        assert got[-1] > 0 and got[0] != got[1]
