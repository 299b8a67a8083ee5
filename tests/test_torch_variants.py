"""The solver variants of cfdtpu_torch against cfdtpu (JAX) on the small
tagged channel of cfdtpu's tests/test_variants.py (ChannelScenario,
scenario name test_channel: 2 x 0.5, 24 x 6 cells, inlet, outlet and
wall tags, 525 DOF), rebuilt here on the port's mesh/structured.py,
float64 on the CPU:

- stabilized_schur_backflow (parabolic inlet, v_max 1, backflow on the
  outlet: kernel K13): counts, state and the outlet flux (facet_flux of
  backflow_out);
- stabilized_schur_ramping: the Dirichlet values scaled by step / 10;
- stabilized_schur_adaptive under a lagged preconditioner (snes_max_it
  6, chord Newton, pc_lag_steps 4, dt 0.2: Newton fails at the larger
  steps) with the same dt sequence, attempt by attempt, and the same
  counts as cfdtpu; and forced to fail every attempt (snes_max_it 1);
- the variant hooks: params() holds extra_params(), setup() receives
  the scenario's tags before anything is built, _post_step() runs once a
  step, after u_sol is set and before step_count moves.

Tolerance: equal Newton and KSP counts per step (per attempt for
adaptive), the state within 1e-8 relative (float64 on both sides, only
the order of the sums differs).
"""

import numpy as np
import pytest
import torch

from test_variants import ChannelScenario as JaxChannel

from cfdtpu_torch.mesh import create_rectangle
from cfdtpu_torch.scenarios.base import Scenario
from cfdtpu_torch.solvers.stabilized_schur import Solver as TorchSolver
from cfdtpu_torch.spaces import BoundaryCondition

torch.set_num_threads(1)

TOL = 1e-8


class ChannelScenario(Scenario):
    """cfdtpu's test channel on the port (tests/test_variants.py:14-80)."""

    inlet_marker = 1
    outlet_marker = 2
    wall_marker = 3

    def __init__(self, solver_name, dt, T, *, rho=1.0, mu=0.05,
                 inlet_velocity=None, **solver_kwargs):
        self._mesh = None
        self._bcu = None
        self._bcp = None
        self._inlet_velocity = inlet_velocity
        super().__init__(
            solver_name, "test_channel", rho, mu, dt, T, (0.0, 0.0),
            device="cpu", **solver_kwargs,
        )
        self.setup()

    @property
    def mesh(self):
        if self._mesh is None:
            m = create_rectangle((0, 0), (2.0, 0.5), (24, 6))
            m.mark_boundary_facets(
                lambda x: np.isclose(x[0], 0.0), self.inlet_marker)
            m.mark_boundary_facets(
                lambda x: np.isclose(x[0], 2.0), self.outlet_marker)
            m.mark_boundary_facets(
                lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 0.5),
                self.wall_marker)
            self._mesh = m
        return self._mesh

    @property
    def bcu(self):
        if self._bcu is None:
            walls = BoundaryCondition(np.zeros(2))
            walls.initTopological(
                1, self.mesh.tagged_facets(self.wall_marker))
            self._bcu = [walls]
            if self._inlet_velocity is not None:
                bc_in = BoundaryCondition(self._inlet_velocity)
                bc_in.initTopological(
                    1, self.mesh.tagged_facets(self.inlet_marker))
                self._bcu.append(bc_in)
        return self._bcu

    @property
    def bcp(self):
        if self._bcp is None:
            self._bcp = []
        return self._bcp

    def initial_velocity(self, x):
        return np.zeros((2, x.shape[1]))


def _parabolic(x):
    y = x[1]
    return np.vstack([4.0 * y * (0.5 - y) / 0.25, np.zeros(x.shape[1])])


def _attempts(sc):
    """Log (dt, newton, ksp, converged) of every _run_step call."""
    s = sc.solver
    run = s._run_step
    log = []

    def logged(*a):
        out = run(*a)
        st = out[4]
        log.append((float(s.dt), int(st["newton_iters"]),
                    int(st["ksp_iters"]), bool(st["converged"])))
        return out

    s._run_step = logged
    return log


def march(sc, steps):
    s = sc.solver
    counts = []
    for _ in range(steps):
        s.solveStep()
        assert s.last_stats["converged"]
        counts.append((int(s.last_stats["newton_iters"]),
                       int(s.last_stats["ksp_iters"])))
        s.u_prev, s.p_prev = s.u_sol, s.p_sol
    return counts, np.array(s.u_sol), np.array(s.p_sol)


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _both(solver, **kw):
    return (JaxChannel(solver, **kw), ChannelScenario(solver, **kw))


BACKFLOW_KW = dict(dt=0.05, T=0.15, inlet_velocity=_parabolic, v_max=1.0)


@pytest.fixture(scope="module")
def backflow():
    return tuple(march(sc, 3) + (sc,) for sc in _both(
        "stabilized_schur_backflow", **BACKFLOW_KW))


def test_backflow_counts_and_state_match(backflow):
    (jc, ju, jp, _), (tc, tu, tp, _) = backflow
    assert tc == jc
    assert _rel(tu, ju) < TOL and _rel(tp, jp) < TOL


def test_backflow_outlet_flux_matches(backflow):
    (*_, jsc), (*_, tsc) = backflow
    assert [b["name"] for b in tsc.solver.form._facet_blocks] == [
        "backflow_out"]
    q_j = float(jsc.solver.form.facet_flux(jsc.solver.u_sol, "backflow_out"))
    q_t = float(tsc.solver.form.facet_flux(tsc.solver.u_sol, "backflow_out"))
    assert q_t > 0.05  # the flow leaves through the outlet
    assert abs(q_t - q_j) <= TOL * abs(q_j)
    assert tsc.solver.params()["beta_backflow"] == 0.2


def test_backflow_requires_v_max():
    with pytest.raises(ValueError, match="v_max is required"):
        ChannelScenario("stabilized_schur_backflow", dt=0.05, T=0.1,
                        inlet_velocity=_parabolic)


def test_ramping_scales_the_dirichlet_values():
    """Steps 1 and 2 impose 0.1 and 0.2 of the inlet profile, as cfdtpu."""
    jsc, tsc = _both("stabilized_schur_ramping", dt=0.05, T=0.1,
                     inlet_velocity=_parabolic)
    s = tsc.solver
    inlet = s.V.locate_dofs_geometrical(lambda x: np.isclose(x[0], 0.0))
    prof = _parabolic(s.V.dof_coords[inlet].T)[0]
    for step in (1, 2):
        for sc in (jsc, tsc):
            sc.solver.solveStep()
        u = s.u_sol.numpy()
        np.testing.assert_allclose(u[inlet, 0], step / 10 * prof,
                                   rtol=0, atol=1e-12)
        assert _rel(u, np.asarray(jsc.solver.u_sol)) < TOL
        assert s.last_stats["newton_iters"] == int(
            jsc.solver.last_stats["newton_iters"])
        for sc in (jsc, tsc):
            sc.solver.u_prev = sc.solver.u_sol
            sc.solver.p_prev = sc.solver.p_sol


ADAPTIVE_KW = dict(dt=0.2, T=1.0, inlet_velocity=_parabolic, snes_max_it=6,
                   snes_lag_jacobian=True, pc_lag_steps=4)


def test_adaptive_dt_sequence_matches_cfdtpu():
    """Under the lagged preconditioner: a failed attempt halves dt and
    rebuilds the carried operator at the new dt; every attempt's dt,
    counts and outcome are cfdtpu's, the reduced dt is kept, and the
    state after 3 steps matches."""
    runs = []
    for sc in _both("stabilized_schur_adaptive", **ADAPTIVE_KW):
        log = _attempts(sc)
        counts, u, p = march(sc, 3)
        runs.append((log, counts, u, p, float(sc.solver.dt)))
    (jl, jc, ju, jp, jdt), (tl, tc, tu, tp, tdt) = runs
    assert tl == jl
    assert any(not ok for *_, ok in tl)  # some attempts failed
    assert tc == jc and tdt == jdt < ADAPTIVE_KW["dt"]
    assert _rel(tu, ju) < TOL and _rel(tp, jp) < TOL


def test_adaptive_gives_up_as_cfdtpu():
    """snes_max_it 1: every attempt fails; six attempts (dt, dt/2, ...,
    dt/32), then the same RuntimeError."""
    logs = []
    for sc in _both("stabilized_schur_adaptive", dt=0.2, T=1.0,
                    inlet_velocity=_parabolic, snes_max_it=1):
        log = _attempts(sc)
        with pytest.raises(RuntimeError, match="after 5 dt halvings"):
            sc.solver.solveStep()
        logs.append(log)
    assert logs[0] == logs[1]
    assert [a[0] for a in logs[1]] == [0.2 / 2 ** k for k in range(6)]


class Hooked(TorchSolver):
    """The base solver with every hook recorded."""

    def __init__(self, *a, **kw):
        self.calls = []
        super().__init__(*a, **kw)

    def _setup_boundary_terms(self, facet_tags, tags):
        self.calls.append(("setup", dict(tags), hasattr(self, "_step")))

    def extra_params(self):
        return {"beta_test": 0.5}

    def _post_step(self):
        self.calls.append(("post", self.step_count,
                           self.u_sol is not self.u_prev))


def test_variant_hooks():
    sc = ChannelScenario("stabilized_schur", dt=0.05, T=0.1,
                         inlet_velocity=_parabolic)
    s = Hooked(sc.mesh, 0.05, 1.0, 0.05, (0.0, 0.0),
               initial_velocity=sc.initial_velocity, device="cpu")
    s.setup(sc.bcu, sc.bcp, facet_tags=sc.facet_tags, tags=sc.tags)
    # the tags as the scenario gives them, before the step is built
    assert s.calls == [("setup", {"inlet": 1, "outlet": 2, "wall": 3,
                                  "obstacle": None}, False)]
    prm = s.params()
    assert prm["beta_test"] == 0.5 and prm["dt"] == 0.05
    for _ in range(2):
        s.solveStep()
        s.u_prev, s.p_prev = s.u_sol, s.p_sol
    assert s.calls[1:] == [("post", 0, True), ("post", 1, True)]
    assert s.step_count == 2
