"""The DFG 2D-1 steady benchmark end to end against cfdtpu (JAX): the
DFG2D1Steady scenario with the dfg_2d_1 solver (no natural correction;
the viscous traction (K12) and the backflow stabilisation (K13) on the
outlet, two blocks on the same facets; Newton rtol 1e-10, atol 1e-12,
stol 1e-12, max_it 50; no pressure condition, and no pressure
nullspace) at res 0.02 (2,058 DOF), float64, bench.py's Schur settings
(rasamg_sup, chord Newton, pc_lag_steps 4), 3 steps from rest, in both
packages; the solver's ValueError without an `obstacle` tag; and the
CLI on the CPU.

Tolerance: both sides are float64 running the same algorithm; only the
order of floating-point sums differs. Newton and KSP counts per step
must be equal; u, p, c_D and c_L (the traction force the solver prints
every step) agree to 1e-8 relative.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cfdtpu.scenarios.dfg_2d_1 import DFG2D1Steady as JaxDFG2
from cfdtpu.solvers.dfg_2d_1 import Solver as JaxSolver

from cfdtpu_torch.scenarios.dfg_2d_1 import DFG2D1Steady as TorchDFG2
from cfdtpu_torch.solvers.dfg_2d_1 import Solver as TorchSolver

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-8
KW = dict(dt=0.05, T=1.0, res=0.02, dtype="float64",
          pc_inner_method="rasamg_sup", pc_inner_u=0, pc_inner_p=5,
          pc_ras_size=32, snes_lag_jacobian=True, pc_lag_steps=4,
          stats_every=1, ksp_restart=20)
# cfdtpu's counts at this size (float64, the CPU)
COUNTS = [(18, 55), (35, 108), (45, 138)]


def march(sc, steps):
    s = sc.solver
    counts, forces = [], []
    for _ in range(steps):
        s.solveStep()
        assert s.last_stats["converged"]
        counts.append((int(s.last_stats["newton_iters"]),
                       int(s.last_stats["ksp_iters"])))
        forces.append((s.cd, s.cl))
        s.u_prev, s.p_prev = s.u_sol, s.p_sol
    return {"counts": counts, "forces": np.array(forces),
            "u": np.array(s.u_sol), "p": np.array(s.p_sol),
            "pin": s.pin_pressure, "prm": s.params(),
            "newton": s.newton_params}


@pytest.fixture(scope="module")
def runs():
    return {"jax": march(JaxDFG2("dfg_2d_1", **KW), 3),
            "port": march(TorchDFG2("dfg_2d_1", device="cpu", **KW), 3)}


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def test_dfg2d1_counts_equal(runs):
    assert runs["port"]["counts"] == runs["jax"]["counts"] == COUNTS


def test_dfg2d1_state_matches(runs):
    for key in ("u", "p"):
        assert np.isfinite(runs["port"][key]).all()
        assert _rel(runs["port"][key], runs["jax"][key]) < TOL, key


def test_dfg2d1_drag_and_lift_match(runs):
    """c_D and c_L of every step, as the solver prints them."""
    np.testing.assert_allclose(runs["port"]["forces"], runs["jax"]["forces"],
                               rtol=TOL, atol=0)
    assert np.isfinite(runs["port"]["forces"]).all()


def test_dfg2d1_settings_as_cfdtpu(runs):
    """No pressure pinned (the numeric nullspace test finds none), the
    Newton tolerances, beta_backflow in prm."""
    p, j = runs["port"], runs["jax"]
    assert p["pin"] is False and bool(j["pin"]) is False
    for key in ("rtol", "atol", "stol", "max_it"):
        assert getattr(p["newton"], key) == getattr(j["newton"], key), key
    assert (p["newton"].rtol, p["newton"].atol, p["newton"].stol,
            p["newton"].max_it) == (1e-10, 1e-12, 1e-12, 50)
    assert p["prm"]["beta_backflow"] == float(j["prm"]["beta_backflow"])


@pytest.mark.parametrize("tags", [None, {"outlet": 3, "obstacle": None}])
def test_dfg2d1_needs_an_obstacle_tag(tags):
    """Both packages raise the same ValueError before building anything."""
    sc = TorchDFG2("stabilized_schur", device="cpu", dt=0.05, T=1.0,
                   res=0.04, dtype="float64")
    solvers = (TorchSolver(sc.mesh, 0.05, 1.0, 1e-3, (0.0, 0.0),
                           device="cpu"),
               JaxSolver(sc.mesh, 0.05, 1.0, 1e-3, (0.0, 0.0)))
    for s in solvers:
        with pytest.raises(ValueError, match="'obstacle' tag is required"):
            s.setup(sc.bcu, sc.bcp, facet_tags=None, tags=tags)


def test_dfg2d1_cli_on_the_cpu(tmp_path):
    """`python -m cfdtpu_torch simulate --simulation dfg_2d_1 --solver
    dfg_2d_1 ... --device cpu`: exit 0, the DFG Metrics line per step."""
    cmd = [sys.executable, "-m", "cfdtpu_torch", "simulate",
           "--simulation", "dfg_2d_1", "--solver", "dfg_2d_1",
           "--T", "0.1", "--dt", "0.05", "--name", "cli", "--res", "0.04",
           "--dtype", "float64", "--device", "cpu",
           "--output_dir", str(tmp_path)]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [ln for ln in res.stdout.splitlines() if "DFG Metrics:" in ln]
    assert len(lines) == 2, res.stdout
    assert "Simulation completed" in res.stdout
