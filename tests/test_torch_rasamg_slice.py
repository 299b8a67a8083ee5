"""The rasamg_sup slice end to end against cfdtpu (JAX): DFG 2D-1,
float64, the settings bench.py runs (bench.py:64-74: Schur fieldsplit
with rasamg_sup, pc_inner_u=0 (a preonly block-AMG V-cycle with a RAS
fine smoother on A_uu), pc_inner_p=5 sweeps of the near-true Schur
operator, RAS windows of 32 nodes with overlap 4, chord Newton,
pc_lag_steps=4, ksp_restart=20, dt=0.05) with stats_every=1 so every
step is checked; and the same configuration through the CLI.

The mesh is res_scale 1.5 (4,461 DOF), where cfdtpu takes (12 Newton,
51 KSP) and (25, 108) iterations over the first two steps.

Tolerance: both sides are float64 running the same algorithm; only the
order of floating-point sums differs. Iteration counts must be equal,
and state and functionals agree to 1e-8 relative after the Newton
tolerance (snes_rtol 1e-8) has compounded the ~1e-15 per-operation
differences over the steps.
"""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cfdtpu.scenarios.dfg_1 import DFG1Benchmark as JaxDFG

from cfdtpu_torch.__main__ import parse_unknown_args
from cfdtpu_torch.io.state import load_reference_checkpoint
from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark as TorchDFG

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-8
KW = dict(dt=0.05, T=1.0, res_scale=1.5, dtype="float64",
          pc_inner_method="rasamg_sup", pc_inner_u=0, pc_inner_p=5,
          pc_ras_size=32, snes_lag_jacobian=True, pc_lag_steps=4,
          stats_every=1, ksp_restart=20)
CLI_FLAGS = ["--pc_inner_method", "rasamg_sup", "--pc_inner_u", "0",
             "--pc_inner_p", "5", "--pc_ras_size", "32", "--pc_lag_steps",
             "4", "--snes_lag_jacobian", "True", "--ksp_restart", "20"]


def march(sc, steps):
    """Advance `steps` checked steps; returns [(newton, ksp)] and the
    state and functionals as numpy / floats."""
    s = sc.solver
    counts = []
    for _ in range(steps):
        s.solveStep()
        assert s.last_stats["converged"]
        counts.append((int(s.last_stats["newton_iters"]),
                       int(s.last_stats["ksp_iters"])))
        s.u_prev, s.p_prev = s.u_sol, s.p_sol
    fl = sc.compute_drag_lift()
    fr = sc.compute_drag_lift(method="reaction")
    return {
        "counts": counts,
        "u": np.array(s.u_sol), "p": np.array(s.p_sol),
        "funcs": np.array([500 * fl[0], 500 * fl[1], 500 * fr[0],
                           500 * fr[1], sc.compute_pressure_diff()]),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "checkpoint.npz")
    jsc = JaxDFG("stabilized_schur", **KW)
    jax2 = march(jsc, 2)
    jsc.save_checkpoint(ckpt, 2 * KW["dt"], 2)
    # resume in a fresh scenario: the carried operator/PC state is not
    # part of a checkpoint, so both packages rebuild it at the loaded
    # state
    jsc_r = JaxDFG("stabilized_schur", **KW)
    jsc_r.load_checkpoint(ckpt)
    jax_r = march(jsc_r, 1)

    tsc = TorchDFG("stabilized_schur", device="cpu", **KW)
    port2 = march(tsc, 2)
    tsc_r = TorchDFG("stabilized_schur", device="cpu", **KW)
    t, step = load_reference_checkpoint(ckpt, tsc_r)
    assert step == 2 and abs(t - 0.1) < 1e-12
    port_r = march(tsc_r, 1)
    return {"jax": jax2, "port": port2, "jax_r": jax_r, "port_r": port_r}


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _legs(leg):
    return ("jax", "port") if leg == "from_rest" else ("jax_r", "port_r")


@pytest.mark.parametrize("leg", ["from_rest", "from_jax_checkpoint"])
def test_rasamg_iteration_counts_equal(runs, leg):
    j, p = _legs(leg)
    assert runs[p]["counts"] == runs[j]["counts"]
    if leg == "from_rest":  # the counts cfdtpu gives at this size
        assert runs[p]["counts"] == [(12, 51), (25, 108)]


@pytest.mark.parametrize("leg", ["from_rest", "from_jax_checkpoint"])
def test_rasamg_state_matches(runs, leg):
    j, p = _legs(leg)
    assert np.isfinite(runs[p]["u"]).all() and np.isfinite(
        runs[p]["p"]).all()
    assert _rel(runs[p]["u"], runs[j]["u"]) < TOL
    assert _rel(runs[p]["p"], runs[j]["p"]) < TOL


@pytest.mark.parametrize("leg", ["from_rest", "from_jax_checkpoint"])
def test_rasamg_functionals_match(runs, leg):
    """c_D, c_L (line and reaction) and the pressure difference."""
    j, p = _legs(leg)
    np.testing.assert_allclose(runs[p]["funcs"], runs[j]["funcs"],
                               rtol=TOL, atol=0)


def test_cli_flags_reach_the_solver():
    """The freeform CLI flags become solver options: the RAS window size
    and the preonly u-stage are taken, not swallowed by **kwargs."""
    kw = parse_unknown_args(CLI_FLAGS)
    sc = TorchDFG("stabilized_schur", dt=0.05, T=0.05, res_scale=2.5,
                  device="cpu", **kw)
    s = sc.solver
    assert (s.pc_inner_method, s.pc_inner_u, s.pc_inner_p) == (
        "rasamg_sup", 0, 5)
    assert (s.pc_ras_size, s.pc_ras_overlap) == (32, 4)
    nb = s._nodebsr
    ras = nb.uu_ras(32, 4)
    assert nb._uu_ras_key == (32, 4) and ras.s == 32
    assert nb.uu_amg(fine_smoother=ras).fine_smoother is ras


def test_cli_rasamg_sup_writes_outputs(tmp_path):
    """`python -m cfdtpu_torch simulate ... --pc_inner_method rasamg_sup
    ... --device cpu` end to end."""
    cmd = [sys.executable, "-m", "cfdtpu_torch", "simulate",
           "--simulation", "dfg_1", "--solver", "stabilized_schur",
           "--T", "0.05", "--dt", "0.05", "--name", "cli",
           "--res_scale", "2.5", "--device", "cpu",
           "--output_dir", str(tmp_path), *CLI_FLAGS]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "Simulation completed" in res.stdout
    (run_dir,) = glob.glob(str(tmp_path / "dfg_1" / "*_cli"))
    for name in ("simulation_params.txt", "norms.txt", "v.pvd",
                 "drag_lift.txt", "pressure_diff.txt", "solver_stats.txt"):
        assert os.path.exists(os.path.join(run_dir, name)), name
    with open(os.path.join(run_dir, "simulation_params.txt")) as f:
        params = f.read()
    assert "pc_inner_method: rasamg_sup" in params
    assert "pc_ras_size: 32" in params
