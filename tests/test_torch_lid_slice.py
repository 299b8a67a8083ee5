"""The lid-driven cavity and the channel scenarios against cfdtpu (JAX),
float64 on the CPU:

- LidDriven2DSimulation under stabilized_schur_bdf2 at nx 8, mu 0.01,
  dt 0.01, 3 steps through Scenario.solve (cfdtpu's test_bdf2_lid
  settings): equal Newton and KSP counts a step, u and p within 1e-8
  relative, and benchmark_100.csv written by both with the same
  centerline;
- scripts/validate_ghia.py's run(100, nx=8, n_steps=3) against
  cfdtpu_torch.scripts.validate_ghia's: the deviation from Ghia's
  profile within 1e-8 relative;
- UnitSquarePipeSimulation (quadrilaterals, Dirichlet pressures) at
  nx 24, ny 3 under stabilized_schur, 2 steps: counts, and the wall
  shear stress within 1e-8 relative.

Both sides are float64 running the same algorithm; only the order of
floating-point sums differs.
"""

import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-8
LID = dict(dt=0.01, T=0.03, mu=0.01, nx=8)
PIPE = dict(dt=0.05, T=0.1, p_inlet=7.47, p_outlet=0.0, nx=24, ny=3)


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def solve(sc, out):
    """Scenario.solve with each step's (Newton, KSP) counts."""
    counts = []

    def after(t):
        st = sc.solver.last_stats
        assert st["converged"]
        counts.append((int(st["newton_iters"]), int(st["ksp_iters"])))

    sc.solve(str(out), afterStepCallback=after)
    s = sc.solver
    return {"counts": counts, "u": np.array(s.u_sol), "p": np.array(s.p_sol),
            "wss": np.array(s.shear_stress), "out": str(out)}


@pytest.fixture(scope="module")
def lid(tmp_path_factory):
    from cfdtpu.scenarios.lid_driven2D import LidDriven2DSimulation as J

    from cfdtpu_torch.scenarios.lid_driven2D import (
        LidDriven2DSimulation as P)

    tmp = tmp_path_factory.mktemp("lid")
    return {"jax": solve(J("stabilized_schur_bdf2", **LID), tmp / "jax"),
            "port": solve(P("stabilized_schur_bdf2", device="cpu", **LID),
                          tmp / "port")}


def test_lid_bdf2_counts(lid):
    assert lid["port"]["counts"] == lid["jax"]["counts"]
    assert len(lid["port"]["counts"]) == 3


def test_lid_bdf2_state(lid):
    u = lid["port"]["u"]
    assert np.abs(u).max() <= 1.0 + 1e-8 and np.abs(u).max() > 0.5
    assert _rel(u, lid["jax"]["u"]) < TOL
    assert _rel(lid["port"]["p"], lid["jax"]["p"]) < TOL


def test_lid_benchmark_csv(lid):
    """save_benchmark_plot writes benchmark_100.csv (Re = 1/mu): y, the
    centerline u and Ghia's u at the 17 published points."""
    from cfdtpu_torch.validation import GHIA_U_CENTERLINE

    a, b = (np.loadtxt(os.path.join(lid[k]["out"], "benchmark_100.csv"),
                       delimiter=",", skiprows=1) for k in ("port", "jax"))
    y, u_ghia = GHIA_U_CENTERLINE[100]
    assert a.shape == (17, 3)
    np.testing.assert_array_equal(a[:, 0], y)
    np.testing.assert_array_equal(a[:, 2], u_ghia)
    assert _rel(a[:, 1], b[:, 1]) < TOL


def test_lid_png_skipped_without_matplotlib(tmp_path, monkeypatch):
    """Without matplotlib the CSV is written and only the PNG skipped."""
    import builtins

    from cfdtpu_torch.scenarios.lid_driven2D import LidDriven2DSimulation

    real = builtins.__import__

    def no_mpl(name, *a, **k):
        if name.split(".")[0] == "matplotlib":
            raise ImportError(name)
        return real(name, *a, **k)

    sc = LidDriven2DSimulation("stabilized_schur_bdf2", device="cpu", dt=0.01,
                               T=0.01, mu=0.01, nx=4)
    sc.solver.solveStep()
    monkeypatch.setattr(builtins, "__import__", no_mpl)
    sc.save_benchmark_plot(str(tmp_path))
    assert os.listdir(tmp_path) == ["benchmark_100.csv"]


def test_validate_ghia_matches_cfdtpu():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        from validate_ghia import run as jax_run
    finally:
        sys.path.pop(0)
    from cfdtpu_torch.scripts.validate_ghia import run, solve_case

    res = solve_case(100, nx=8, n_steps=3, quiet=True, device="cpu")
    assert res["steps"] == 3 and len(res["counts"]) == 3
    assert res["max_err"] == run(100, nx=8, n_steps=3, quiet=True,
                                 device="cpu")
    err = jax_run(100, nx=8, n_steps=3, quiet=True)
    assert abs(res["max_err"] - err) <= TOL * err


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    from cfdtpu.scenarios.unit_square_pipe import (
        UnitSquarePipeSimulation as J)

    from cfdtpu_torch.scenarios.unit_square_pipe import (
        UnitSquarePipeSimulation as P)

    tmp = tmp_path_factory.mktemp("pipe")
    return {"jax": solve(J("stabilized_schur", **PIPE), tmp / "jax"),
            "port": solve(P("stabilized_schur", device="cpu", **PIPE),
                          tmp / "port")}


def test_unit_square_pipe_matches_cfdtpu(pipe):
    p, j = pipe["port"], pipe["jax"]
    assert p["counts"] == j["counts"] and len(p["counts"]) == 2
    assert np.abs(p["u"]).max() > 1e-3
    assert np.isfinite(p["wss"]).all() and np.abs(p["wss"]).max() > 0
    assert _rel(p["wss"], j["wss"]) < TOL
    assert _rel(p["u"], j["u"]) < TOL
