"""The stenosis family against cfdtpu (JAX), float64 on the CPU:

- StenosisSimulation (severe grade, 75 and 10 mmHg in mm-g-s units)
  at res 0.6 (2,571 DOF) under stabilized_schur_pressurebc, 2 steps
  through Scenario.solve: equal Newton and KSP counts a step, u and p
  within 1e-8 relative, the FFR of ffr.txt within 1e-10 relative, and
  what tests/test_hemodynamic.py asks (ffr.txt, finite u, mean u_x > 0).
  At res 1.0 (1,221 DOF) the outlet is a single facet whose two ends
  are wall nodes, so its velocity is held at 0, no flow starts
  (|u| < 3e-7) and the FFR is 1 in both packages: a comparison there
  would hold nothing but round-off;
- StenosisWithTree2DPressureSimulation at res 1.0 (2,451 DOF), one
  step: the local Reynolds field within 1e-8 relative;
- the CLI with --device cpu on stenosis and lid_driven2D.

Both sides run the same algorithm; only the order of floating-point
sums differs.

Run as a script, the file logs each linear solve (its iterations and
final residual) and each step's nonlinear residual of either scenario
at any size, through either package (JAX is imported only for cfdtpu),
e.g. the tree at its default res on the card:

    python tests/test_torch_stenosis_slice.py --package port \
        --scenario tree --res 0.15 --device cuda --snes_max_it 12
"""

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-8
FFR_TOL = 1e-10
STENOSIS = dict(dt=0.005, T=0.0075, res=0.6, output_every=10,
                dtype="float64")
TREE = dict(dt=0.005, T=0.0025, res=1.0, output_every=10, dtype="float64")


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def read_ffr(path):
    txt = open(os.path.join(path, "ffr.txt")).read()
    return float(re.search(r"FFR = p_distal / p_proximal: (\S+)",
                           txt).group(1)), txt


def solve(sc, out):
    counts = []

    def after(t):
        st = sc.solver.last_stats
        assert st["converged"]
        counts.append((int(st["newton_iters"]), int(st["ksp_iters"])))

    sc.solve(str(out), afterStepCallback=after)
    s = sc.solver
    return {"sc": sc, "counts": counts, "u": np.array(s.u_sol),
            "p": np.array(s.p_sol), "out": str(out)}


@pytest.fixture(scope="module")
def stenosis(tmp_path_factory):
    from cfdtpu.scenarios.stenosis import StenosisSimulation as J

    from cfdtpu_torch.scenarios.stenosis import StenosisSimulation as P

    tmp = tmp_path_factory.mktemp("stenosis")
    solver = "stabilized_schur_pressurebc"
    return {"jax": solve(J(solver, **STENOSIS), tmp / "jax"),
            "port": solve(P(solver, device="cpu", **STENOSIS),
                          tmp / "port")}


def test_stenosis_counts(stenosis):
    assert stenosis["port"]["counts"] == stenosis["jax"]["counts"]
    assert len(stenosis["port"]["counts"]) == 2


def test_stenosis_state(stenosis):
    p, j = stenosis["port"], stenosis["jax"]
    assert p["sc"].solver.V.num_global_dofs \
        + p["sc"].solver.Q.num_global_dofs == 2571
    assert not p["sc"].solver.pin_pressure
    assert np.isfinite(p["u"]).all()
    assert p["u"][:, 0].mean() > 0  # blood flows towards the outlet
    assert _rel(p["u"], j["u"]) < TOL
    assert _rel(p["p"], j["p"]) < TOL


def test_stenosis_ffr(stenosis):
    ffr, txt = read_ffr(stenosis["port"]["out"])
    ffr_j, _ = read_ffr(stenosis["jax"]["out"])
    assert "FFR" in txt and 0 < ffr < 1
    # ffr.txt holds 6 decimals: the port's _compute_ffr returns the
    # ratio, and cfdtpu's is taken at the same points by its probes
    from cfdtpu.postprocess import eval_at_points

    a = stenosis["port"]["sc"]._compute_ffr(stenosis["port"]["out"])
    j = stenosis["jax"]["sc"]
    o = j.mesh_options
    pts = np.array([[0.0, o["R_in"]], [o["L"], o["R_in"]]])
    p_prox, p_dist = eval_at_points(j.solver.Q, stenosis["jax"]["p"], pts)
    b = float(p_dist) / float(p_prox)
    assert abs(a - ffr) < 1e-6 and abs(b - ffr_j) < 1e-6
    assert abs(a - b) <= FFR_TOL * abs(b)


def test_tree_reynolds_field(tmp_path, monkeypatch):
    import cfdtpu.io
    from cfdtpu.scenarios.stenosis_with_tree_2d_pressure import (
        StenosisWithTree2DPressureSimulation as J)

    from cfdtpu_torch.scenarios.stenosis_with_tree_2d_pressure import (
        StenosisWithTree2DPressureSimulation as P)

    # cfdtpu keeps no copy of the field: take it where it is written
    written = {}
    real_write = cfdtpu.io.VTUSeriesWriter.write

    def keep(self, t, field):
        if self.name == "reynolds":
            written["jax"] = np.array(field)
        return real_write(self, t, field)

    monkeypatch.setattr(cfdtpu.io.VTUSeriesWriter, "write", keep)
    solver = "stabilized_schur_pressurebc"
    port = solve(P(solver, device="cpu", **TREE), tmp_path / "port")
    jax = solve(J(solver, **TREE), tmp_path / "jax")
    assert port["counts"] == jax["counts"] and len(port["counts"]) == 1
    for name in ("reynolds_000000.vtu", "reynolds.pvd", "ffr.txt"):
        assert os.path.exists(tmp_path / "port" / name), name
    s = port["sc"].solver
    assert s.V.num_global_dofs + s.Q.num_global_dofs == 2451
    re_p = port["sc"].reynolds
    assert re_p.shape == (s.V.dof_coords.shape[0],)
    assert np.isfinite(re_p).all() and re_p.max() > 0
    assert _rel(re_p, written["jax"]) < TOL
    assert _rel(port["u"], jax["u"]) < TOL


@pytest.mark.parametrize("simulation, solver, flags", [
    ("stenosis", "stabilized_schur_pressurebc",
     ["--res", "0.6", "--T", "0.005", "--dt", "0.005"]),
    ("lid_driven2D", "stabilized_schur_bdf2",
     ["--nx", "6", "--mu", "0.01", "--T", "0.02", "--dt", "0.01"]),
])
def test_cli_on_the_cpu(tmp_path, simulation, solver, flags):
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "cfdtpu_torch", "simulate",
           "--simulation", simulation, "--solver", solver, *flags,
           "--device", "cpu", "--output_dir", str(out)]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "'device': 'cpu'" in res.stdout
    runs = glob.glob(str(out / simulation / "*"))
    assert len(runs) == 1
    want = {"stenosis": "ffr.txt", "lid_driven2D": "benchmark_100.csv"}
    for name in ("simulation_params.txt", "norms.txt", "v.pvd",
                 want[simulation]):
        assert os.path.exists(os.path.join(runs[0], name)), name
    if simulation == "stenosis":
        ffr, _ = read_ffr(runs[0])
        assert 0 < ffr < 1


SCENARIOS = {"stenosis": ("stenosis", "StenosisSimulation"),
             "tree": ("stenosis_with_tree_2d_pressure",
                      "StenosisWithTree2DPressureSimulation")}


def solve_log(package, scenario, solver, steps, device="cpu", **kw):
    """`scenario` under `solver` through `package`: per step, the
    (iterations, final residual) of each linear solve and the step's
    stats; the error of a step that did not converge ends the log."""
    import importlib

    solves = []
    if package == "cfdtpu":
        import jax

        import cfdtpu.la.newton as nt

        def record(x, info):
            jax.debug.callback(lambda i, r: solves.append((int(i), float(r))),
                               info["iters"], info["resnorm"])
            return x, info
    else:
        import cfdtpu_torch.la.newton as nt

        def record(x, info):
            solves.append((int(info["iters"]), float(info["resnorm"])))
            return x, info
        kw["device"] = device
    module, name = SCENARIOS[scenario]
    cls = getattr(importlib.import_module(
        f"{'cfdtpu' if package == 'cfdtpu' else 'cfdtpu_torch'}.scenarios."
        f"{module}"), name)
    fgmres = nt.fgmres
    nt.fgmres = lambda *a, **k: record(*fgmres(*a, **k))
    log, error = [], None
    try:
        s = cls(solver, T=1.0, output_every=100, **kw).solver
        for _ in range(steps):
            n0 = len(solves)
            t0 = time.perf_counter()
            try:
                s.solveStep()
            except RuntimeError as e:
                error = str(e)
            log.append((solves[n0:], s.last_stats, time.perf_counter() - t0))
            if error or not s.last_stats.get("converged", True):
                break
            s.u_prev, s.p_prev = s.u_sol, s.p_sol
    finally:
        nt.fgmres = fgmres
    return log, error


def main(argv=None):
    ap = argparse.ArgumentParser(description="each linear solve of the "
                                 "stenosis scenarios")
    ap.add_argument("--package", choices=["cfdtpu", "port"], required=True)
    ap.add_argument("--scenario", choices=list(SCENARIOS), default="tree")
    ap.add_argument("--solver", default="stabilized_schur_pressurebc")
    ap.add_argument("--res", type=float, required=True)
    ap.add_argument("--dt", type=float, default=0.005)
    ap.add_argument("--dtype", default="float64")
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--snes_max_it", type=int, default=100)
    ap.add_argument("--device", default="cpu", help="the port's device")
    ap.add_argument("--kw", default="{}", type=json.loads,
                    help="more scenario and solver options, JSON")
    args = ap.parse_args(argv)
    log, error = solve_log(args.package, args.scenario, args.solver,
                           args.steps, device=args.device, res=args.res,
                           dt=args.dt, dtype=args.dtype,
                           snes_max_it=args.snes_max_it, **args.kw)
    for k, (step, stats, wall) in enumerate(log, 1):
        print(f"{args.package} {args.scenario} {args.solver} res {args.res} "
              f"dt {args.dt} {args.dtype} {args.kw} step {k}: {len(step)} "
              f"solves, iterations {[i for i, _ in step]}, final residuals "
              f"{[float(f'{r:.4e}') for _, r in step]}; Newton/KSP "
              f"{stats.get('newton_iters')}/{stats.get('ksp_iters')}, "
              f"fnorm {float(stats.get('fnorm', np.nan)):.4e} of f0norm "
              f"{float(stats.get('f0norm', np.nan)):.4e}, converged "
              f"{stats.get('converged')} ({wall:.1f} s)", flush=True)
    print(f"{'error: ' + error if error else 'done'}", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
