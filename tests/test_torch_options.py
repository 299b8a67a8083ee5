"""cfdtpu_torch solver options off the slice's settings, against cfdtpu:
the CLI defaults (operator and PC rebuilt per Newton iteration under
snes_lag_preconditioner: the non-reuse `step` path), Eisenstat-Walker
forcing, the extrapolating predictor with the lower-triangular Schur
factorisation, a stats_every window, and ksp_ortho_chunk. DFG 2D-1 at
res_scale 2.5 (1,626 DOF), float64, 2 steps each.

Tolerance: both sides are float64 running the same algorithm; only the
order of floating-point sums differs. Iteration counts must be equal and
the state agree to 1e-8 relative.
"""

import numpy as np
import pytest
import torch

from cfdtpu.scenarios.dfg_1 import DFG1Benchmark as JaxDFG

from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark as TorchDFG

torch.set_num_threads(1)

BASE = dict(dt=0.05, T=1.0, res_scale=2.5, dtype="float64")
OPTIONS = {
    "cli_defaults": {},
    "eisenstat_walker": {"snes_ksp_ew": True},
    "extrapolate_lower": {"predictor": "extrapolate",
                          "pc_schur_fact": "lower"},
    "amg_pairwise_smooth2": {"pc_amg_pairwise": True, "pc_amg_smooth": 2,
                             "res_scale": 1.5},
    "stats_window": {"stats_every": 2, "pc_lag_steps": 2,
                     "snes_lag_jacobian": True},
    # cfdtpu's chunked Gram-Schmidt sweeps (tests/test_gmres_ortho_chunk.py)
    # against the port's, which always sweep the active rows
    "ksp_ortho_chunk": {"ksp_ortho_chunk": 8},
}


def march(sc, steps):
    s = sc.solver
    counts = []
    for _ in range(steps):
        s.solveStep()
        st = s.last_stats
        counts.append((int(st["newton_iters"]), int(st["ksp_iters"])))
        s.u_prev, s.p_prev = s.u_sol, s.p_sol
    return counts, np.array(s.u_sol), np.array(s.p_sol)


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_option_matches_cfdtpu(name):
    kw = dict(BASE, **OPTIONS[name])
    jsc = JaxDFG("stabilized_schur", **kw)
    tsc = TorchDFG("stabilized_schur", device="cpu", **kw)
    if name == "stats_window":
        # a skipped step reports {"skipped": True}: compare the checked
        # step
        js, ts = jsc.solver, tsc.solver
        for _ in range(2):
            js.solveStep()
            ts.solveStep()
            js.u_prev, js.p_prev = js.u_sol, js.p_sol
            ts.u_prev, ts.p_prev = ts.u_sol, ts.p_sol
        assert js.last_stats["newton_iters"] == ts.last_stats["newton_iters"]
        assert js.last_stats["ksp_iters"] == ts.last_stats["ksp_iters"]
        assert ts.last_stats["converged"]
        ju, tu = np.array(js.u_sol), ts.u_sol.numpy()
        jp, tp = np.array(js.p_sol), ts.p_sol.numpy()
    else:
        jc, ju, jp = march(jsc, 2)
        tc, tu, tp = march(tsc, 2)
        assert tc == jc
    assert np.linalg.norm(tu - ju) <= 1e-8 * np.linalg.norm(ju)
    assert np.linalg.norm(tp - jp) <= 1e-8 * np.linalg.norm(jp)


def test_checkpoint_and_resume(tmp_path):
    """Scenario.solve with checkpoint_every writes cfdtpu's npz format;
    resume_from continues from it, step counter included."""
    kw = dict(BASE, dt=0.05)
    sc = TorchDFG("stabilized_schur", device="cpu", checkpoint_every=1,
                  **dict(kw, T=0.05))
    sc.solve(str(tmp_path / "a"))
    ckpt = tmp_path / "a" / "checkpoint.npz"
    with np.load(ckpt) as z:
        assert int(z["step"]) == 1 and set(z.files) >= {
            "u_sol", "p_sol", "u_prev", "p_prev", "t", "step"}
        u1 = z["u_sol"]
    rs = TorchDFG("stabilized_schur", device="cpu", resume_from=str(ckpt),
                  **dict(kw, T=0.1))
    rs.solve(str(tmp_path / "b"))
    assert rs.solver.step_count == 2
    assert np.isfinite(rs.solver.u_sol.numpy()).all()
    assert not np.allclose(rs.solver.u_sol.numpy(), u1)
    with open(tmp_path / "b" / "solver_stats.txt") as f:
        assert f.read().splitlines()[-1].split()[0] == "2"
