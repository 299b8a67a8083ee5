"""The AMG cycle options end to end against cfdtpu (JAX): DFG 2D-1,
float64, 2 steps from rest, rasamg_sup with bench.py's settings
(pc_inner_u=0, pc_inner_p=5, RAS windows of 32 with overlap 4, chord
Newton, pc_lag_steps=4, ksp_restart=20, dt=0.05) plus the W-cycle and
Chebyshev smoothing of degree 2 on both hierarchies, and plus the
K-cycle. res_scale 1.5 (4,461 DOF): each hierarchy has one level below
the finest here, so what the options change is the Chebyshev smoothing
of the SELFP AMG's finest level (the BlockAMG's is RAS) and the flags'
way from the solver to both hierarchies; the cycles at three levels
are tests/test_torch_cycles.py's and tests/test_torch_block_cycles.py's.

Tolerance: both sides are float64 running the same algorithm; only the
order of floating-point sums differs. Iteration counts must be equal
per step, and u, p, c_D, c_L and dp agree to 1e-8 relative.
"""

import numpy as np
import pytest
import torch

from cfdtpu.scenarios.dfg_1 import DFG1Benchmark as JaxDFG

from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark as TorchDFG

torch.set_num_threads(1)

BENCH = dict(dt=0.05, T=1.0, res_scale=1.5, dtype="float64",
             pc_inner_method="rasamg_sup", pc_inner_u=0, pc_inner_p=5,
             pc_ras_size=32, snes_lag_jacobian=True, pc_lag_steps=4,
             stats_every=1, ksp_restart=20)
CONFIGS = {
    "rasamg_sup W + cheby2": dict(BENCH, pc_amg_wcycle=True,
                                  pc_amg_cheby=2),
    "rasamg_sup K": dict(BENCH, pc_amg_kcycle=True),
}


def march(sc, steps):
    """Advance `steps` checked steps; returns the counts per step, the
    state and c_D, c_L (line integral) and dp."""
    s = sc.solver
    counts = []
    for _ in range(steps):
        s.solveStep()
        assert s.last_stats["converged"]
        counts.append((int(s.last_stats["newton_iters"]),
                       int(s.last_stats["ksp_iters"])))
        s.u_prev, s.p_prev = s.u_sol, s.p_sol
    fd, fl = sc.compute_drag_lift()
    return {"counts": counts, "u": np.array(s.u_sol),
            "p": np.array(s.p_sol),
            "funcs": np.array([500 * fd, 500 * fl,
                               sc.compute_pressure_diff()])}


def check_slice(kw, steps=2):
    """The same steps in both packages: equal counts per step, 1e-8."""
    ref = march(JaxDFG("stabilized_schur", **kw), steps)
    got = march(TorchDFG("stabilized_schur", device="cpu", **kw), steps)
    assert got["counts"] == ref["counts"]
    for key in ("u", "p"):
        assert np.isfinite(got[key]).all()
        assert (np.linalg.norm(got[key] - ref[key])
                <= 1e-8 * np.linalg.norm(ref[key])), key
    assert np.allclose(got["funcs"], ref["funcs"], rtol=1e-8, atol=0.0)
    return got["counts"]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cycle_slice_matches_cfdtpu(name):
    check_slice(CONFIGS[name])
