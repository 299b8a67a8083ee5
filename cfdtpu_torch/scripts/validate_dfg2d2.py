"""DFG 2D-2 (unsteady, Re = 100) validation campaign.

The counterpart of scripts/validate_dfg2d2.py: runs the
pipe_cylinder_2d2 scenario until the vortex shedding is developed,
then compares c_Dmax, c_Lmax and the Strouhal number over the last 3
shedding periods with the FEATFLOW lv4 series and the published
intervals (validation/dfg.py).

    python -m cfdtpu_torch.scripts.validate_dfg2d2 [res_scale] [T] [dt] \\
        [--device cpu]

Defaults: res_scale 0.5, T 12, dt 0.0025. The run checkpoints every 200
steps into results_dfg2d2_<res_scale>/ (under the working directory)
and resumes from that checkpoint when it finds one; the force series
is flushed as it goes (bdforces_partial.txt), so an interrupted
campaign loses at most 64 steps of it. DFG2D2_KW='{"key": value}'
overrides or extends the solver options. The exit code is non-zero
until the march reaches T. It runs on the CUDA card (float32) unless
--device cpu is given (float64).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# the transient settings: the shedding march moves little per step at
# dt ~ 0.0025, so the operator and the preconditioner are kept for 4
# steps and the solver's counts are read every 5
DFG2D2_KW = {
    "pc_inner_method": "rasamg_sup", "pc_inner_u": 0,
    "pc_inner_p": 3, "pc_ras_size": 32,
    "snes_lag_jacobian": True, "pc_lag_steps": 4, "stats_every": 5,
    "checkpoint_every": 200,
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("res_scale", nargs="?", type=float, default=0.5)
    ap.add_argument("T", nargs="?", type=float, default=12.0)
    ap.add_argument("dt", nargs="?", type=float, default=0.0025)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    res_scale, T, dt = args.res_scale, args.T, args.dt

    from cfdtpu_torch.scenarios.pipe_cylinder import (
        PipeCylinder2D2Simulation)
    from cfdtpu_torch.validation.dfg import (
        DFG_2D2_INTERVALS, dfg_2d2_series_stats, featflow_reference_stats)

    kw = dict(DFG2D2_KW)
    kw.update(json.loads(os.environ.get("DFG2D2_KW", "{}")))
    out = f"results_dfg2d2_{res_scale}"
    ckpt = os.path.join(out, "checkpoint.npz")
    if os.path.exists(ckpt):
        kw["resume_from"] = ckpt
    sc = PipeCylinder2D2Simulation(
        "stabilized_schur", dt=dt, T=T, res_scale=res_scale,
        device=args.device, **kw,
    )
    complete = True
    t0 = time.perf_counter()
    try:
        sc.solve(out)
    except Exception as e:  # noqa: BLE001 — report the partial series
        complete = False
        print(f"[validate_dfg2d2] solve raised {type(e).__name__}: {e}; "
              "reporting the flushed partial series")
    wall = time.perf_counter() - t0

    src = os.path.join(out, "bdforces.txt")
    if not complete or not os.path.exists(src):
        src = os.path.join(out, "bdforces_partial.txt")
    rows = np.loadtxt(src, ndmin=2)
    if rows.size == 0:
        print("[validate_dfg2d2] no force rows flushed yet")
        return 1
    t, cd, cl = rows[:, 1], rows[:, 2], rows[:, 3]
    t_end = float(t[-1])
    complete = complete and t_end >= T - 2 * dt
    stats = dfg_2d2_series_stats(t, cd, cl, n_periods=3)
    print(f"computed:  cd_max={stats['cd_max']:.4f} "
          f"cl_max={stats['cl_max']:.4f} St={stats['strouhal']:.4f} "
          f"(t_end={t_end:.3f}, complete={complete})")
    ref = featflow_reference_stats(4, 3)
    print(f"featflow:  cd_max={ref['cd_max']:.4f} "
          f"cl_max={ref['cl_max']:.4f} St={ref['strouhal']:.4f}")
    print(f"published: {DFG_2D2_INTERVALS}")
    print(f"series in {src}; {rows.shape[0]} rows, march wall time "
          f"{wall:.1f} s")
    return 0 if complete else 1


if __name__ == "__main__":
    sys.exit(main())
