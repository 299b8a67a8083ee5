"""Ghia lid-driven-cavity validation at Re = 100 / 400 / 1000.

The counterpart of scripts/validate_ghia.py: marches the cavity to a
steady state with stabilized_schur_bdf2 (BDF2 pseudo-time steps, the
solver's default options) and compares the vertical-centerline u(y)
profile with Ghia, Ghia & Shin (1982), Table I (validation/ghia.py).
Prints one line per Re with the largest and the rms deviation at the
17 published points.

    python -m cfdtpu_torch.scripts.validate_ghia [Re ...] [--device cpu]
        [--dtype float64] [--kw '{"pc_inner_method": "rasamg_sup"}']

Re defaults to 100 400 1000, each at its CASES grid and march; the run
stops early once a step changes u by less than 1e-6 relative. It runs
on the CUDA card unless --device cpu is given, in float32 on the card
and float64 on the CPU unless --dtype says otherwise; --kw adds solver
options (a JSON object) to the solver's defaults.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

CASES = {
    # Re: (nx, dt, n_steps)  -- dt in convective units, BDF2 march
    100: (64, 0.5, 40),
    400: (96, 0.5, 80),
    1000: (128, 0.5, 160),
}


def solve_case(re, nx=None, dt=None, n_steps=None, quiet=False,
               device=None, dtype="auto", on_step=None, **solver_kw):
    """March case `re` and compare with Ghia's profile. Returns a dict:
    the scenario, max_err and rms_err, the centerline u, the steps run,
    each step's (Newton, KSP) counts and the wall time of the march.
    on_step(i), if given, is called after step i; solver_kw go to the
    solver."""
    from cfdtpu_torch.scenarios.base import to_numpy
    from cfdtpu_torch.scenarios.lid_driven2D import LidDriven2DSimulation
    from cfdtpu_torch.validation import GHIA_U_CENTERLINE

    nx0, dt0, ns0 = CASES[re]
    nx, dt = nx or nx0, dt or dt0
    n_steps = n_steps or ns0
    sc = LidDriven2DSimulation(
        "stabilized_schur_bdf2", dt=dt, T=1e9, mu=1.0 / re, nx=nx,
        dtype=dtype, device=device, **solver_kw,
    )
    s = sc.solver
    counts = []
    t0 = time.perf_counter()
    prev = None
    for i in range(n_steps):
        s.t = (i + 1) * dt
        s.solveStep()
        counts.append((int(s.last_stats["newton_iters"]),
                       int(s.last_stats["ksp_iters"])))
        if on_step is not None:
            on_step(i + 1)
        u = to_numpy(s.u_sol)
        if prev is not None:
            rel = np.abs(u - prev).max() / max(np.abs(u).max(), 1e-12)
            if rel < 1e-6:
                if not quiet:
                    print(f"  steady at step {i + 1} (rel du {rel:.1e})")
                break
        prev = u
        # BDF2's u_prev2 <- u_prev rotation happens in _post_step
        s.u_prev, s.p_prev = s.u_sol, s.p_sol
    el = time.perf_counter() - t0

    y, u_bench = GHIA_U_CENTERLINE[re]
    u_sol = sc.centerline_u(y)
    err = u_sol - u_bench
    out = {"scenario": sc, "nx": nx, "max_err": float(np.abs(err).max()),
           "rms_err": float(np.sqrt(np.mean(err ** 2))), "u": u_sol,
           "steps": len(counts), "counts": counts, "wall_s": el}
    print(
        f"Re={re} nx={nx}: max|err|={out['max_err']:.4f} "
        f"rms={out['rms_err']:.4f}  ({el:.0f}s)",
        flush=True,
    )
    return out


def run(re, nx=None, dt=None, n_steps=None, quiet=False, device=None,
        dtype="auto", **solver_kw):
    """cfdtpu's entry point: the largest deviation from Ghia's profile."""
    return solve_case(re, nx, dt, n_steps, quiet, device, dtype,
                      **solver_kw)["max_err"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("re", nargs="*", type=int, default=[100, 400, 1000],
                    choices=sorted(CASES))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--dtype", default="auto",
                    help="auto (the default), float32 or float64")
    ap.add_argument("--kw", default="{}", type=json.loads,
                    help="solver options, a JSON object")
    args = ap.parse_args(argv)
    for re in args.re:
        res = solve_case(re, device=args.device, dtype=args.dtype,
                         **args.kw)
        print(f"Re={re}: {res['steps']} steps, Newton/KSP a step "
              f"{res['counts']}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
