"""gmres's float64 parity at res_scale 1.0 (9,861 DOF), the size of
chip_smoke.py's parity phase: the port's plain versions against cfdtpu
(JAX), and cfdtpu against itself with its outer Gram-Schmidt sums in
another order (ksp_ortho_chunk 4: the same products, chunked). DFG 2D-1,
2 steps from rest, chord Newton, pc_inner_u 6, pc_inner_p at its default
of 30, ksp_restart 20. And each linear solve's iterations, the port's
against cfdtpu's, at res_scale 2.5.

Tolerances: counts equal per step and equal to cfdtpu's (COUNTS; the
first step's is chip_smoke.py's PARITY_COUNTS); u, p, c_D and dp within
1e-9 relative; c_L within 5e-9 of itself. At step 2 c_L is 5.1e-5
against c_D 2.3e-2 (the flow still near symmetric), a near cancellation
that cfdtpu reproduces only to ~1.5e-9 of its value when nothing but its
Gram-Schmidt sum order changes (the spread is printed); chip_smoke.py
holds the card against the host over the first step only, to 1e-9.

Run as a script, the file logs each linear solve of the same slice at
any size, through either package (JAX is imported only for cfdtpu):

    python tests/test_torch_gmres_parity.py --package cfdtpu \\
        --res_scale 0.3 --snes_max_it 1
    python tests/test_torch_gmres_parity.py --package port --device cuda \\
        --res_scale 0.3 --snes_max_it 3
"""

import argparse
import os
import sys
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

SLICE = dict(dt=0.05, T=1.0, dtype="float64", stats_every=1,
             output_every=100, pc_inner_method="gmres", pc_inner_u=6,
             snes_lag_jacobian=True, pc_lag_steps=4, ksp_restart=20)
KW = dict(SLICE, res_scale=1.0)
COUNTS = [(11, 180), (36, 575)]
LIMITS = np.array([1e-9, 5e-9, 1e-9])  # c_D, c_L, dp


def solve_log(package, steps, device="cpu", **kw):
    """DFG 2D-1 with SLICE's settings updated by kw, through `package`
    ("cfdtpu" or "port"): per step, the (iterations, final residual) of
    each linear solve, and the error of a step that did not converge,
    which ends the log."""
    solves = []
    if package == "cfdtpu":
        import jax

        import cfdtpu.la.newton as nt
        from cfdtpu.scenarios.dfg_1 import DFG1Benchmark

        def record(x, info):
            jax.debug.callback(lambda i, r: solves.append((int(i), float(r))),
                               info["iters"], info["resnorm"])
            return x, info
        extra = {}
    else:
        import cfdtpu_torch.la.newton as nt
        from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark

        def record(x, info):
            solves.append((int(info["iters"]), float(info["resnorm"])))
            return x, info
        extra = {"device": device}
    fgmres = nt.fgmres
    nt.fgmres = lambda *a, **k: record(*fgmres(*a, **k))
    log, error = [], None
    try:
        s = DFG1Benchmark("stabilized_schur", **dict(SLICE, **kw),
                          **extra).solver
        for _ in range(steps):
            n0 = len(solves)
            try:
                s.solveStep()
            except RuntimeError as e:
                error = str(e)
            log.append(solves[n0:])
            if error:
                break
            s.u_prev, s.p_prev = s.u_sol, s.p_sol
    finally:
        nt.fgmres = fgmres
    return log, error


@pytest.fixture(scope="module")
def reference():
    from cfdtpu.scenarios.dfg_1 import DFG1Benchmark as JaxDFG
    from test_torch_cycles_slice import march

    return march(JaxDFG("stabilized_schur", **KW), 2)


def differences(got, ref):
    """Equal counts, u and p within 1e-9, the functionals within LIMITS;
    returns the functionals' relative differences."""
    assert got["counts"] == ref["counts"] == COUNTS
    for key in ("u", "p"):
        assert np.isfinite(got[key]).all()
        assert (np.linalg.norm(got[key] - ref[key])
                <= 1e-9 * np.linalg.norm(ref[key])), key
    rel = np.abs(got["funcs"] - ref["funcs"]) / np.abs(ref["funcs"])
    assert (rel <= LIMITS).all(), rel
    return rel


def test_cfdtpu_lift_spread_across_sum_orders(reference):
    from cfdtpu.scenarios.dfg_1 import DFG1Benchmark as JaxDFG
    from test_torch_cycles_slice import march

    other = march(JaxDFG("stabilized_schur", ksp_ortho_chunk=4, **KW), 2)
    rel = differences(other, reference)
    print(f"cfdtpu, ksp_ortho_chunk 4 against 0: c_D, c_L, dp relative "
          f"differences {rel}")


def test_port_matches_cfdtpu(reference):
    from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark as TorchDFG
    from test_torch_cycles_slice import march

    got = march(TorchDFG("stabilized_schur", device="cpu", **KW), 2)
    rel = differences(got, reference)
    print(f"the port's plain versions against cfdtpu: c_D, c_L, dp "
          f"relative differences {rel}")


def test_solve_log_matches_cfdtpu():
    """Each linear solve of 2 steps at res_scale 2.5: the same iterations
    in both packages, and final residuals within 1e-5 relative each (up
    to 4.0e-6 measured: the late solves end near 1e-14, where the Givens
    estimate carries the rounding of the whole step)."""
    ref, ref_error = solve_log("cfdtpu", 2, res_scale=2.5)
    got, got_error = solve_log("port", 2, res_scale=2.5)
    assert ref_error is None and got_error is None
    assert [[i for i, _ in step] for step in got] == \
        [[i for i, _ in step] for step in ref]
    r_got = np.array([r for step in got for _, r in step])
    r_ref = np.array([r for step in ref for _, r in step])
    assert np.allclose(r_got, r_ref, rtol=1e-5, atol=0.0)


def main(argv=None):
    ap = argparse.ArgumentParser(description="each linear solve of the "
                                 "gmres DFG 2D-1 slice")
    ap.add_argument("--package", choices=["cfdtpu", "port"], required=True)
    ap.add_argument("--res_scale", type=float, required=True)
    ap.add_argument("--dtype", default="float64")
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--snes_max_it", type=int, default=100)
    ap.add_argument("--device", default="cpu", help="the port's device")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    log, error = solve_log(args.package, args.steps, device=args.device,
                           res_scale=args.res_scale, dtype=args.dtype,
                           snes_max_it=args.snes_max_it)
    for k, step in enumerate(log, 1):
        print(f"{args.package} res_scale {args.res_scale} {args.dtype} step "
              f"{k}: {len(step)} solves, iterations {[i for i, _ in step]}, "
              f"{sum(i for i, _ in step)} in all; final residuals "
              f"{[float(f'{r:.4e}') for _, r in step]}", flush=True)
    print(f"{'error: ' + error if error else 'converged'} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
