#!/usr/bin/env python3
"""Chip smoke test of cfdtpu_torch on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py [--report PATH]

Run from the root of a checkout. Phases, each raising on failure:

1. the card: nvidia-smi name and power limit, torch and CUDA versions;
   no CUDA is an error.
2. build: one nvcc per cfdtpu_torch/csrc/*.cu, all started together,
   linked into cfdtpu_torch/_build/libcfdtpu_kernels.so.
3. kernels: at the DFG 2D-1 res_scale=0.3 slice (106,275 DOF, float32)
   every kernel (K1 sup_spmv, K2 ell_sum, K3 ns_cell_residual_p1,
   K4 selfp_triple, K5 patch_spmv, K6 ras_apply) is held against its
   plain PyTorch version at each of its call sites on the two paths
   below — including the rasamg_sup block-AMG levels (K1 at width 16),
   block transfers and facet-residual scatter (K2), the RAS windows (K6)
   and the gather_micro shapes (K5, beside K1 at width 1):
   ||kernel - plain||_inf <= 1e-5 ||plain||_inf (float32: the sums run
   in another order), and timed (median device time of 25
   CUDA-event-timed calls, kernel and plain, host dispatch excluded).
   The same checks run in float64 at res_scale 1.0 with 1e-12.
4. determinism: two float32 form.residual calls on one state are
   bitwise equal.
5. path A, the rasamg_sup slice (the configuration bench.py runs):
   Scenario.solve drives 10 float32 steps from rest (Schur/rasamg_sup,
   pc_inner_u=0, pc_inner_p=5, RAS windows of 32 with overlap 4, chord
   Newton, pc_lag_steps=4, stats_every=4, ksp_restart=20, dt=0.05),
   steps 1-6 warm-up and 7-10 measured, with the launch counters reset
   just before; every step must converge with a finite state, no linear
   solve may hit ksp_max_it, and K1, K2, K3, K4 and K6 must have
   launched.
6. the amg_p slice (the solver's default inner method): 8 float32 steps
   from rest, steps 5-8 measured, the same checks for K1-K4.
7. parity: float64 at res_scale 1.0, 2 steps through the kernels on the
   card and 2 steps through the plain versions (which the wrappers take
   only for CPU tensors, so that run is on the host), for rasamg_sup and
   for amg_p: equal Newton and KSP counts per step, u, p, c_D, c_L and
   dp within 1e-9 relative.
8. path B: `python -m cfdtpu_torch.scripts.gather_micro --device cuda`
   exits 0 with every K5 result within 1e-5 relative of its plain
   version; it launches K5.
9. CLI: `python -m cfdtpu_torch simulate ... --device cuda` exits 0 and
   writes simulation_params.txt, norms.txt and v.pvd, with the default
   inner method and with the rasamg_sup flags.

The second-to-last line is {"kernels": [...]}, the last
{"ok": true, "device": {...}}.
"""

import argparse
import gc
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DT = 0.05
# the solver's default inner method (the first ported slice)
SLICE_KW = dict(pc_inner_method="amg_p", pc_inner_u=6, pc_inner_p=10,
                snes_lag_jacobian=True, pc_lag_steps=4, ksp_restart=20)
# the configuration bench.py runs (bench.py:64-74, 119)
RASAMG_KW = dict(pc_inner_method="rasamg_sup", pc_inner_u=0, pc_inner_p=5,
                 pc_ras_size=32, snes_lag_jacobian=True, pc_lag_steps=4,
                 ksp_restart=20)
RASAMG_FLAGS = ["--pc_inner_method", "rasamg_sup", "--pc_inner_u", "0",
                "--pc_inner_p", "5", "--pc_ras_size", "32",
                "--snes_lag_jacobian", "True", "--pc_lag_steps", "4",
                "--stats_every", "4", "--ksp_restart", "20"]
PATH_A_KERNELS = ("sup_spmv", "ell_sum", "ns_cell_residual_p1",
                  "selfp_triple", "ras_apply")
AMG_P_KERNELS = ("sup_spmv", "ell_sum", "ns_cell_residual_p1",
                 "selfp_triple")
# name: (source, replaced TPU/XLA op, headline site, path that launches it)
SOURCES = {
    "sup_spmv": ("cfdtpu_torch/csrc/sup_spmv.cu",
                 "cfdtpu/la/nodebsr.py:258", "K1 full operator", "A"),
    "ell_sum": ("cfdtpu_torch/csrc/ell_sum.cu",
                "cfdtpu/utils/geometry.py:134", "K2 assembly", "A"),
    "ns_cell_residual_p1": ("cfdtpu_torch/csrc/ns_cell_residual.cu",
                            "cfdtpu/forms/navier_stokes.py:190",
                            "K3 cell residual", "A"),
    "selfp_triple": ("cfdtpu_torch/csrc/selfp_triple.cu",
                     "cfdtpu/la/nodebsr.py:386", "K4 selfp triples", "A"),
    "patch_spmv": ("cfdtpu_torch/csrc/patch_spmv.cu",
                   "scripts/gather_micro.py:55", "K5 patch P=8192 K=8",
                   "B"),
    "ras_apply": ("cfdtpu_torch/csrc/ras_apply.cu", "cfdtpu/la/ras.py:149",
                  "K6 ras apply", "A"),
}
PATHS = {"A": "rasamg_sup slice (Scenario.solve, 106,275 DOF)",
         "B": "python -m cfdtpu_torch.scripts.gather_micro"}


def log(*a):
    print(*a, flush=True)


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


# ----------------------------------------------------------------------
def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)}")
    return smi


def phase_build():
    from cfdtpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build(force=True)
    _build.library()
    log(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}, one process per "
        f"source: {time.perf_counter() - t0:.2f} s -> {_build.LIB_PATH}")


# ----------------------------------------------------------------------
def developed_state(torch, np, s, seed):
    """A developed-looking state: the inlet profile everywhere plus a
    small perturbation, made with numpy from `seed`."""
    y = s.V.dof_coords[:, 1]
    rng = np.random.default_rng(seed)
    prof = np.stack([1.2 * y * (0.41 - y) / 0.41 ** 2, 0 * y], axis=1)
    n_u, n_p = s.V.num_dofs, s.Q.num_dofs
    return (s.tensor(prof + 0.01 * rng.standard_normal((n_u, 2))),
            s.tensor(prof + 0.01 * rng.standard_normal((n_u, 2))),
            s.tensor(0.01 * rng.standard_normal(n_p)))


def bc_mask_u(torch, np, s):
    m = np.zeros(s.V.num_dofs * 2, dtype=bool)
    for d0 in range(2):
        m[s.bc_dofs_u.astype(np.int64) * 2 + d0] = True
    return torch.as_tensor(m, device=s.device)


def kernel_sites(torch, np, sc, seed=0):
    """(kernel name, site label, kernel call, plain call) at the shapes
    the two paths give each kernel. `sc` runs the rasamg_sup solver,
    whose node-BSR holds both the SELFP AMG and the velocity BlockAMG
    with its RAS windows."""
    from cfdtpu_torch.kernels.ell_sum import ell_sum, ell_sum_plain
    from cfdtpu_torch.kernels.ns_cell_residual import (
        ns_cell_residual_p1, ns_cell_residual_plain)
    from cfdtpu_torch.kernels.patch_spmv import patch_spmv, patch_spmv_plain
    from cfdtpu_torch.kernels.ras_apply import ras_apply, ras_apply_plain
    from cfdtpu_torch.kernels.selfp_triple import (selfp_triple,
                                                   selfp_triple_plain)
    from cfdtpu_torch.kernels.sup_spmv import sup_spmv, sup_spmv_plain
    from cfdtpu_torch.la.superell import sup_rows
    from cfdtpu_torch.scripts import gather_micro

    s = sc.solver
    f, nb = s.form, s._nodebsr
    amg = nb.sp_amg()
    rng = np.random.default_rng(seed + 1)
    u, up, p = developed_state(torch, np, s, seed)
    prm = s.params()
    A_cells, A_blocks = f.element_jacobians(u, p, (up,), prm)
    vals = nb.assemble(A_cells, A_blocks)
    sp = nb.sp_vals(vals)
    levels, _ = amg.build(sp)
    ras = nb.uu_ras(s.pc_ras_size, s.pc_ras_overlap)
    bamg = nb.uu_amg(fine_smoother=ras)
    blevels, _, ras_inv = bamg.build(nb.uu_vals(vals, bc_mask_u(torch, np,
                                                                  s)))
    n_bad = int((~torch.isfinite(ras_inv)).reshape(ras.n_sub, -1)
                .any(dim=1).sum())
    log(f"[kernels] RAS: {ras.n_sub} windows of m={ras.m} (s={ras.s}, "
        f"o={ras.o}), n_cand={ras._n_cand}, {len(ras._dst)} placed "
        f"values; windows with a non-finite inverse: {n_bad}")
    require(n_bad == 0, f"{n_bad} RAS window inverses are not finite")
    log(f"[kernels] BlockAMG levels (nodes): "
        f"{[m.n for m, _ in bamg.sup]}; layouts (ns, Kg, g*d, g*d): "
        f"{[tuple(ev.shape) for ev, _ in blevels]}")
    rand = (lambda *shape: s.tensor(rng.standard_normal(shape)))

    sites = []
    cols = nb._sup.sup_cols
    gd = nb.g * nb.dim
    v = rand(nb.n_u_flat + nb.n_nodes)
    X = nb._sup_rows(v)
    Xu = nb._sup_rows_u(v[: nb.n_u_flat])
    Xp = nb._sup_rows_p(v[nb.n_u_flat:])
    n_u, n_p = nb.n_u_flat, nb.n_nodes
    S = vals["sup"]
    for label, A, Xs, n_out in (
        ("K1 full operator", S, X, None),
        ("K1 uu", S[:, :, :gd, :gd], Xu, n_u),
        ("K1 up", S[:, :, :gd, gd:], Xp, n_u),
        ("K1 pu", S[:, :, gd:, :gd], Xu, n_p),
        ("K1 p-coupled", S[:, :, :, gd:], Xp, None),
    ):
        n = n_out if n_out is not None else A.shape[0] * A.shape[2]
        sites.append(("sup_spmv", label,
                      lambda A=A, Xs=Xs, n=n: sup_spmv(A, cols, Xs, n),
                      lambda A=A, Xs=Xs, n=n: sup_spmv_plain(A, cols, Xs, n)))

    def k1_levels(tag, lvls, sup, width_of, omega):
        for k, (ev, d) in enumerate(lvls):
            maps = sup[k][0]
            m = d.shape[0]
            x, b = rand(m), rand(m)
            Xk = sup_rows(x, maps.ns, width_of(maps))
            for mode in ("y", "residual", "jacobi"):
                kw = dict(mode=mode, b=b, x=x, d=d, omega=omega)
                sites.append((
                    "sup_spmv", f"K1 {tag} L{k} {mode} {tuple(ev.shape)}",
                    lambda ev=ev, Xk=Xk, m=m, kw=kw, c=maps.sup_cols:
                        sup_spmv(ev, c, Xk, m, **kw),
                    lambda ev=ev, Xk=Xk, m=m, kw=kw, c=maps.sup_cols:
                        sup_spmv_plain(ev, c, Xk, m, **kw)))

    k1_levels("amg", levels, amg.sup, lambda maps: maps.g, amg.omega)
    k1_levels("block-amg", blevels, bamg.sup,
              lambda maps: maps.g * bamg.d, bamg.omega)

    def k2(label, scat, shape):
        src = rand(scat.n_in, *shape)
        idx = scat.ell_idx
        log(f"[kernels] {label}: src {tuple(src.shape)} -> {scat.n_out} "
            f"rows, K={scat.K}")
        sites.append(("ell_sum", label, lambda: ell_sum(src, idx),
                      lambda: ell_sum_plain(src, idx)))

    k2("K2 residual u", f._scatter_u, (2,))
    k2("K2 residual p", f._scatter_p, ())
    k2("K2 facet residual u", f._facet_blocks[0]["scatter_u"], (2,))
    k2("K2 assembly", nb._assemble_scatter, (9,))
    k2("K2 selfp", nb._sp_scatter, ())
    for k, lvl in enumerate(amg.levels):
        k2(f"K2 amg restrict L{k}", lvl._restrict, ())
        k2(f"K2 amg coarsen L{k}", lvl._coarsen, ())
    for k, lvl in enumerate(bamg.levels):
        k2(f"K2 block restrict L{k}", lvl._restrict, (bamg.d,))
        k2(f"K2 block coarsen L{k}", lvl._coarsen, (bamg.d, bamg.d))

    args = (u, up, p, f.dofmap_u, f.dofmap_p, f.cell_coords, f.cell_h,
            f.tabs, prm["rho"], prm["mu"], prm["dt"], prm["f"], f.eps)
    sites.append(("ns_cell_residual_p1", "K3 cell residual",
                  lambda: ns_cell_residual_p1(*args),
                  lambda: ns_cell_residual_plain(*args)))
    inv = rand(nb.n_nodes, nb.dim)
    coo_v = vals["coo"]
    sargs = (coo_v, nb._sp_e1, nb._sp_e2, nb._sp_K, inv)
    sites.append(("selfp_triple", "K4 selfp triples",
                  lambda: selfp_triple(*sargs),
                  lambda: selfp_triple_plain(*sargs)))

    for P, K in gather_micro.PATCH_SHAPES:
        xp, vp, ip = (t.to(s.dtype) if t.is_floating_point() else t
                      for t in gather_micro.patch_inputs(P, K, s.device))
        A1, c1, X1 = gather_micro.k1_operands(xp, vp, ip)
        sites.append(("patch_spmv", f"K5 patch P={P} K={K}",
                      lambda a=(xp, vp, ip): patch_spmv(*a),
                      lambda a=(xp, vp, ip): patch_spmv_plain(*a)))
        sites.append(("sup_spmv", f"K1 width 1 patch P={P} K={K}",
                      lambda a=(A1, c1, X1): sup_spmv(*a),
                      lambda a=(xp, vp, ip): patch_spmv_plain(*a)
                      .reshape(-1)))

    rx, rb = rand(nb.n_u_flat), rand(nb.n_u_flat)
    rargs = (ras_inv, rx, ras._win, ras.s, ras.o, ras.d)
    sites.append(("ras_apply", "K6 ras apply", lambda: ras_apply(*rargs),
                  lambda: ras_apply_plain(*rargs)))
    sites.append(("ras_apply", "K6 ras apply + x",
                  lambda: ras_apply(*rargs, base=rb),
                  lambda: ras_apply_plain(*rargs, base=rb)))
    return sites


def flat_outputs(out):
    return out if isinstance(out, tuple) else (out,)


def phase_kernels(torch, np, sc, tol, timed):
    """Compare every kernel site with its plain version; returns
    {site: (kernel name, max_abs_err, ms, plain_ms)}."""
    from cfdtpu_torch.utils.cudatime import cuda_ms

    rows = {}
    for name, label, kern, plain in kernel_sites(torch, np, sc):
        got, ref = flat_outputs(kern()), flat_outputs(plain())
        torch.cuda.synchronize()
        err = 0.0
        for g, r in zip(got, ref):
            require(g.shape == r.shape and g.dtype == r.dtype,
                    f"{label}: shape/dtype {g.shape} {r.shape}")
            e = float((g - r).abs().max())
            scale = float(r.abs().max())
            require(e <= tol * scale,
                    f"{label}: |kernel - plain|_inf {e:.3e} > "
                    f"{tol:g} * {scale:.3e}")
            err = max(err, e)
        ms = cuda_ms(kern) if timed else float("nan")
        pms = cuda_ms(plain) if timed else float("nan")
        rows[label] = (name, err, ms, pms)
        log(f"[kernels] {label:44s} max_abs_err {err:.3e}  "
            f"kernel {ms:.4f} ms  plain {pms:.4f} ms")
    return rows


def phase_determinism(torch, np, sc, trials=5):
    """Two float32 residual calls on one state must be bitwise equal.
    For the record, also how often the facet term's former atomic
    index_add reproduced itself."""
    s = sc.solver
    f = s.form
    u, up, p = developed_state(torch, np, s, 7)
    prm = s.params()
    a = f.residual(u, p, (up,), prm)
    b = f.residual(u, p, (up,), prm)
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    block = f._facet_blocks[0]
    _, ru_f = f._block_residual(block, u, p, (up,), prm)
    ru_c = a[0] - block["scatter_u"](ru_f.reshape(-1, 2).contiguous())
    dm = block["dofmap_u"].reshape(-1)

    def old():
        return ru_c.index_add(0, dm, ru_f.reshape(-1, 2))

    ref = old()
    old_same = sum(torch.equal(old(), ref) for _ in range(trials))
    log(f"[determinism] float32 form.residual twice: bitwise equal "
        f"{same}; the former facet index_add reproduced itself in "
        f"{old_same}/{trials} trials")
    require(same, "form.residual is not bitwise repeatable")
    return {"residual_bitwise_equal": same,
            "index_add_repeats": f"{old_same}/{trials}"}


# ----------------------------------------------------------------------
def run_steps(sc, out_dir, steps):
    """Drive the scenario's time loop (Scenario.solve) for `steps`
    steps; returns per-step [(newton, ksp, ksp_max, wall_s, converged)].
    Step 1's wall time includes the loop's output set-up."""
    import torch

    s = sc.solver
    rec = []
    last = [time.perf_counter()]

    def after_step(t):
        torch.cuda.synchronize() if s.device.type == "cuda" else None
        now = time.perf_counter()
        st = s.step_stats
        rec.append((st["newton_iters"], st["ksp_iters"], st["ksp_max"],
                    now - last[0], st["converged"]))
        last[0] = now

    sc.T = (steps - 0.5) * sc.dt  # t accumulates in floats: stop between
    sc.solve(out_dir, afterStepCallback=after_step)
    require(len(rec) == steps, f"ran {len(rec)} steps, wanted {steps}")
    return rec


def phase_slice(torch, np, sc, out_dir, tag, steps, required):
    """Drive `steps` steps from rest with the launch counters reset just
    before; the last 4 (one pc_lag_steps period) are measured."""
    from cfdtpu_torch import kernels

    s = sc.solver
    gc.collect()  # free an earlier phase's scenario before the peak
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    rec = run_steps(sc, out_dir, steps)
    launches = kernels.counts()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ndof = s.V.num_global_dofs + s.Q.num_global_dofs
    for i, (n, k, kmax, w, _) in enumerate(rec, 1):
        log(f"[{tag}] step {i}: newton {n} ksp {k} (max per solve {kmax}) "
            f"wall {w:.4f} s")
    win = rec[-4:]
    wall = sum(r[3] for r in win)
    sps = 4 / wall
    ksp = sum(r[1] for r in win)
    fd, fl = sc.compute_drag_lift()
    fdr, flr = sc.compute_drag_lift(method="reaction")
    dp = sc.compute_pressure_diff()
    log(f"[{tag}] {ndof} DOF float32: {sps:.4f} steps/s over steps "
        f"{steps - 3}-{steps}; {sum(r[0] for r in win)} Newton and {ksp} "
        f"KSP there, {1e3 * wall / ksp:.2f} ms per KSP iteration; "
        f"c_D {500 * fd:.6f} c_L {500 * fl:.6f} (line), "
        f"c_D {500 * fdr:.6f} c_L {500 * flr:.6f} (reaction), dp {dp:.6f}; "
        f"peak memory {peak / 2**20:.1f} MiB; launches {launches}")
    require(all(r[4] for r in rec), "a step did not converge")
    u = s.u_sol.cpu().numpy()
    p = s.p_sol.cpu().numpy()
    require(np.isfinite(u).all() and np.isfinite(p).all(),
            "non-finite state")
    kmax_allowed = s.newton_params.ksp_maxiter
    require(all(r[2] < kmax_allowed for r in rec), "a solve hit ksp_max_it")
    for name in required:
        require(launches[name] > 0,
                f"kernel {name} never launched on the {tag} path")
    return launches, {"ndof": ndof, "steps_per_s": sps, "peak_bytes": peak,
                      "ms_per_ksp": 1e3 * wall / ksp,
                      "steps": rec, "c_D": 500 * fd, "c_L": 500 * fl,
                      "c_D_reaction": 500 * fdr, "c_L_reaction": 500 * flr,
                      "dp": dp}


def phase_parity(torch, np, tmp, kw, tag):
    """float64 res 1.0: kernels on the card vs plain versions (CPU)."""
    from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark

    res = {}
    for dev in ("cuda", "cpu"):
        sc = DFG1Benchmark("stabilized_schur", dt=DT, T=1.0, res_scale=1.0,
                           dtype="float64", device=dev, stats_every=1,
                           output_every=100, **kw)
        t0 = time.perf_counter()
        rec = run_steps(sc, os.path.join(tmp, f"parity_{tag}_{dev}"), 2)
        s = sc.solver
        fd, fl = sc.compute_drag_lift()
        res[dev] = {
            "counts": [(r[0], r[1]) for r in rec],
            "u": s.u_sol.cpu().numpy(), "p": s.p_sol.cpu().numpy(),
            "f": np.array([fd, fl, sc.compute_pressure_diff()]),
        }
        log(f"[parity {tag}] {dev}: counts {res[dev]['counts']} "
            f"({time.perf_counter() - t0:.1f} s)")
    a, b = res["cuda"], res["cpu"]
    require(a["counts"] == b["counts"],
            f"{tag}: iteration counts differ: {a['counts']} vs "
            f"{b['counts']}")
    out = {"counts": a["counts"]}
    for key in ("u", "p"):
        rel = np.linalg.norm(a[key] - b[key]) / np.linalg.norm(b[key])
        log(f"[parity {tag}] {key} relative difference {rel:.3e}")
        require(rel <= 1e-9, f"{tag}: {key} differs by {rel:.3e}")
        out[key] = rel
    relf = np.abs(a["f"] - b["f"]) / np.abs(b["f"])
    log(f"[parity {tag}] c_D, c_L, dp relative differences {relf}")
    require((relf <= 1e-9).all(), f"{tag}: functionals differ: {relf}")
    out["c_D_c_L_dp"] = relf.tolist()
    return out


def phase_gather_micro():
    """Path B: the gather_micro entry point, as a user runs it."""
    cmd = [sys.executable, "-m", "cfdtpu_torch.scripts.gather_micro",
           "--device", "cuda"]
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                         text=True, timeout=600)
    tail = (res.stdout + res.stderr)[-3000:]
    require(res.returncode == 0, f"gather_micro exited {res.returncode}:\n"
                                 f"{tail}")
    for ln in res.stdout.splitlines()[:-1]:
        log(f"[gather_micro] {ln}")
    got = json.loads(res.stdout.strip().splitlines()[-1])["gather_micro"]
    for r in got["patch_spmv"]:
        require(r["ok"] and r["rel_err"] <= 1e-5,
                f"gather_micro K5 at P={r['P']} K={r['K']}: rel err "
                f"{r['rel_err']:.3e}")
    require(got["launches"]["patch_spmv"] > 0,
            "gather_micro did not launch K5")
    log(f"[gather_micro] ok in {time.perf_counter() - t0:.1f} s; launches "
        f"{got['launches']}")
    return got


def phase_cli(tmp, name, flags=()):
    out = os.path.join(tmp, f"cli_{name}")
    cmd = [sys.executable, "-m", "cfdtpu_torch", "simulate",
           "--simulation", "dfg_1", "--solver", "stabilized_schur",
           "--T", "0.1", "--dt", "0.05", "--res_scale", "1.0",
           "--device", "cuda", "--output_dir", out, *flags]
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                         text=True, timeout=600)
    tail = (res.stdout + res.stderr)[-3000:]
    require(res.returncode == 0, f"CLI exited {res.returncode}:\n{tail}")
    runs = glob.glob(os.path.join(out, "dfg_1", "*"))
    require(len(runs) == 1, f"CLI run directory missing: {runs}")
    for fname in ("simulation_params.txt", "norms.txt", "v.pvd"):
        require(os.path.exists(os.path.join(runs[0], fname)),
                f"CLI did not write {fname}")
    log(f"[cli {name}] ok in {time.perf_counter() - t0:.1f} s: "
        + " | ".join(ln for ln in res.stdout.splitlines()
                     if ln.startswith(("Solver converged", "Drag", "Lift",
                                       "Pressure"))))


# ----------------------------------------------------------------------
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", default=None,
                    help="also write every measured number to this JSON")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import cfdtpu_torch  # noqa: F401  (fails outside a checkout)
    from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark

    t_start = time.perf_counter()
    smi = phase_card(torch)
    phase_build()

    def scenario(res_scale, dtype, stats_every, kw):
        t0 = time.perf_counter()
        sc = DFG1Benchmark("stabilized_schur", dt=DT, T=1.0,
                           res_scale=res_scale, dtype=dtype, device="cuda",
                           stats_every=stats_every, output_every=100, **kw)
        log(f"[setup] res_scale {res_scale} {dtype} "
            f"{kw['pc_inner_method']} scenario on cuda: "
            f"{time.perf_counter() - t0:.1f} s")
        return sc

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        sc = scenario(0.3, "float32", 4, RASAMG_KW)
        rows = phase_kernels(torch, np, sc, 1e-5, timed=True)
        sc64 = scenario(1.0, "float64", 1, RASAMG_KW)
        phase_kernels(torch, np, sc64, 1e-12, timed=False)
        del sc64
        determinism = phase_determinism(torch, np, sc)

        launches_a, slice_a = phase_slice(
            torch, np, sc, os.path.join(tmp, "slice_a"), "rasamg_sup", 10,
            PATH_A_KERNELS)
        del sc
        sc_p = scenario(0.3, "float32", 4, SLICE_KW)
        launches_p, slice_p = phase_slice(
            torch, np, sc_p, os.path.join(tmp, "slice_amg_p"), "amg_p", 8,
            AMG_P_KERNELS)
        del sc_p
        parity = {tag: phase_parity(torch, np, tmp, kw, tag)
                  for tag, kw in (("rasamg_sup", RASAMG_KW),
                                  ("amg_p", SLICE_KW))}
        gm = phase_gather_micro()
        phase_cli(tmp, "amg_p")
        phase_cli(tmp, "rasamg_sup", RASAMG_FLAGS)

    launches = {"A": launches_a, "B": gm["launches"]}
    entries = []
    for name, (src, replaces, site, path) in SOURCES.items():
        _, err, ms, pms = rows[site]
        entries.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "site": site, "path": PATHS[path],
            "launches": launches[path][name], "max_abs_err": err, "ms": ms,
            "plain_ms": pms,
        })
    log(f"[done] chip_smoke command time "
        f"{time.perf_counter() - t_start:.1f} s")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as fh:
            json.dump({"card": smi, "sites": rows, "slice_rasamg_sup": slice_a,
                       "slice_amg_p": slice_p, "launches_amg_p": launches_p,
                       "launches": launches, "parity": parity,
                       "determinism": determinism, "gather_micro": gm,
                       "kernels": entries}, fh, indent=1, default=str)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
