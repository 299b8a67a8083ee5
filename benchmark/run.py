#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload dfg2d1_developed --seed 7 \
        --seconds 20 --trace 0

From the root of a checkout, on a machine with an NVIDIA card. The last
line of standard output is one JSON object: correct, attempted, failed,
metrics (the cell's end-to-end metrics with --trace 0, its per-layer
metrics with --trace 1, each from benchmark/metrics/<name>.py), device
(with --trace 1 also busy_s and window_s of the traced steps), with
--trace 1 a breakdown, and last the compared numbers with their limits
(checks), which also end standard error. Without a card, with fewer
cards than the cell asks for, or without the program, it exits non-zero
and prints no result.

The program's caches (the symbol cache, the mesh cache, torch's
extension and Triton caches) are pointed at fixed directories under
benchmark/.cache; the program's kernel library builds in its package's
own _build directory. The run writes its start state and the scenario's
outputs into a directory under TMPDIR and removes it at the end.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "cfdtpu")


def process_age() -> float:
    """Seconds since this process started (Linux /proc), at T_START."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        age = up - start_ticks / os.sysconf("SC_CLK_TCK")
        return max(0.0, age - (time.perf_counter() - T_START))
    except (OSError, ValueError, IndexError):
        return 0.0


def one_thread() -> None:
    """One host thread for the process's numerical libraries: the loop is
    host-bound, and idle pool threads spinning beside it make the runs
    spread."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def card_state() -> str | None:
    """The card's clocks, power and temperature and the host's load, for
    the run's record (nvidia-smi; None where it is missing)."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
             "power.limit,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = None
    return f"{out}; load {os.getloadavg()[0]:.2f}"


def set_cache_dirs() -> None:
    cache = os.path.join(HERE, ".cache")
    for var, sub in (("CFDTPU_SYM_CACHE", "sym"),
                     ("CFDTPU_MESH_CACHE", "program_mesh"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(cache, sub)


def forbidden_modules() -> list[str]:
    top = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(top.intersection(FORBIDDEN))


class Context:
    """What the metric readers read (benchmark/metrics)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def load_reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench, workload, kind, ctx) -> dict:
    out = {}
    for m in bench[kind]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        value = load_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def execute(workload, seed, seconds, trace, device="cuda",
            config_patch=None, cell_patch=None, break_solver=None):
    """One run of the cell; returns (result dict without `checks`,
    checks, info). config_patch and cell_patch update the cell's files as
    read (the tests use them to run a small mesh on the CPU),
    break_solver(solver) breaks the timed path under the window (the
    tests' planted faults)."""
    import numpy as np
    import torch

    from benchmark import cell as cellmod
    from benchmark import judge
    from benchmark.checkpoint import write_checkpoint
    from benchmark.tracewin import breakdown

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    bench, entry, cell, config = cellmod.resolve(workload, config_patch,
                                                 cell_patch)
    mesh = cellmod.make_mesh(config)
    start = cellmod.start_state(config, cell, mesh, seed)
    work = tempfile.mkdtemp(prefix="cfd_bench_")
    try:
        ckpt = os.path.join(work, "start.npz")
        write_checkpoint(ckpt, *start, np.dtype(config["dtype"]))
        sc = cellmod.build_scenario(config, cell, mesh, ckpt, device)
        solver = sc.solver
        if break_solver is not None:
            break_solver(solver)
        window = cellmod.Window(
            solver, cell["warmup_steps"], seconds,
            trace_steps=cell["trace_steps"] if trace else 0,
            sync=torch.cuda.synchronize if on_card else None,
            judged_step=cellmod.judged_step(cell, seed))
        cellmod.run_window(sc, window, os.path.join(work, "out"))
        peak = torch.cuda.max_memory_allocated() if on_card else None
        setup_s = (None if window.t_window is None
                   else window.t_window - T_START + process_age())
        tr = None
        if window.profile is not None and window.profile.wall_s > 0:
            tr = window.profile.read()
        ctx = Context(steps=window.steps, window_s=window.window_s,
                      setup_s=setup_s, trace=tr,
                      trace_steps=[window.steps[i]
                                   for i in window.trace_steps],
                      solver=solver, mesh=mesh, config=config,
                      device=torch.device(device))
        metrics = metrics_of(bench, workload,
                             "per_layer" if trace else "end_to_end", ctx)
        steps_per_s = (len(window.steps) / window.window_s
                       if window.window_s else None)
        attempted, failed, error = (window.attempted, window.failed,
                                    window.error)
        first, judged, last = window.first, window.judged, window.last
        record = window.record()
        record["judged_step"] = window.judged_at
        del ctx, window, solver, sc
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)

    values, info = {}, {}
    if failed == 0 and first is not None and last is not None:
        t0 = time.perf_counter()
        problem = cellmod.make_problem(config, cell, mesh, device)
        values, info = judge.readings(problem, start, first, judged, last)
        info["reference_total_s"] = time.perf_counter() - t0
        info["states"] = (start, first, judged, last, info.pop("ref"))
    chk = judge.checks(values, cell.get("limits", {}))
    correct = failed == 0 and judge.passed(chk)
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics}
    if on_card:
        result["device"] = {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": int(entry["chips"]), "memory_peak_bytes": int(peak)}
        if tr is not None:
            result["device"]["busy_s"] = tr["busy_s"]
            result["device"]["window_s"] = tr["wall_s"]
    if tr is not None:
        result["breakdown"] = breakdown(tr)
    info.update(record, steps_per_s=steps_per_s, error=error)
    return result, chk, info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # import the benchmark's modules as the package `benchmark`, never by
    # their bare names from the script's directory
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    set_cache_dirs()
    one_thread()

    import torch

    torch.set_num_threads(1)

    if not torch.cuda.is_available():
        print("error: no CUDA card is available", file=sys.stderr)
        return 2
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        entry = next((w for w in json.load(f)["workloads"]
                      if w["name"] == args.workload), None)
    if entry is None:
        print(f"error: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(entry["chips"]):
        print(f"error: the cell needs {entry['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    import cfdtpu_torch  # noqa: F401 - the program under test

    before = card_state()
    result, chk, info = execute(args.workload, args.seed, args.seconds,
                                args.trace)
    info["card_before_after"] = [before, card_state()]
    found = forbidden_modules()
    if found:
        print(f"error: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    info.pop("states", None)
    newton, ksp = info.pop("newton_per_step"), info.pop("ksp_per_step")
    print(f"[bench] newton a step: {newton}")
    print(f"[bench] ksp a step: {ksp}")
    print(f"[bench] {json.dumps(info, default=str)}")
    if info.get("error"):
        print(info["error"], file=sys.stderr)
    result["checks"] = chk
    for name, c in chk.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
