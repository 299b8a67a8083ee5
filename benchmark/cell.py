"""One run of a cell: its files, its inputs, the program's set-up and
warm-up, and the measured window.

A cell is found by its name: BENCHMARK.json names its configuration,
benchmark/workloads/<cell>.json holds its traffic (time step, warm-up,
output cadence, the start state's perturbation, the traced steps, the
range the judged step is drawn from) and its limits, and the
configuration's file (BENCHMARK.json `configs`) holds the scenario
class, its keywords and the solver's, the geometry, and the names of
its mesh generator (benchmark/meshes/<generator>.py) and of its problem
(benchmark/problems/<problem>.py: boundary data, start state,
reference). A cell file may also carry `solver_kw`, solver settings of
its own over the configuration's. A new configuration or cell is new
files of these kinds.

The window drives the scenario's own time loop (Scenario.solve). The
step callback marks the window's start once the warm-up steps are done
and ends the loop, by raising WindowClosed, once `seconds` have passed.
Each window step is timed on the host between consecutive callbacks; a
wrapper set on the solver instance times solveStep (the loop's own time
is the difference) and another counts the operator and preconditioner
rebuilds (`_build_op_state`).
"""

from __future__ import annotations

import importlib
import json
import os
import re
import time
import traceback

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
CACHE_DIR = os.path.join(BENCH_DIR, ".cache")


class CellError(RuntimeError):
    """The cell's files are missing or inconsistent."""


def load_cell(name: str):
    """(benchmark, workload entry, cell file, configuration) of a cell."""
    path = os.path.join(ROOT, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise CellError(f"no workload {name!r} in BENCHMARK.json")
    with open(os.path.join(BENCH_DIR, "workloads", f"{name}.json")) as f:
        cell = json.load(f)
    cfg = next((c for c in bench["configs"] if c["name"] == entry["config"]),
               None)
    if cfg is None:
        raise CellError(f"no configuration {entry['config']!r}")
    with open(os.path.join(ROOT, cfg["file"])) as f:
        config = json.load(f)
    if (cell["config"], cell["traffic"]) != (entry["config"],
                                             entry["traffic"]):
        raise CellError(f"{name}: the cell file and BENCHMARK.json disagree")
    return bench, entry, cell, config


def resolve(name, config_patch=None, cell_patch=None):
    """load_cell with the configuration and the cell file updated by the
    patches, a group key by key (the tests run small meshes on the CPU
    this way)."""
    bench, entry, cell, config = load_cell(name)
    return bench, entry, _patched(cell, cell_patch), _patched(config,
                                                               config_patch)


def _patched(base: dict, patch) -> dict:
    """base updated by patch, a group (a dict) key by key."""
    out = dict(base)
    for k, v in (patch or {}).items():
        out[k] = ({**out[k], **v} if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def _module(kind: str, name: str):
    """benchmark/<kind>/<name>.py, imported as benchmark.<kind>.<name>."""
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", str(name)) or not \
            os.path.exists(os.path.join(BENCH_DIR, kind, f"{name}.py")):
        raise CellError(f"no benchmark/{kind}/{name}.py")
    return importlib.import_module(f"benchmark.{kind}.{name}")


# (width of points, vertices of a cell) -> the program's cell type
CELL_TYPES = {(2, 3): "triangle", (3, 4): "tetrahedron"}


def make_mesh(config: dict) -> dict:
    """The configuration's mesh, from the generator that its
    `mesh.generator` names (benchmark/meshes). A generator returns numpy
    arrays of P1 simplices in d = 2 or 3 dimensions: points (n, d) in
    the configuration's dtype, cells (nc, d + 1), facets (nf, d) the
    boundary facets with outward orientation, facet_cells (nf,) the cell
    of each, facet_local_index (nf,) its local facet there, facet_tags
    (nf,) the boundary markers. The points are in the order the program
    keeps (build_scenario refuses a mesh it renumbers)."""
    return _module("meshes", config["mesh"]["generator"]).make(
        config, cache_dir=os.path.join(CACHE_DIR, "mesh"))


def make_problem(config, cell, mesh, device, dtype=None):
    """The reference's discrete problem of the cell (float64 unless
    `dtype` says otherwise), from the problem that the configuration's
    `problem` names (benchmark/problems)."""
    import torch

    return _module("problems", config["problem"]).reference(
        config, cell, mesh, device, dtype or torch.float64)


def start_state(config, cell, mesh, seed):
    """The seeded start state (float64, rounded to the configuration's
    dtype, as the checkpoint holds it)."""
    dt = np.dtype(config["dtype"])
    u, p = _module("problems", config["problem"]).start_state(
        config, cell, mesh, seed)
    return u.astype(dt).astype(np.float64), p.astype(dt).astype(np.float64)


def judged_step(cell, seed) -> int:
    """The window step that the reference solves again besides the last:
    drawn from the seed, uniformly from the cell's `judged_steps` [first,
    last] (counted from 1 at the window's first step)."""
    lo, hi = (int(v) for v in cell["judged_steps"])
    rng = np.random.default_rng([int(seed) % 2 ** 64, 1])
    return int(lo + rng.integers(hi - lo + 1))


def cell_type(mesh) -> str:
    """The program's cell type of a benchmark mesh, from the widths of
    its points and its cells."""
    widths = (np.shape(mesh["points"])[-1], np.shape(mesh["cells"])[-1])
    if widths not in CELL_TYPES:
        raise CellError(f"a mesh of points of width {widths[0]} and cells "
                        f"of {widths[1]} vertices is no triangle or "
                        f"tetrahedron mesh")
    return CELL_TYPES[widths]


def solver_kw(config, cell) -> dict:
    """The solver settings of a cell: the configuration's `solver_kw`
    updated by the cell's own."""
    return {**config["solver_kw"], **cell.get("solver_kw", {})}


def build_scenario(config, cell, mesh, checkpoint, device):
    """The configuration's scenario on the benchmark's mesh, resumed
    from `checkpoint` (the program's own resume path)."""
    from cfdtpu_torch.mesh import Mesh

    pm = Mesh(points=mesh["points"], cells=mesh["cells"],
              cell_type=cell_type(mesh), facets=mesh["facets"],
              facet_cells=mesh["facet_cells"],
              facet_local_index=mesh["facet_local_index"],
              facet_tags=mesh["facet_tags"].copy(),
              dtype=np.dtype(config["dtype"]))
    if not (np.array_equal(pm.points, mesh["points"])
            and np.array_equal(pm.cells, mesh["cells"])):
        raise CellError("the program renumbered the benchmark's mesh")
    module, cls = config["scenario"].split(":")
    base = getattr(importlib.import_module(module), cls)
    scenario = type(f"Bench{base.__name__}", (base,),
                    {"mesh": property(lambda self: pm)})
    kw = dict(config["scenario_kw"])
    kw.update(solver_kw(config, cell))
    kw.update(early_stop_tolerance=cell["early_stop_tolerance"],
              output_every=cell["output_every"], resume_from=checkpoint)
    return scenario(config["solver"], dt=cell["dt"], T=1e9,
                    dtype=config["dtype"], device=device, **kw)


class WindowClosed(Exception):
    """Raised by the step callback to end the scenario's loop."""


def _host(t):
    return t.detach().to("cpu").double().numpy().copy()


def _states(s):
    """(u_prev, p_prev, u, p) of the step the solver has just made."""
    return (_host(s.u_prev), _host(s.p_prev), _host(s.u_sol),
            _host(s.p_sol))


class Window:
    """The step callback and the solver wrappers of one run.

    After the run: `steps` (one dict a window step: wall_s, solve_s, ksp,
    newton, converged, rebuilt, traced), `window_s`, `t_window` (the
    window's start on perf_counter), `attempted`, `failed`, `error`,
    `first` ((u, p) after step 1), `judged` ((u_prev, p_prev, u, p) of
    window step `judged_step`, or of the last step where the window
    closes before it), `judged_at` (its number in the window), `last`
    ((u_prev, p_prev, u, p) of the window's last step), `profile` (a
    tracewin.Profile or None) and `trace_steps` (the indices into `steps`
    it covers)."""

    def __init__(self, solver, warmup, seconds, trace_steps=0, sync=None,
                 judged_step=1):
        self.solver = solver
        self.judged_step = int(judged_step)
        self.judged = None
        self.judged_at = None
        self.warmup = int(warmup)
        self.seconds = float(seconds)
        self.n_trace = int(trace_steps)
        self.sync = sync or (lambda: None)
        self.lag = max(1, int(getattr(solver, "pc_lag_steps", 1)))
        self.i = 0
        self.steps: list[dict] = []
        self.attempted = 0
        self.failed = 0
        self.error = None
        self.first = None
        self.last = None
        self.t_window = None
        self.window_s = None
        self.profile = None
        self.trace_steps: list[int] = []
        self._trace_at = None
        self._solve_s = 0.0
        self._rebuilds = 0
        self._wrap()

    def _wrap(self):
        s = self.solver
        solve_step = s.solveStep

        def timed_solve_step():
            if self.t_window is not None:
                self.attempted += 1
            self._rebuilds = 0
            t0 = time.perf_counter()
            try:
                solve_step()
            except Exception:
                if self.t_window is not None:
                    self.failed += 1
                self.error = traceback.format_exc(limit=4)
                raise
            self._solve_s = time.perf_counter() - t0

        s.solveStep = timed_solve_step
        build = getattr(s, "_build_op_state", None)
        if build is not None:
            def counted_build(*a, **k):
                self._rebuilds += 1
                return build(*a, **k)

            s._build_op_state = counted_build
        self._counted = build is not None

    def __call__(self, t):
        now = time.perf_counter()
        self.i += 1
        s = self.solver
        if self.i == 1:
            self.first = (_host(s.u_sol), _host(s.p_sol))
        if self.i < self.warmup:
            return
        if self.i == self.warmup:
            self.sync()
            self.t_window = self._prev = time.perf_counter()
            if self.n_trace:
                # the first traced step rebuilds: step k rebuilds where
                # (k - 1) is a multiple of pc_lag_steps
                i = self.warmup + 2
                self._trace_at = i + (-i) % self.lag
            return
        st = getattr(s, "step_stats", {})
        rebuilt = (self._rebuilds > 0 if self._counted
                   else (self.i - 1) % self.lag == 0)
        self.steps.append({
            "wall_s": now - self._prev, "solve_s": self._solve_s,
            "ksp": int(st.get("ksp_iters", 0)),
            "newton": int(st.get("newton_iters", 0)),
            "converged": bool(st.get("converged", True)),
            "rebuilt": bool(rebuilt), "traced": False,
        })
        if not self.steps[-1]["converged"]:
            self.failed += 1
        if self.profile is not None and self.profile.wall_s == 0.0:
            self.steps[-1]["traced"] = True
            self.trace_steps.append(len(self.steps) - 1)
            if len(self.trace_steps) == self.n_trace:
                self.profile.stop()
        elif self._trace_at is not None and self.i == self._trace_at:
            from .tracewin import Profile

            self.profile = Profile()
            self.profile.start()
        if len(self.steps) == self.judged_step:
            # outside the step's own wall time, inside the window's
            self.judged = _states(s)
            self.judged_at = len(self.steps)
        self._prev = time.perf_counter()
        tracing = self.profile is not None and self.profile.wall_s == 0.0
        if now - self.t_window >= self.seconds and not tracing:
            self.sync()
            self.window_s = time.perf_counter() - self.t_window
            self.last = _states(s)
            if self.judged is None:
                self.judged, self.judged_at = self.last, len(self.steps)
            raise WindowClosed


    def record(self) -> dict:
        """What the run's [bench] lines report beside the metrics: the
        mean step of the traced and the untraced steps, the 10th, 50th,
        90th and 99th percentiles and the largest step (ms), the steps
        over three times the median and their time (ms), and Newton and
        KSP iterations of every window step."""
        traced = [x["wall_s"] for x in self.steps if x["traced"]]
        plain = [x["wall_s"] for x in self.steps if not x["traced"]]
        out = {"traced_step_ms": (1e3 * sum(traced) / len(traced)
                                  if traced else None),
               "untraced_step_ms": (1e3 * sum(plain) / len(plain)
                                    if plain else None)}
        walls = sorted(1e3 * x["wall_s"] for x in self.steps)
        if walls:
            q = [walls[min(len(walls) - 1, int(f * len(walls)))]
                 for f in (0.1, 0.5, 0.9, 0.99)]
            slow = [w for w in walls if w > 3 * q[1]]
            out["step_ms_p10_p50_p90_p99_max"] = q + [walls[-1]]
            out["slow_steps_ms"] = [len(slow), sum(slow)]
        out["steps"] = len(self.steps)
        out["newton_per_step"] = [x["newton"] for x in self.steps]
        out["ksp_per_step"] = [x["ksp"] for x in self.steps]
        return out


def run_window(scenario, window, out_dir):
    """Drive the scenario's time loop with the window's callback."""
    try:
        scenario.solve(out_dir, afterStepCallback=window)
    except WindowClosed:
        return
    except Exception:  # noqa: BLE001 - a failed step ends the run
        if window.error is None:
            window.error = traceback.format_exc(limit=4)
        if window.t_window is not None and window.failed == 0:
            window.failed = 1
