"""The trace module (cfdtpu_torch/utils/trace.py): spans and counters
inside the time step.

- Tracing off: span() hands back one shared object that does nothing,
  and the store stays empty; begin_step/end_loop switch tracing by the
  profiler for one iteration.
- Tracing on (enable()) on a small DFG 2D-1 mesh (res_scale 3.0, 1,158
  DOF, float64, the benchmark cell's Schur settings with pc_lag_steps 2,
  4 steps) through Scenario.solve: spans nest under the right parents
  and steps; the counters ksp_iters, newton_iters and rebuilds agree
  with each step's step_stats, and ksp_discarded with fgmres's own
  info["discarded"].
- Under a CPU torch.profiler started and stopped in the step callback,
  the cfd.* ranges are in prof.events() for the profiled steps only.
- The solution with tracing on is bit for bit the one with it off.
- outer_operator() is the operator the benchmark's spmv_roofline reads.

Cases marked `gpu` (pc.capture, pc.apply, the allocator counters, and
the cfd.* ranges on the host's timeline alone, none of them a device
activity) need a CUDA card and skip without one:

    python -m pytest tests/test_torch_trace.py -m gpu -q
"""

import importlib.util
import os

import pytest
import torch

from cfdtpu_torch.la import newton as newton_mod
from cfdtpu_torch.utils import trace

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(dt=0.05, T=0.19, res_scale=3.0, dtype="float64",
          pc_inner_method="rasamg_sup", pc_inner_u=0, pc_inner_p=5,
          pc_ras_size=32, snes_lag_jacobian=True, pc_lag_steps=2,
          stats_every=1, ksp_restart=20, early_stop_tolerance=0.0,
          output_every=100)
STEPS = 4  # T / dt
PROFILED = (3, 4)  # the steps the profiled run records


def _scenario(device="cpu"):
    from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark

    return DFG1Benchmark("stabilized_schur", device=device, **KW)


@pytest.fixture(autouse=True)
def _clean():
    trace.disable()
    trace.reset()
    yield
    trace.end_loop()
    trace.disable()
    trace.reset()


def _run(tmp, mode, device="cpu"):
    """One solve: mode None (tracing off), "enable" or "profile" (a CPU
    torch.profiler over PROFILED, started and stopped in the callback).
    Returns the solver, each step's step_stats, fgmres's info of every
    call, the records and the profiler's events."""
    from torch.profiler import ProfilerActivity, profile

    sc = _scenario(device)
    infos, stats, prof = [], [], {}
    real = newton_mod.fgmres

    def fgmres(*a, **k):
        x, info = real(*a, **k)
        infos.append(info)
        return x, info

    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)

    def after(t):
        stats.append(dict(sc.solver.step_stats))
        n = len(stats)
        if mode == "profile" and n == PROFILED[0] - 1:
            prof["p"] = profile(activities=acts)
            prof["p"].__enter__()
        elif mode == "profile" and n == PROFILED[-1]:
            prof["p"].__exit__(None, None, None)

    newton_mod.fgmres = fgmres
    try:
        if mode == "enable":
            trace.enable()
        sc.solve(str(tmp), afterStepCallback=after)
    finally:
        newton_mod.fgmres = real
        trace.disable()
    events = prof["p"].events() if prof else None
    return {"solver": sc.solver, "stats": stats, "infos": infos,
            "records": trace.records(), "events": events}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for mode in (None, "enable", "profile"):
        trace.disable()
        trace.reset()
        out[mode] = _run(tmp_path_factory.mktemp(f"trace_{mode}"), mode)
    trace.reset()
    return out


def test_off_is_the_shared_noop():
    a, b = trace.span("step"), trace.span("ksp")
    assert a is b
    with a:
        with trace.span("residual"):
            pass
    assert trace.records() == {"spans": [], "steps": {}}
    assert not trace._on


def test_switch_follows_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    trace.begin_step(1)
    assert not trace._on
    with trace.span("step"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trace.begin_step(2)
        assert trace._on
        with trace.span("step"):
            with trace.span("ksp"):
                trace.count("ksp_iters", 3)
    # the switch holds for the whole iteration, the profiler's stop aside
    with trace.span("early_stop"):
        pass
    trace.begin_step(3)
    assert not trace._on
    with trace.span("step"):
        pass
    trace.end_loop()
    rec = trace.records()
    assert [(s.name, s.step) for s in rec["spans"]] == [
        ("step", 2), ("ksp", 2), ("early_stop", 2)]
    assert rec["spans"][1].parent == rec["spans"][0].id
    assert rec["steps"] == {2: {"ksp_iters": 3}}
    names = [e.name for e in prof.events() if e.name.startswith("cfd.")]
    assert sorted(names) == ["cfd.ksp", "cfd.step"]


def test_enable_outside_a_loop_and_end_loop():
    trace.enable()
    with trace.span("pc_setup"):
        pass
    trace.begin_step(7)
    with trace.span("step"):
        pass
    trace.end_loop()
    assert trace._on  # enable() still holds
    spans = trace.records()["spans"]
    assert [(s.name, s.step) for s in spans] == [("pc_setup", None),
                                                  ("step", 7)]
    assert all(s.t1_ns >= s.t0_ns and s.counts is None for s in spans)
    trace.disable()
    trace.begin_step(8)
    assert not trace._on


def test_counters_live_in_the_trace_module():
    from cfdtpu_torch import kernels
    from cfdtpu_torch.la import gmres

    assert kernels.COUNTERS is trace.COUNTERS
    assert gmres.DISCARDED is trace.counter("ksp_discarded")
    assert kernels.counts is trace.counts
    trace.count("sup_spmv", 2)
    assert kernels.COUNTERS["sup_spmv"].n == 2
    kernels.reset_counts()
    assert kernels.counts()["sup_spmv"] == 0


def test_spans_nest_in_steps(runs):
    r = runs["enable"]["records"]
    spans = r["spans"]
    by_id = {s.id: s for s in spans}
    steps = [s for s in spans if s.name == "step"]
    assert [s.step for s in steps] == list(range(1, STEPS + 1))
    assert all(s.parent is None for s in steps)
    for s in spans:
        assert s.t0_ns <= s.t1_ns
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.step == s.step
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns
    parents = {}
    for s in spans:
        parents.setdefault(s.name, set()).add(
            None if s.parent is None else by_id[s.parent].name)
    assert parents["solve"] == {"step"}
    for name in ("bc", "build", "release", "residual", "norms", "ksp",
                 "post_step"):
        assert parents[name] == {"solve"}, name
    for name in ("jacobian", "assemble", "pc_setup", "pc.refit"):
        assert parents[name] == {"build"}, name
    assert parents["ksp.wait"] == {"ksp"}
    # the CPU has no CUDA graph and no allocator counts
    assert "pc.capture" not in parents and "pc.apply" not in parents
    assert all(s.counts is None for s in spans)


def test_counters_match_step_stats(runs):
    run = runs["enable"]
    steps = run["records"]["steps"]
    assert sorted(steps) == list(range(1, STEPS + 1))
    for i, st in enumerate(run["stats"], start=1):
        d = steps[i]
        assert d.get("ksp_iters", 0) == st["ksp_iters"]
        assert d.get("newton_iters", 0) == st["newton_iters"]
        assert d.get("rebuilds", 0) == int(st["rebuilt"])
        assert d.get("retries", 0) == int(st["retried"]) == 0
    assert [st["rebuilt"] for st in run["stats"]] == [True, False] * 2
    builds = [s.step for s in run["records"]["spans"] if s.name == "build"]
    assert builds == [1, 3]
    discarded = sum(info["discarded"] for info in run["infos"])
    assert sum(d.get("ksp_discarded", 0) for d in steps.values()) \
        == discarded
    assert sum(d.get("ksp_iters", 0) for d in steps.values()) == sum(
        info["iters"] for info in run["infos"])
    n_ksp = sum(1 for s in run["records"]["spans"] if s.name == "ksp")
    assert n_ksp == len(run["infos"])


def test_profiler_sees_the_profiled_steps_only(runs):
    run = runs["profile"]
    spans = run["records"]["spans"]
    assert sorted(run["records"]["steps"]) == list(PROFILED)
    assert {s.step for s in spans} == set(PROFILED)
    cfd = [e for e in run["events"] if e.name.startswith("cfd.")]
    assert sorted(e.name for e in cfd) == sorted("cfd." + s.name
                                                 for s in spans)
    assert sum(e.name == "cfd.step" for e in cfd) == len(PROFILED)
    # nothing recorded in the untraced runs' store
    assert runs[None]["records"] == {"spans": [], "steps": {}}


def test_tracing_leaves_the_solution_bit_for_bit(runs):
    ref = runs[None]["solver"]
    for mode in ("enable", "profile"):
        s = runs[mode]["solver"]
        assert torch.equal(s.u_sol, ref.u_sol) and torch.equal(s.p_sol,
                                                               ref.p_sol)
        assert runs[mode]["stats"] == runs[None]["stats"]


def test_outer_operator_is_spmv_rooflines(runs):
    s = runs[None]["solver"]
    path = os.path.join(REPO, "benchmark", "metrics", "spmv_roofline.py")
    spec = importlib.util.spec_from_file_location("_spmv_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mine, theirs = s.outer_operator(), mod.outer_operator(s)
    assert mine[1] == theirs[1] == s._ravel(s.u_sol, s.p_sol).numel()
    x = torch.linspace(-1.0, 1.0, mine[1], dtype=s.dtype)
    assert torch.equal(mine[0](x), theirs[0](x))


# ---------------------------------------------------------------------
# on the card


@pytest.fixture(scope="module")
def card_runs(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = {}
    for mode in ("enable", "profile"):
        trace.disable()
        trace.reset()
        out[mode] = _run(tmp_path_factory.mktemp(f"trace_card_{mode}"),
                         mode, "cuda")
    trace.reset()
    return out


@pytest.fixture
def card_run(card_runs):
    return card_runs["enable"]


@pytest.mark.gpu
def test_card_pc_capture_and_apply(card_run):
    spans = card_run["records"]["spans"]
    steps = card_run["records"]["steps"]
    by_id = {s.id: s for s in spans}
    total = {}
    for d in steps.values():
        for k, n in d.items():
            total[k] = total.get(k, 0) + n
    captures = [s for s in spans if s.name == "pc.capture"]
    refits = [s for s in spans if s.name == "pc.refit"]
    applies = [s for s in spans if s.name == "pc.apply"]
    # one graph for the solver's life, captured at its first application;
    # every later rebuild is refitted into it
    assert len(captures) == total["pc_captures"] == 1
    assert {by_id[s.parent].name for s in captures} == {"ksp"}
    assert len(refits) == total["pc_refits"] == total["rebuilds"] - 1 == 1
    assert {by_id[s.parent].name for s in refits} == {"build"}
    # one replay an FGMRES iteration queued, the discarded ones too
    assert len(applies) == total["pc_replays"] == (
        total["ksp_iters"] + total["ksp_discarded"])
    assert {by_id[s.parent].name for s in applies} == {"ksp"}


@pytest.mark.gpu
def test_card_allocator_counters(card_run):
    spans = card_run["records"]["spans"]
    steps = card_run["records"]["steps"]
    for s in spans:
        if s.name in trace.ALLOC_SPANS:
            assert set(s.counts) == {"cuda_malloc", "cuda_free"}
            assert min(s.counts.values()) >= 0
        else:
            assert s.counts is None
    for s in spans:
        if s.name == "step":
            d = steps[s.step]
            assert d.get("cuda_malloc", 0) == s.counts["cuda_malloc"]
            assert d.get("cuda_free", 0) == s.counts["cuda_free"]
    total = sum(d.get("cuda_malloc", 0) + d.get("cuda_free", 0)
                for d in steps.values())
    assert total > 0


@pytest.mark.gpu
def test_card_ranges_stay_on_the_host(card_runs):
    """The cfd.* ranges lie on the host timeline only: nothing of theirs
    is a device activity, so a trace's device busy time is the kernels'
    and copies' alone."""
    from torch.autograd import DeviceType

    run = card_runs["profile"]
    cfd = [e for e in run["events"] if e.name.startswith("cfd.")]
    assert cfd and all(e.device_type == DeviceType.CPU for e in cfd)
    assert sorted(e.name for e in cfd) == sorted(
        "cfd." + s.name for s in run["records"]["spans"])
    assert any(e.device_type == DeviceType.CUDA for e in run["events"])
