"""The readers of the program's spans and counters (benchmark/spans.py
and the four metrics that use it) on synthetic records."""

import sys
from types import SimpleNamespace

import pytest
import torch

from benchmark.run import load_reader

READERS = ("build_ms_per_rebuild", "ksp_host_ms_per_ksp",
           "discarded_per_ksp", "device_allocs_per_step")
MS = 1_000_000  # ns


def span(i, name, parent, step, t0_ms, t1_ms):
    from cfdtpu_torch.utils.trace import Span

    return Span(i, name, parent, step, t0_ms * MS, t1_ms * MS, None)


def two_steps():
    """Steps 5 (a rebuild) and 6."""
    spans = [
        span(2, "step", None, 5, 20, 120),
        span(3, "build", 2, 5, 21, 61), span(4, "jacobian", 3, 5, 21, 40),
        span(5, "release", 2, 5, 61, 66),
        span(6, "ksp", 2, 5, 70, 110),
        span(7, "ksp.wait", 6, 5, 71, 72),
        span(8, "pc.capture", 6, 5, 72, 92),
        span(9, "pc.apply", 6, 5, 92, 93),
        span(10, "ksp.wait", 9, 5, 92, 92.5),
        span(11, "step", None, 6, 130, 150),
        span(12, "ksp", 11, 6, 131, 141),
        span(13, "ksp.wait", 12, 6, 132, 136),
    ]
    steps = {5: {"rebuilds": 1, "ksp_iters": 10, "ksp_discarded": 1,
                 "cuda_malloc": 7, "cuda_free": 3},
             6: {"ksp_iters": 10, "ksp_discarded": 1, "cuda_malloc": 2}}
    return {"spans": spans, "steps": steps}


@pytest.fixture
def records(monkeypatch):
    from cfdtpu_torch.utils import trace

    rec = {}
    monkeypatch.setattr(trace, "records", lambda: rec)
    return rec


def ctx(n_steps=2, device="cuda"):
    return SimpleNamespace(trace_steps=[{}] * n_steps,
                           device=torch.device(device))


def test_readers_arithmetic(records):
    records.update(two_steps())
    got = {name: load_reader(name)(ctx()) for name in READERS}
    # build 40 + release 5 + pc.capture 20 ms over 1 rebuild
    assert got["build_ms_per_rebuild"] == pytest.approx(65.0)
    # ksp 40 + 10 ms, less its waits (1, the 0.5 in pc.apply, 4) and the
    # capture (20), over 20 iterations
    assert got["ksp_host_ms_per_ksp"] == pytest.approx(24.5 / 20)
    assert got["discarded_per_ksp"] == pytest.approx(10.0)
    assert got["device_allocs_per_step"] == pytest.approx(12 / 2)


def step_path():
    """One step of the solver's step path (pc_lag_steps 1): the Jacobian
    built twice, the PC set up and refitted at its first application,
    inside ksp."""
    spans = [
        span(2, "step", None, 5, 0, 100),
        span(3, "build", 2, 5, 1, 4), span(4, "jacobian", 3, 5, 1, 3),
        span(5, "build", 2, 5, 4, 7),
        span(6, "ksp", 2, 5, 10, 60),
        span(7, "pc_setup", 6, 5, 11, 23),
        span(8, "pc.refit", 6, 5, 23, 24),
        span(9, "pc.apply", 6, 5, 24, 25),
        span(10, "ksp.wait", 6, 5, 30, 32),
    ]
    return {"spans": spans, "steps": {5: {"rebuilds": 1, "pc_refits": 1,
                                          "ksp_iters": 10}}}


def test_readers_on_the_step_path(records):
    records.update(step_path())
    # two builds (3 + 3 ms), pc_setup 12 and pc.refit 1 outside them
    assert load_reader("build_ms_per_rebuild")(ctx(1)) == pytest.approx(19.0)
    # ksp 50 ms less the set-up, the refit and the wait, over 10
    assert load_reader("ksp_host_ms_per_ksp")(ctx(1)) == pytest.approx(3.5)
    # inside build they count once, and ksp keeps its own time
    rec = step_path()
    rec["spans"][4:8] = [span(7, "pc_setup", 5, 5, 4, 6),
                         span(8, "pc.refit", 5, 5, 6, 7),
                         span(6, "ksp", 2, 5, 10, 60),
                         span(9, "pc.apply", 6, 5, 24, 25)]
    records.clear()
    records.update(rec)
    assert load_reader("build_ms_per_rebuild")(ctx(1)) == pytest.approx(6.0)
    assert load_reader("ksp_host_ms_per_ksp")(ctx(1)) == pytest.approx(4.8)


def test_step_count_guard(records):
    records.update(two_steps())
    for n in (0, 1, 3):
        assert all(load_reader(name)(ctx(n)) is None for name in READERS)
    # a step span twice: not the traced window either
    rec = two_steps()
    rec["spans"].append(span(14, "step", None, 6, 160, 170))
    records.clear()
    records.update(rec)
    assert all(load_reader(name)(ctx(3)) is None for name in READERS)


def test_nothing_to_divide_by(records):
    rec = two_steps()
    for d in rec["steps"].values():
        d.pop("rebuilds", None)
        d.pop("ksp_iters", None)
    records.update(rec)
    for name in READERS[:3]:
        assert load_reader(name)(ctx()) is None
    assert load_reader("device_allocs_per_step")(ctx()) == 6.0


def test_allocs_none_off_the_card(records):
    records.update(two_steps())
    assert load_reader("device_allocs_per_step")(ctx(device="cpu")) is None
    assert load_reader("discarded_per_ksp")(ctx(device="cpu")) == 10.0


def test_a_program_without_the_trace_module(records, monkeypatch):
    # a program that has no trace module: nothing to read, no error
    import cfdtpu_torch.utils

    records.update(two_steps())
    assert load_reader("discarded_per_ksp")(ctx()) == 10.0
    monkeypatch.delattr(cfdtpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "cfdtpu_torch.utils.trace", None)
    assert all(load_reader(name)(ctx()) is None for name in READERS)
