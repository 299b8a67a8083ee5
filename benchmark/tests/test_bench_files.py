"""BENCHMARK.json and the files it names keep to the benchmark's
contract: names, units, lengths, bounds, one file for each
configuration, cell and metric."""

import importlib
import inspect
import json
import os
import re

import pytest

from benchmark import judge
from benchmark.cell import BENCH_DIR, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def one_line(s, n=200):
    return isinstance(s, str) and 1 <= len(s) <= n and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert len(b["command"]) <= 32 and all(one_line(w) for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_check_fits_at_24_cells():
    rs = bench()["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_unique_and_allowed(kind):
    names = [e["name"] for e in bench()[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    b = bench()
    files = [c["file"] for c in b["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith("benchmark/configs/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert cfg["dtype"] in ("float32", "float64")
        # its mesh generator and its problem are files found by name
        for kind, name in (("meshes", cfg["mesh"]["generator"]),
                           ("problems", cfg["problem"])):
            assert os.path.exists(os.path.join(BENCH_DIR, kind,
                                               f"{name}.py"))


def solver_parameters(config_name) -> set:
    """The named parameters of a configuration's solver class."""
    b = bench()
    c = next(c for c in b["configs"] if c["name"] == config_name)
    with open(os.path.join(ROOT, c["file"])) as f:
        solver = json.load(f)["solver"]
    cls = importlib.import_module(f"cfdtpu_torch.solvers.{solver}").Solver
    return {k for k, p in inspect.signature(cls.__init__).parameters.items()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)}


def test_workloads():
    b = bench()
    pairs = set()
    configs = {c["name"] for c in b["configs"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and one_line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        with open(os.path.join(ROOT, "benchmark", "workloads",
                               f"{w['name']}.json")) as f:
            cell = json.load(f)
        assert (cell["name"], cell["config"], cell["traffic"]) == (
            w["name"], w["config"], w["traffic"])
        assert set(cell["limits"]) == set(judge.NAMES)
        lo, hi = cell["judged_steps"]
        assert 1 <= lo <= hi
        assert all(v > 0 for v in cell["limits"].values())
        if "solver_kw" in cell:
            # a cell's own solver settings name parameters of its
            # configuration's solver, which would otherwise drop them
            # into its **kwargs unread
            assert isinstance(cell["solver_kw"], dict)
            assert set(cell["solver_kw"]) <= solver_parameters(
                w["config"])
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(
        1, len(b["workloads"]) // 4)


def test_metrics():
    b = bench()
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for w in cells:
        # every cell reports setup_s, another end-to-end metric and a
        # per-layer metric; a per-layer metric's cells report what it moves
        mine = {m["name"] for m in b["end_to_end"]
                if w in m.get("workloads", cells)}
        assert "setup_s" in mine and len(mine) >= 2
        layer = [m for m in b["per_layer"] if w in m.get("workloads", cells)]
        assert layer and all(m["moves"] in mine for m in layer)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and one_line(m["layer"])
        assert m["moves"] in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics",
                                           f"{m['name']}.py"))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
