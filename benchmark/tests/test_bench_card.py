"""On a card: a short run of each cell through run.py gives a result
line of the contract's form, with `correct` true."""

import json
import subprocess
import sys

import pytest

from benchmark.cell import ROOT

CELLS = ["dfg2d1_developed", "dfg2d2_transient", "dfg2d1_rebuild"]


def run_cell(workload, trace, seconds=4):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 3), "--seconds", str(seconds), "--trace",
         str(trace)], capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_result_line(card, workload, trace):
    res, err = run_cell(workload, trace)
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    dev = res["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["memory_peak_bytes"] > 0
    with open(f"{ROOT}/BENCHMARK.json") as f:
        bench = json.load(f)
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in bench[kind]
             if workload in m.get("workloads", [workload])}
    assert set(res["metrics"]) <= names
    if trace:
        assert dev["busy_s"] > 0 and dev["window_s"] > 0
        assert len(res["breakdown"]["device_ops"]) <= 10
    else:
        assert set(res["metrics"]) == names
    assert err.strip().splitlines()[-1].startswith("check last_p")
