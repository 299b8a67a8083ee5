"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program; run.py without a card exits
non-zero and prints no result."""

import json
import os
import subprocess
import sys

from benchmark.cell import ROOT

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(imports: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=ROOT, imports=imports)],
        capture_output=True, text=True, check=True, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = loaded("import runpy; runpy.run_path('benchmark/run.py', "
                  "run_name='probe')\n"
                  "from benchmark import cell, judge, tracewin, control\n"
                  "from benchmark.reference import ns\n"
                  "import cfdtpu_torch.scenarios.dfg_1, "
                  "cfdtpu_torch.scenarios.pipe_cylinder")
    assert not mods & {"jax", "jaxlib", "flax", "cfdtpu"}
    assert "cfdtpu_torch" in mods


def test_reference_loads_nothing_of_the_program():
    mods = loaded("from benchmark.reference import ns\n"
                  "from benchmark import checkpoint, judge, peaks\n"
                  "from benchmark.meshes import dfg\n"
                  "from benchmark.problems import dfg_channel")
    assert not mods & {"jax", "jaxlib", "flax", "cfdtpu", "cfdtpu_torch"}


def test_run_without_a_card_exits_nonzero():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "dfg2d1_developed", "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
