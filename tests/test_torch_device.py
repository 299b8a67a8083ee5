"""The port's entry points default to the CUDA card and never fall back
to the CPU: resolve_device(None), the solver and scenario constructors
without `device`, and the CLI without --device. On a machine with no
card (or with the card hidden) each of them raises or exits non-zero
before any work is done; the CPU runs only when asked for. The library
classes below them take no default at all: their caller names the
device.
"""

import inspect
import os
import subprocess
import sys

import pytest
import torch

from cfdtpu_torch import kernels
from cfdtpu_torch.la.amg import AMG, AMGLevel, BlockAMG
from cfdtpu_torch.la.ras import RASPrecond
from cfdtpu_torch.la.superell import SuperMaps
from cfdtpu_torch.postprocess.forces import BoundaryForce
from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark
from cfdtpu_torch.scenarios.dfg_2d_1 import DFG2D1Steady
from cfdtpu_torch.scenarios.pipe_cylinder_pressurebc import (
    PipeCylinderPressureBC)
from cfdtpu_torch.scripts.gather_micro import patch_inputs
from cfdtpu_torch.solvers.base import SolverBase
from cfdtpu_torch.solvers.stabilized_schur import Solver
from cfdtpu_torch.utils import SortedScatter

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_default_is_the_card(no_card, monkeypatch):
    from cfdtpu_torch.utils import resolve_device, resolve_dtype

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_dtype("auto")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("cls", [SolverBase, Solver, DFG1Benchmark,
                                 DFG2D1Steady, PipeCylinderPressureBC])
def test_constructor_device_defaults_to_none(cls):
    assert inspect.signature(cls.__init__).parameters["device"].default \
        is None


@pytest.mark.parametrize("fn", [SortedScatter.__init__, SuperMaps.__init__,
                                AMGLevel.__init__, AMG.__init__,
                                RASPrecond.__init__, BoundaryForce.__init__,
                                patch_inputs])
def test_library_classes_take_no_default_device(fn):
    """No library constructor defaults to the CPU (or to anything): a
    direct caller names the device its maps go to."""
    param = inspect.signature(fn).parameters["device"]
    assert param.default is inspect.Parameter.empty


def test_library_class_without_device_raises():
    import numpy as np

    with pytest.raises(TypeError, match="device"):
        SortedScatter(np.array([0, 1, 1]), 2)
    with pytest.raises(TypeError, match="device"):
        BlockAMG(np.array([0, 1]), np.array([1, 0]), 2, d=2)
    assert SortedScatter(np.array([0, 1, 1]), 2,
                         device="cpu").row_ptr.device.type == "cpu"


def test_scenario_without_device_raises(no_card):
    kernels.reset_counts()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DFG1Benchmark("stabilized_schur", dt=0.05, T=0.05, res_scale=2.5)
    assert kernels.counts() == {name: 0 for name in kernels.COUNTERS}


@pytest.mark.parametrize("solver", [
    "dfg_2d_1", "stabilized_schur_bdf2", "stabilized_schur_backflow",
    "stabilized_schur_ramping", "stabilized_schur_adaptive"])
def test_new_solvers_without_device_raise(no_card, solver):
    """The dfg_2d_1 scenario and the solver variants take the card by
    default too."""
    kernels.reset_counts()
    cls = DFG2D1Steady if solver == "dfg_2d_1" else DFG1Benchmark
    size = {"res": 0.04} if solver == "dfg_2d_1" else {"res_scale": 2.5}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cls(solver, dt=0.05, T=0.05, v_max=0.3, **size)
    assert kernels.counts() == {name: 0 for name in kernels.COUNTERS}


@pytest.mark.parametrize("solver, kw", [
    ("stabilized_schur_pressurebc", {}),
    ("stabilized_schur_pressure_backflow", {"R_resistance": 1.0}),
    ("stabilized_schur_velocity_vascular_backflow",
     {"R_resistance": 1.0, "v_max": 0.3}),
    ("stabilized_schur_vascularbc", {"R_resistance": 1.0}),
    ("stabilized_schur_vascularbc_weak", {"R_resistance": 1.0}),
    ("stabilized_schur_vascularbc_backflow", {}),
    ("stabilized_schur_vascularbc_strong", {"R_resistance": 1.0}),
    ("stabilized_schur_vascularbc_cbc", {"v_max": 0.3}),
    ("stabilized_schur_vascularbc_ddn", {}),
])
def test_weak_pressure_solvers_without_device_raise(no_card, solver, kw):
    """pipe_cylinder_pressurebc and the weak-pressure family take the
    card by default: with none they raise before anything is built."""
    kernels.reset_counts()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PipeCylinderPressureBC(solver, dt=0.05, T=0.05, res_scale=2.5,
                               p_inlet=0.15, p_outlet=0.0, **kw)
    assert kernels.counts() == {name: 0 for name in kernels.COUNTERS}


def test_pressurebc_cli_without_device_exits_nonzero(tmp_path):
    """`--simulation pipe_cylinder_pressurebc --solver
    stabilized_schur_pressurebc` with no --device and no card exits
    non-zero at construction."""
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "cfdtpu_torch", "simulate",
           "--simulation", "pipe_cylinder_pressurebc", "--solver",
           "stabilized_schur_pressurebc", "--T", "0.05", "--dt", "0.05",
           "--res_scale", "2.5", "--p_inlet", "0.15", "--p_outlet", "0",
           "--output_dir", str(out)]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0, res.stdout + res.stderr
    assert "CUDA is not available" in res.stdout + res.stderr
    assert "Solver converged" not in res.stdout
    assert not out.exists()


def test_cli_default_device_is_cuda():
    from cfdtpu_torch.__main__ import build_parser

    args, _ = build_parser().parse_known_args(
        ["simulate", "--simulation", "dfg_1", "--solver",
         "stabilized_schur", "--T", "0.05", "--dt", "0.05"])
    assert args.device == "cuda"


def test_cli_without_device_exits_nonzero(tmp_path):
    """`python -m cfdtpu_torch simulate` with no --device and no card
    (CUDA_VISIBLE_DEVICES empty) exits 1 at construction: no step runs
    and no run directory is written."""
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "cfdtpu_torch", "simulate",
           "--simulation", "dfg_1", "--solver", "stabilized_schur",
           "--T", "0.05", "--dt", "0.05", "--res_scale", "2.5",
           "--output_dir", str(out)]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0, res.stdout + res.stderr
    assert "CUDA is not available" in res.stdout + res.stderr
    assert "Solver converged" not in res.stdout
    assert not out.exists()


@pytest.mark.parametrize("timer", ["cuda_ms", "device_ms", "empty_ms",
                                   "launches"])
def test_timers_refuse_a_machine_without_a_card(no_card, timer):
    """The timers measure the card: with none they raise, and nothing
    is timed on the CPU in its place."""
    from cfdtpu_torch.utils import cudatime

    fn = getattr(cudatime, timer)
    with pytest.raises(RuntimeError, match="none is available"):
        fn() if timer == "empty_ms" else fn(lambda: None)


def test_dfg2d1_cli_without_device_exits_nonzero(tmp_path):
    """The same for `--simulation dfg_2d_1 --solver dfg_2d_1`."""
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "cfdtpu_torch", "simulate",
           "--simulation", "dfg_2d_1", "--solver", "dfg_2d_1",
           "--T", "0.05", "--dt", "0.05", "--res", "0.04",
           "--output_dir", str(out)]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0, res.stdout + res.stderr
    assert "CUDA is not available" in res.stdout + res.stderr
    assert "DFG Metrics" not in res.stdout
    assert not out.exists()


# the 2D scenarios: (module, class, constructor arguments of a tiny run)
SCENARIOS_2D = [
    ("lid_driven2D", "LidDriven2DSimulation", dict(nx=4, mu=0.01)),
    ("unit_square", "UnitSquareSimulation", dict(nx=4)),
    ("unit_square_pipe", "UnitSquarePipeSimulation",
     dict(nx=8, ny=2, p_inlet=1.0, p_outlet=0.0)),
    ("pipe_cylinder", "PipeCylinderSimulation", dict(res_scale=3.0)),
    ("pipe_cylinder", "PipeCylinder2D2Simulation", dict(res_scale=3.0)),
    ("pipe_cylinder_2d2", "PipeCylinder2D2", dict(res_scale=3.0)),
    ("stenosis", "StenosisSimulation", dict(res=1.0)),
    ("stenosis_pressure", "StenosisPressureSimulation",
     dict(res=1.0, R_resistance=1.0)),
    ("stenosis_pressure_structured", "StenosisPressureStructuredSimulation",
     dict(res=1.0, R_resistance=1.0)),
    ("stenosis_mesh_variable", "StenosisMeshVariableSimulation",
     dict(res=1.0, n_rad=3)),
    ("stenosis_with_tree_2d", "StenosisWithTree2DSimulation",
     dict(res=1.0)),
    ("stenosis_with_tree_2d_pressure", "StenosisWithTree2DPressureSimulation",
     dict(res=1.0)),
]


def _scenario_class(module, name):
    import importlib

    return getattr(importlib.import_module(
        f"cfdtpu_torch.scenarios.{module}"), name)


@pytest.mark.parametrize("module, name, kw", SCENARIOS_2D)
def test_2d_scenarios_without_device_raise(no_card, module, name, kw):
    """The 2D scenarios take the card by default (`device` defaults to
    None, in the class or the base it passes it to): with none they
    raise before any kernel is launched."""
    cls = _scenario_class(module, name)
    owner = next(c for c in cls.__mro__
                 if "device" in inspect.signature(c.__init__).parameters)
    assert inspect.signature(owner.__init__).parameters["device"].default \
        is None
    solver = ("stabilized_schur_pressure_backflow" if "R_resistance" in kw
              else "stabilized_schur_pressurebc"
              if module.startswith("stenosis") else "stabilized_schur")
    kernels.reset_counts()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cls(solver, dt=0.005, T=0.005, **kw)
    assert kernels.counts() == {name: 0 for name in kernels.COUNTERS}


def test_validation_scripts_default_to_the_card(no_card, tmp_path,
                                                monkeypatch):
    """validate_ghia and validate_dfg2d2 run on the card unless told
    otherwise: with none they raise, and write no results directory."""
    from cfdtpu_torch.scripts import validate_dfg2d2, validate_ghia

    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        validate_ghia.run(100, nx=4, n_steps=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        validate_ghia.main(["100"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        validate_dfg2d2.main(["3.0", "0.01", "0.01"])
    assert os.listdir(tmp_path) == []
