"""cfdtpu_torch host layer: the copied numpy code must build exactly the
arrays cfdtpu builds (meshes, dofmaps, BC dofs and every static index
map of the DFG 2D-1 slice), the package must never import JAX, and a
CUDA device without CUDA must raise.

Comparisons here are exact (array_equal): the host layer is the same
numpy code on the same inputs.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cfdtpu.geom.dfg import generate_dfg_mesh as jax_dfg_mesh
from cfdtpu.scenarios.dfg_1 import DFG1Benchmark as JaxDFG

from cfdtpu_torch.geom.dfg import generate_dfg_mesh as torch_dfg_mesh
from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark as TorchDFG

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE = dict(pc_inner_method="amg_p", pc_inner_u=6, pc_inner_p=10,
             snes_lag_jacobian=True, pc_lag_steps=4, stats_every=1,
             ksp_restart=20)


@pytest.fixture(scope="module")
def pair():
    kw = dict(dt=0.05, T=1.0, res_scale=1.0, dtype="float64", **SLICE)
    return (JaxDFG("stabilized_schur", **kw),
            TorchDFG("stabilized_schur", device="cpu", **kw))


@pytest.mark.parametrize("res_scale", [1.0, 2.5])
def test_mesh_identical_uncached(monkeypatch, res_scale):
    monkeypatch.setenv("CFDTPU_MESH_CACHE", "")
    a = jax_dfg_mesh(res_scale=res_scale)
    b = torch_dfg_mesh(res_scale=res_scale)
    for name in ("points", "cells", "facets", "facet_cells",
                 "facet_local_index", "facet_tags"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    np.testing.assert_array_equal(a.h(), b.h())


def test_spaces_and_bcs_identical(pair):
    js, ts = pair[0].solver, pair[1].solver
    for sp in ("V", "Q"):
        np.testing.assert_array_equal(getattr(js, sp).dofmap,
                                      getattr(ts, sp).dofmap)
        np.testing.assert_array_equal(getattr(js, sp).dof_coords,
                                      getattr(ts, sp).dof_coords)
    np.testing.assert_array_equal(js.bc_dofs_u, ts.bc_dofs_u)
    np.testing.assert_array_equal(js.bc_dofs_p, ts.bc_dofs_p)
    assert js.pin_pressure == ts.pin_pressure


def test_scatters_identical(pair):
    jf, tf = pair[0].solver.form, pair[1].solver.form
    for name in ("_scatter_u", "_scatter_p", "_scatter_flat"):
        a, b = getattr(jf, name), getattr(tf, name)
        assert a.K == b.K
        np.testing.assert_array_equal(np.asarray(a.ell_idx),
                                      b.ell_idx.numpy())
    np.testing.assert_array_equal(jf._dmf_np, tf._dmf_np)


def test_nodebsr_maps_identical(pair):
    jb, tb = pair[0].solver._nodebsr, pair[1].solver._nodebsr
    np.testing.assert_array_equal(np.asarray(jb.block_row),
                                  tb.block_row_np)
    np.testing.assert_array_equal(np.asarray(jb.block_col),
                                  tb.block_col_np)
    np.testing.assert_array_equal(np.asarray(jb._assemble_scatter.ell_idx),
                                  tb._assemble_scatter.ell_idx.numpy())
    np.testing.assert_array_equal(np.asarray(jb._sup.sup_cols),
                                  tb._sup.sup_cols.numpy())
    np.testing.assert_array_equal(jb._sup.pair_slot, tb._sup.pair_slot)
    np.testing.assert_array_equal(np.asarray(jb._sup_pos).reshape(-1),
                                  tb._sup_pos.numpy())


def test_sp_structure_identical(pair):
    jb, tb = pair[0].solver._nodebsr, pair[1].solver._nodebsr
    jrow, jcol, jn = jb.sp_structure()
    trow, tcol, tn = tb.sp_structure()
    assert jn == tn
    np.testing.assert_array_equal(np.asarray(jrow), trow)
    np.testing.assert_array_equal(np.asarray(jcol), tcol)
    for name in ("_sp_e1", "_sp_e2", "_sp_K", "_sp_app_pos",
                 "_sp_diag_pos"):
        np.testing.assert_array_equal(np.asarray(getattr(jb, name)),
                                      getattr(tb, name).numpy())
    np.testing.assert_array_equal(np.asarray(jb._sp_scatter.ell_idx),
                                  tb._sp_scatter.ell_idx.numpy())


def test_amg_hierarchy_identical(pair):
    ja = pair[0].solver._nodebsr.sp_amg()
    ta = pair[1].solver._nodebsr.sp_amg()
    assert len(ja.levels) == len(ta.levels) >= 1
    for jl, tl in zip(ja.levels, ta.levels):
        np.testing.assert_array_equal(np.asarray(jl.agg), tl.agg.numpy())
        assert jl.n_coarse == tl.n_coarse
        for x, y in zip(jl.coarse_coo, tl.coarse_coo):
            np.testing.assert_array_equal(np.asarray(x), y)
    for (jm, jpos), (tm, tpos) in zip(ja.sup, ta.sup):
        np.testing.assert_array_equal(np.asarray(jm.sup_cols),
                                      tm.sup_cols.numpy())
        np.testing.assert_array_equal(np.asarray(jpos), tpos.numpy())
    assert ja.n_coarsest == ta.n_coarsest


def test_port_never_imports_jax(tmp_path):
    """A fresh interpreter builds the DFG slice and the weak-pressure
    scenario with cfdtpu_torch alone, imports every solver of the
    weak-pressure family, every 2D scenario, the geometry and
    validation modules and both validation scripts, and runs a step of
    the cavity and of the stenosis: neither jax nor cfdtpu may end up
    in sys.modules."""
    code = (
        "import sys\n"
        "from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark\n"
        "import cfdtpu_torch.__main__, cfdtpu_torch.simulation\n"
        "import cfdtpu_torch.io.state, cfdtpu_torch.la.ras\n"
        "import cfdtpu_torch.scripts.gather_micro\n"
        "import importlib\n"
        "for m in ('pressurebc', 'pressure_backflow',\n"
        "          'velocity_vascular_backflow', 'vascularbc',\n"
        "          'vascularbc_weak', 'vascularbc_backflow',\n"
        "          'vascularbc_strong', 'vascularbc_cbc',\n"
        "          'vascularbc_ddn'):\n"
        "    importlib.import_module(\n"
        "        'cfdtpu_torch.solvers.stabilized_schur_' + m)\n"
        "from cfdtpu_torch.scenarios.pipe_cylinder_pressurebc import \\\n"
        "    PipeCylinderPressureBC\n"
        "for m in ('validation', 'validation.ghia', 'validation.dfg',\n"
        "          'geom.stenosis2d', 'geom.tree', 'geom.tree.tree_2d',\n"
        "          'geom.tree_mesh2d', 'scenarios.lid_driven2D',\n"
        "          'scenarios.unit_square', 'scenarios.unit_square_pipe',\n"
        "          'scenarios.pipe_cylinder', 'scenarios.pipe_cylinder_2d2',\n"
        "          'scenarios.stenosis', 'scenarios.stenosis_pressure',\n"
        "          'scenarios.stenosis_pressure_structured',\n"
        "          'scenarios.stenosis_mesh_variable',\n"
        "          'scenarios.stenosis_with_tree_2d',\n"
        "          'scenarios.stenosis_with_tree_2d_pressure',\n"
        "          'scripts.validate_ghia', 'scripts.validate_dfg2d2'):\n"
        "    importlib.import_module('cfdtpu_torch.' + m)\n"
        "from cfdtpu_torch.scripts.validate_ghia import solve_case\n"
        "assert solve_case(100, nx=4, n_steps=1, device='cpu')['steps'] == 1\n"
        "from cfdtpu_torch.validation.dfg import featflow_reference_stats\n"
        "featflow_reference_stats(2)\n"
        "from cfdtpu_torch.scenarios.stenosis import StenosisSimulation\n"
        "StenosisSimulation('stabilized_schur_pressurebc', dt=0.005,\n"
        "                   T=0.005, res=1.0, device='cpu').solver.solveStep()\n"
        "sc = DFG1Benchmark('stabilized_schur', dt=0.05, T=0.05,\n"
        "                   res_scale=2.5, device='cpu',\n"
        "                   pc_inner_method='rasamg_sup', pc_inner_u=0)\n"
        "sc.solver.solveStep()\n"
        "sc = PipeCylinderPressureBC(\n"
        "    'stabilized_schur_pressure_backflow', dt=0.05, T=0.05,\n"
        "    res_scale=2.5, p_inlet=0.15, p_outlet=0.0, R_resistance=1.0,\n"
        "    device='cpu')\n"
        "sc.solver.solveStep()\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'cfdtpu')]\n"
        "assert not bad, bad\n"
        "print('NOJAX_OK')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "NOJAX_OK" in res.stdout


def test_cuda_device_without_cuda_raises(monkeypatch):
    """device='cuda' with no usable CUDA must raise, not fall back."""
    from cfdtpu_torch.utils import resolve_device, resolve_dtype

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_dtype("auto", "cuda")
    with pytest.raises(RuntimeError):
        TorchDFG("stabilized_schur", dt=0.05, T=0.05, res_scale=2.5,
                 device="cuda")


def test_auto_dtype_by_device():
    from cfdtpu_torch.utils import resolve_dtype

    assert resolve_dtype("auto", "cpu") == np.float64
    assert resolve_dtype("float32", "cpu") == np.float32


@pytest.mark.parametrize("kw", [
    {"pc_type": "pcd"},
    {"pc_type": "lsc"},
    {"operator_format": "element"},
    {"supernode_g": 1},
    {"pc_dtype": "auto"},
    {"pc_dtype": "bf16"},
    {"n_shards": 2},
])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError):
        TorchDFG("stabilized_schur", dt=0.05, T=0.05, res_scale=2.5,
                 device="cpu", **kw)
