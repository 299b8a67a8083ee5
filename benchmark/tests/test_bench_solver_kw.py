"""A cell's own solver settings (its file's `solver_kw`) reach the solver
over the configuration's, and the run records them; spmv_roofline finds
its operator in a solver that carries none between steps. On the CPU at
a small size (res_scale 2.0)."""

import numpy as np
import pytest
import torch

from benchmark import cell as cellmod
from benchmark import run
from benchmark.checkpoint import write_checkpoint
from benchmark.tests.test_bench_sparsity import load_module

SMALL = {"mesh": {"res_scale": 2.0}}


def build(workload, tmp_path, **patch):
    _, _, cell, config = cellmod.resolve(workload,
                                         config_patch={**SMALL, **patch})
    mesh = cellmod.make_mesh(config)
    start = cellmod.start_state(config, cell, mesh, 5)
    ckpt = str(tmp_path / "start.npz")
    write_checkpoint(ckpt, *start, np.dtype(config["dtype"]))
    sc = cellmod.build_scenario(config, cell, mesh, ckpt, "cpu")
    return sc, cell, config


@pytest.mark.parametrize("workload,lag,jac_lag", [
    ("dfg2d1_rebuild", 1, False), ("dfg2d1_developed", 4, True)])
def test_cell_settings_reach_the_solver(workload, lag, jac_lag, tmp_path,
                                        caches):
    sc, cell, config = build(workload, tmp_path)
    s = sc.solver
    assert s.pc_lag_steps == lag and s.newton_params.jac_lag is jac_lag
    # the configuration's other settings are the solver's in both cells
    kw = config["solver_kw"]
    assert (s.pc_inner_method, s.pc_inner_u, s.pc_inner_p, s.pc_ras_size,
            s.stats_every, s.newton_params.ksp_restart) == (
        kw["pc_inner_method"], kw["pc_inner_u"], kw["pc_inner_p"],
        kw["pc_ras_size"], kw["stats_every"], kw["ksp_restart"])


def test_cell_settings_over_the_configurations():
    _, _, cell, config = cellmod.resolve("dfg2d1_rebuild")
    kw = cellmod.solver_kw(config, cell)
    assert kw == {**config["solver_kw"], "pc_lag_steps": 1,
                  "snes_lag_jacobian": False}
    assert config["solver_kw"]["pc_lag_steps"] == 4  # not changed in place
    _, _, cell, config = cellmod.resolve("dfg2d1_developed")
    assert "solver_kw" not in cell
    assert cellmod.solver_kw(config, cell) == config["solver_kw"]


def test_the_run_records_the_settings(caches):
    _, chk, info = run.execute("dfg2d1_rebuild", 2 ** 31 + 21, 1.0, 0,
                               device="cpu", config_patch=SMALL,
                               cell_patch={"warmup_steps": 2})
    assert info["solver_kw"]["pc_lag_steps"] == 1
    assert info["solver_kw"]["snes_lag_jacobian"] is False
    assert info["solver_kw"]["pc_inner_method"] == "rasamg_sup"


def test_roofline_operator_of_a_solver_without_one(tmp_path, caches):
    """pc_lag_steps 1 keeps no operator between steps: spmv_roofline's
    operator is then the outer Jacobian at the window's last state, whose
    product agrees with central differences of the program's residual
    there (float64)."""
    sc, _, _ = build("dfg2d1_rebuild", tmp_path, dtype="float64")
    s = sc.solver
    window = cellmod.Window(s, 1, 0.0)
    cellmod.run_window(sc, window, str(tmp_path / "out"))
    assert window.error is None and s._op_state is None
    apply, n = load_module("spmv_roofline").outer_operator(s)
    x0 = s._ravel(s.u_sol, s.p_sol)
    assert n == x0.numel()
    aux, prm = s._aux(), s.params()

    def F(x):
        return s._ravel(*s.form.residual(*s._unravel(x), aux, prm))

    v = torch.rand(n, generator=torch.Generator().manual_seed(0),
                   dtype=torch.float64)
    eps = 1e-6
    fd = (F(x0 + eps * v) - F(x0 - eps * v)) / (2 * eps)
    assert float((apply(v) - fd).abs().max()) <= 1e-6 * float(fd.abs().max())
