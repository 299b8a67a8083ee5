"""The plain reference against the program's CPU path (float64) on a
small mesh: the same residual at a random state, and the same time steps
when the program's Newton is run to the rounding floor."""

import os

import numpy as np
import pytest
import torch

from benchmark import cell as cellmod
from benchmark.checkpoint import write_checkpoint

SMALL = {"mesh": {"res_scale": 2.0}, "dtype": "float64"}
TIGHT = {"snes_rtol": 1e-13, "snes_atol": 1e-15, "snes_stol": 1e-15,
         "snes_lag_jacobian": False, "pc_lag_steps": 1, "stats_every": 1,
         "ksp_rtol": 1e-12}
CELLS = ["dfg2d1_developed", "dfg2d2_transient"]


def scenario(workload, seed, tmp_path, solver_kw=None):
    _, _, cell, config = cellmod.resolve(workload, config_patch=SMALL)
    if solver_kw:
        config["solver_kw"] = {**config["solver_kw"], **solver_kw}
    mesh = cellmod.make_mesh(config)
    prob = cellmod.make_problem(config, cell, mesh, "cpu")
    start = cellmod.start_state(config, cell, mesh, seed)
    ckpt = os.path.join(tmp_path, "start.npz")
    write_checkpoint(ckpt, *start, np.float64)
    sc = cellmod.build_scenario(config, cell, mesh, ckpt, "cpu")
    return sc, prob, start


@pytest.mark.parametrize("workload", CELLS)
def test_residual_matches_program(workload, tmp_path, caches):
    sc, prob, start = scenario(workload, 3, tmp_path)
    s = sc.solver
    rng = np.random.default_rng(0)
    n = prob.n
    u = start[0] + 0.05 * rng.standard_normal((n, 2))
    p = 0.1 * rng.standard_normal(n)
    up = start[0] + 0.02 * rng.standard_normal((n, 2))
    ru, rp = s.form.residual(torch.tensor(u), torch.tensor(p),
                             (torch.tensor(up),), s.params())
    X = prob.flat(u, p).reshape(n, 3)
    Xp = prob.flat(up, p).reshape(n, 3)
    re = prob.element_residual(X[prob.cells], Xp[prob.cells])
    r = torch.zeros(n, 3, dtype=torch.float64).index_add(
        0, prob.cells.reshape(-1), re.reshape(-1, 3))
    scale = float(ru.abs().max())
    assert float((r[:, :2] - ru).abs().max()) <= 1e-13 * scale
    assert float((r[:, 2] - rp).abs().max()) <= 1e-13 * float(rp.abs().max())
    # the same Dirichlet rows and values
    assert np.array_equal(np.sort(s.bc_dofs_u), np.flatnonzero(prob.bc_u))
    assert np.array_equal(np.sort(s.bc_dofs_p), np.flatnonzero(prob.bc_p))
    bu, _ = s._bc_values()
    assert np.abs(bu.numpy() - prob.g[s.bc_dofs_u]).max() <= 1e-15


class Stop(Exception):
    pass


@pytest.mark.parametrize("workload", CELLS)
def test_steps_match_program(workload, tmp_path, caches):
    sc, prob, start = scenario(workload, 4, tmp_path, TIGHT)
    s = sc.solver
    states = [start]

    def after(t):
        states.append((s.u_sol.numpy().copy(), s.p_sol.numpy().copy()))
        if len(states) == 3:
            raise Stop

    with pytest.raises(Stop):
        sc.solve(str(tmp_path / "out"), afterStepCallback=after)
    for (u0, p0), (u1, p1) in zip(states, states[1:]):
        ur, pr, _ = prob.step(u0, p0)
        assert np.abs(u1 - ur).max() <= 1e-10 * np.abs(ur).max()
        assert np.abs(p1 - pr).max() <= 1e-9 * np.abs(pr).max()


@pytest.mark.parametrize("workload", CELLS)
def test_mesh_is_the_programs(workload, caches):
    """The benchmark's frozen generator gives the program's mesh bit for
    bit at equal settings."""
    from cfdtpu_torch.geom.dfg import generate_dfg_mesh

    _, _, _, config = cellmod.resolve(workload, config_patch=SMALL)
    mine = cellmod.make_mesh(config)
    m = config["mesh"]["markers"]
    theirs = generate_dfg_mesh(
        res_scale=config["mesh"]["res_scale"], dtype=np.float64,
        inlet_marker=m["inlet"], outlet_marker=m["outlet"],
        wall_marker=m["wall"], obstacle_marker=m["obstacle"])
    for k in ("points", "cells", "facets", "facet_cells",
              "facet_local_index", "facet_tags"):
        assert np.array_equal(mine[k], getattr(theirs, k)), k


def test_parts_are_found_by_name():
    _, _, _, config = cellmod.resolve("dfg2d1_developed")
    for kind, name in (("meshes", config["mesh"]["generator"]),
                       ("problems", config["problem"])):
        assert os.path.exists(os.path.join(cellmod.BENCH_DIR, kind,
                                           f"{name}.py"))
    for bad in ({"problem": "no_such_problem"},
                {"mesh": {"generator": "../cell"}}):
        _, _, _, cfg = cellmod.resolve("dfg2d1_developed", config_patch=bad)
        with pytest.raises(cellmod.CellError):
            if "problem" in bad:
                cellmod.make_problem(cfg, {"dt": 0.05}, None, "cpu")
            else:
                cellmod.make_mesh(cfg)
