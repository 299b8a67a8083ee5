"""`correct` comes out false for each fault the cells can have, and for
the precision control; a sound run at the same small size comes out
true. A run here skips run.py's look for a card and drives the rest of a
run on the CPU, on a small mesh (res_scale 2.0, about 2,500 DOF) in the
configuration's own dtype, with the timed path broken underneath."""

import pytest

from benchmark import cell as cellmod
from benchmark import control, judge, run

SMALL = {"mesh": {"res_scale": 2.0}}
SHORT = {"warmup_steps": 2}
CELLS = ["dfg2d1_developed", "dfg2d2_transient"]
SEED = 2 ** 31 + 11


def execute(workload, break_solver=None, seconds=2.0):
    return run.execute(workload, SEED, seconds, 0, device="cpu",
                       config_patch=SMALL, cell_patch=SHORT,
                       break_solver=break_solver)


def unchanged_from(step):
    """Every step from `step` on returns the state it was given."""
    def brk(solver):
        orig = solver.solveStep
        count = [0]

        def step_fn():
            orig()
            count[0] += 1
            if count[0] >= step:
                solver.u_sol, solver.p_sol = solver.u_prev, solver.p_prev
        solver.solveStep = step_fn
    return brk


def altered(solver):
    """One velocity value of every step's answer is changed."""
    orig = solver.solveStep

    def step_fn():
        orig()
        u = solver.u_sol.clone()
        u[len(u) // 2, 0] += 0.1 * float(u.abs().max())
        solver.u_sol = u
    solver.solveStep = step_fn


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload, caches):
    result, chk, info = execute(workload)
    assert info["steps"] >= 1 and result["failed"] == 0
    assert result["correct"], chk


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["unchanged_all", "unchanged_window",
                                   "altered"])
def test_fault_is_caught(workload, fault, caches):
    brk = {"unchanged_all": unchanged_from(1),
           "unchanged_window": unchanged_from(SHORT["warmup_steps"] + 1),
           "altered": altered}[fault]
    result, chk, _ = execute(workload, brk)
    assert not result["correct"], chk
    if fault.startswith("unchanged"):
        # an unchanged step reads 1 on the judged step, however little
        # the flow still changes there
        assert chk["judged_du"]["value"] == 1.0


@pytest.mark.parametrize("workload", CELLS)
def test_judged_step_is_drawn_from_the_seed(workload):
    _, _, cell, _ = cellmod.resolve(workload)
    lo, hi = cell["judged_steps"]
    drawn = {cellmod.judged_step(cell, SEED + k) for k in range(50)}
    assert min(drawn) >= lo and max(drawn) <= hi and len(drawn) > 10
    assert cellmod.judged_step(cell, SEED) == cellmod.judged_step(cell, SEED)


@pytest.mark.parametrize("workload", CELLS)
def test_precision_control_fails(workload, caches):
    result, chk, info = execute(workload)
    _, _, cell, config = cellmod.resolve(workload, config_patch=SMALL,
                                         cell_patch=SHORT)
    mesh = cellmod.make_mesh(config)
    ctl = control.control_readings(config, cell, mesh, "cpu", info["states"])
    c = judge.checks(ctl, cell["limits"])
    assert not judge.passed(c), c
