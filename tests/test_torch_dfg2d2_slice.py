"""DFG 2D-2 (PipeCylinder2D2Simulation, Re = 100) on the port:

- two steps at res_scale 3.0 (dt 0.01, stabilized_schur at its
  defaults, float64 on the CPU) against cfdtpu: equal Newton and KSP
  counts, and every bdforces.txt row (index, time, c_D, c_L) within
  1e-10 relative of cfdtpu's;
- the force recorder keeps the pairs on the device and reads them to
  the host only when it flushes (every FLUSH_ROWS steps, before each
  checkpoint save, at the end), and Scenario.solve calls the step
  callback, then pre_checkpoint, then saves;
- cfdtpu's resume tests (tests/test_dfg.py) on the port alone: a run
  resumed from its checkpoint appends to the flushed series, and one
  resumed from a checkpoint older than the last flush drops the rows
  past it.
"""

import shutil

import numpy as np
import pytest
import torch

from cfdtpu_torch.scenarios import pipe_cylinder
from cfdtpu_torch.scenarios.pipe_cylinder import PipeCylinder2D2Simulation

torch.set_num_threads(1)

KW = dict(dt=0.01, res_scale=3.0)
TOL = 1e-10


def port(T, **kw):
    return PipeCylinder2D2Simulation("stabilized_schur", T=T, device="cpu",
                                     **KW, **kw)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    from cfdtpu.scenarios.pipe_cylinder import (
        PipeCylinder2D2Simulation as J)

    tmp = tmp_path_factory.mktemp("dfg2d2")
    out = {}
    for name, sc in (("jax", J("stabilized_schur", T=0.02, **KW)),
                     ("port", port(0.02))):
        counts = []

        def after(t, sc=sc):
            st = sc.solver.last_stats
            counts.append((int(st["newton_iters"]), int(st["ksp_iters"])))

        path = sc.solve(str(tmp / name), afterStepCallback=after)
        out[name] = {"counts": counts,
                     "rows": np.loadtxt(f"{path}/bdforces.txt", ndmin=2),
                     "mem": np.asarray(sc._force_rows)}
    return out


def test_counts_match_cfdtpu(pair):
    assert pair["port"]["counts"] == pair["jax"]["counts"]
    assert len(pair["port"]["counts"]) == 2


def test_force_rows_match_cfdtpu(pair):
    a, b = pair["port"]["rows"], pair["jax"]["rows"]
    assert a.shape == b.shape == (2, 4)
    assert np.isfinite(a).all()
    np.testing.assert_array_equal(a[:, :2], b[:, :2])
    for col in (2, 3):
        assert np.abs(a[:, col] - b[:, col]).max() \
            <= TOL * np.abs(b[:, col]).max(), col
    np.testing.assert_allclose(pair["port"]["mem"], a, rtol=1e-8)


def test_forces_read_only_at_a_flush(tmp_path):
    """Before a flush no row reaches the host: at step 2's callback the
    two pairs are pending (the checkpoint's flush comes after the
    callback), at step 3's the pre-checkpoint flush has written them,
    and FLUSH_ROWS steps flush without a checkpoint."""
    seen = []
    sc = port(0.04, checkpoint_every=2)
    sc.solve(str(tmp_path / "a"),
             afterStepCallback=lambda t: seen.append(len(sc._force_rows)))
    assert seen == [0, 0, 2, 2]
    assert len(sc._force_rows) == 4
    assert sc.pre_checkpoint() is None  # the class's no-op again

    seen.clear()
    pipe_cylinder.FLUSH_ROWS = 2
    try:
        sc = port(0.03)
        sc.solve(str(tmp_path / "b"),
                 afterStepCallback=lambda t: seen.append(len(sc._force_rows)))
    finally:
        pipe_cylinder.FLUSH_ROWS = 64
    assert seen == [0, 2, 2]
    assert len(sc._force_rows) == 3


def test_resume_appends_series(tmp_path):
    out = str(tmp_path / "run")
    port(0.02, checkpoint_every=2).solve(out)
    ck = tmp_path / "run" / "checkpoint.npz"
    assert ck.exists()
    part1 = np.loadtxt(tmp_path / "run" / "bdforces_partial.txt", ndmin=2)
    assert part1.shape[0] == 2

    port(0.04, checkpoint_every=2, resume_from=str(ck)).solve(out)
    part2 = np.loadtxt(tmp_path / "run" / "bdforces_partial.txt", ndmin=2)
    full = np.loadtxt(tmp_path / "run" / "bdforces.txt", ndmin=2)
    assert part2.shape[0] == 4 and full.shape[0] == 4
    assert list(full[:, 0]) == [0, 1, 2, 3]
    assert np.all(np.diff(full[:, 1]) > 0)
    np.testing.assert_allclose(full[:2], part1, rtol=1e-12)
    assert np.isfinite(full).all()


def test_resume_reconciles_misaligned_series(tmp_path):
    out = str(tmp_path / "run")
    ck = tmp_path / "run" / "checkpoint.npz"
    ck_old = tmp_path / "ck_step2.npz"

    def grab_old_checkpoint(t):
        # after step 3's callback the newest checkpoint on disk is step
        # 2's (Scenario.solve saves after the callback)
        if abs(t - 0.03) < 1e-9 and ck.exists() and not ck_old.exists():
            shutil.copy(ck, ck_old)

    port(0.04, checkpoint_every=2).solve(
        out, afterStepCallback=grab_old_checkpoint)
    assert int(np.load(ck_old)["step"]) == 2
    part1 = np.loadtxt(tmp_path / "run" / "bdforces_partial.txt", ndmin=2)
    assert part1.shape[0] == 4  # flushed past the old checkpoint

    port(0.05, checkpoint_every=2, resume_from=str(ck_old)).solve(out)
    full = np.loadtxt(tmp_path / "run" / "bdforces.txt", ndmin=2)
    assert full.shape[0] == 5
    assert list(full[:, 0]) == [0, 1, 2, 3, 4]
    assert np.all(np.diff(full[:, 1]) > 0)
    np.testing.assert_allclose(full[:2], part1[:2], rtol=1e-12)


def test_unfetched_stale_failure_is_retried():
    """A step inside a stats_every window whose K-stale operator fails
    is rebuilt and retried once, as a checked step is (Newton reads its
    flag on the host): the DFG 2D-2 campaign's settings (stats_every 5,
    pc_lag_steps 4) otherwise stop at the window check where stats_every
    1 carries on. A failure with a fresh state still raises there."""
    from cfdtpu_torch.scenarios.lid_driven2D import LidDriven2DSimulation

    sc = LidDriven2DSimulation(
        "stabilized_schur", dt=0.01, T=0.05, mu=0.01, nx=10, device="cpu",
        pc_inner_method="rasamg_sup", pc_inner_u=0, pc_inner_p=3,
        pc_lag_steps=3, stats_every=3)
    s = sc.solver
    s.solveStep()  # step 0 (unfetched) builds the carried state
    orig = s._reuse_step
    calls = {"n": 0}

    def flaky(*a):
        u, p, ru, rp, stats = orig(*a)
        calls["n"] += 1
        if calls["n"] == 1:  # the first reuse step's verdict: failed
            stats = dict(stats, converged=False)
        return u, p, ru, rp, stats

    s._reuse_step = flaky
    for _ in range(2):  # step 1 (unfetched, retried), step 2 (checked)
        s.u_prev, s.p_prev = s.u_sol, s.p_sol
        s.solveStep()
    assert calls["n"] == 3  # step 1 twice, step 2 once
    assert s.last_stats["converged"] and s._op_state_fresh is False


def test_unfetched_fresh_failure_still_raises(tmp_path):
    """cfdtpu's test_stats_window_catches_skipped_nonconvergence on the
    port: a step that fails with a fresh state inside the window raises
    at the window check."""
    from cfdtpu_torch.scenarios.lid_driven2D import LidDriven2DSimulation

    sc = LidDriven2DSimulation(
        "stabilized_schur", dt=0.01, T=0.05, mu=0.01, nx=8, device="cpu",
        stats_every=2, snes_rtol=1e-14, snes_atol=1e-30, snes_max_it=1)
    with pytest.raises(RuntimeError, match="unfetched"):
        sc.solve(str(tmp_path))
