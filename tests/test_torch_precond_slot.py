"""The preconditioner slot (cfdtpu_torch/la/schur.py PrecondSlot): one
application a solver keeps for its whole life, refitted in place at
every later build.

- Every inner method on the assembled DFG 2D-1 Jacobian at res_scale
  1.0, float64 (the solver tests' mesh): a second state loaded into the
  slot hands back the same closure, which then applies the second state
  bit for bit as a closure freshly made of it does; one pc_refits a
  load, no capture.
- A state of another tree is made afresh, and another set of closure
  arguments is held beside the first.
- The solver (DFG 2D-1 at res_scale 3.0, float64, 8 steps) with its slot
  refitting, against the same run with the slot emptied before each
  load (a fresh closure at every build): u and p bit
  for bit, under pc_lag_steps 2 and on the per-Newton-iteration path
  (pc_lag_steps 1, the Jacobian and, in one case, the preconditioner
  rebuilt at each Newton iteration).
"""

import numpy as np
import pytest
import torch

from cfdtpu_torch.la.schur import (PrecondSlot, build_schur_state,
                                   make_schur_precond_from_state)
from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark
from cfdtpu_torch.utils.trace import counter

torch.set_num_threads(1)

METHODS = [("gmres", 3), ("chebyshev", 3), ("chebyshev_p", 3),
           ("amg_p", 3), ("ras_up", 3), ("rasamg_sup", 0)]


@pytest.fixture(scope="module")
def case():
    s = DFG1Benchmark("stabilized_schur", dt=0.05, T=1.0, res_scale=1.0,
                      dtype="float64", device="cpu", pc_lag_steps=4,
                      snes_lag_jacobian=True).solver
    nb = s._nodebsr
    n_u, n_p = s.V.num_dofs, s.Q.num_dofs
    mask = np.zeros(2 * n_u + n_p, dtype=bool)
    for d0 in range(2):
        mask[s.bc_dofs_u.astype(np.int64) * 2 + d0] = True
    mask[2 * n_u + s.bc_dofs_p.astype(np.int64)] = True
    mask = torch.as_tensor(mask)
    y = s.V.dof_coords[:, 1]
    prof = np.stack([1.2 * y * (0.41 - y) / 0.41 ** 2, 0 * y], axis=1)

    def vals(seed):
        """The Jacobian at the inlet profile plus a seeded perturbation."""
        rng = np.random.default_rng(seed)
        u = s.tensor(prof + 0.01 * rng.standard_normal((n_u, 2)))
        up = s.tensor(prof + 0.01 * rng.standard_normal((n_u, 2)))
        p = s.tensor(0.01 * rng.standard_normal(n_p))
        return nb.assemble(*s.form.element_jacobians(u, p, (up,),
                                                     s.params()))

    v = s.tensor(np.random.default_rng(5).standard_normal(2 * n_u + n_p))
    return {"nb": nb, "mask_u": mask[:2 * n_u], "mask_p": mask[2 * n_u:],
            "vals": vals, "v": v}


def _kw(case, method, m_u, m_p=5):
    return dict(m_u=m_u, m_p=m_p, full=True, bc_mask_p=case["mask_p"],
                inner_method=method, ras_opts=(16, 4))


def _state(case, i, kw):
    """A state of Jacobian i, its values made anew: a slot takes the
    tensors of the first state it holds as its own."""
    return build_schur_state(case["nb"], case["vals"](1 + i),
                             case["mask_u"], False, **kw)


@pytest.mark.parametrize("method,m_u", METHODS,
                         ids=[m for m, _ in METHODS])
def test_refit_matches_a_fresh_closure(case, method, m_u):
    nb, mask_u, v = case["nb"], case["mask_u"], case["v"]
    kw = _kw(case, method, m_u)
    slot = PrecondSlot()
    first = _state(case, 0, kw)
    M, held = slot.load(nb, first, mask_u, False, **kw)
    assert held is first
    before = M(v).clone()
    refits, captures = counter("pc_refits").n, counter("pc_captures").n
    second = _state(case, 1, kw)
    M2, held2 = slot.load(nb, second, mask_u, False, **kw)
    assert M2 is M and held2 is first
    assert counter("pc_refits").n == refits + 1
    assert counter("pc_captures").n == captures
    fresh = make_schur_precond_from_state(nb, second, mask_u, False, **kw)
    got = M(v)
    assert torch.equal(got, fresh(v))
    assert not torch.equal(got, before)


def test_other_tree_or_arguments_make_afresh(case):
    nb, mask_u, v = case["nb"], case["mask_u"], case["v"]
    kw = _kw(case, "amg_p", 3)
    slot = PrecondSlot()
    M = slot.load(nb, _state(case, 0, kw), mask_u, False, **kw)[0]
    refits = counter("pc_refits").n
    # one more leaf: another tree, a new closure that reads it
    grown = dict(_state(case, 1, kw), extra=torch.zeros(1))
    M_grown, held = slot.load(nb, grown, mask_u, False, **kw)
    assert M_grown is not M and held is grown
    # another set of arguments: held beside the first
    kw_p = _kw(case, "amg_p", 3, m_p=7)
    M_p = slot.load(nb, _state(case, 0, kw_p), mask_u, False, **kw_p)[0]
    assert M_p is not M_grown
    assert counter("pc_refits").n == refits
    second = dict(_state(case, 1, kw), extra=torch.ones(1))
    assert slot.load(nb, second, mask_u, False, **kw)[0] is M_grown
    assert torch.equal(grown["extra"], second["extra"])
    assert counter("pc_refits").n == refits + 1
    fresh = make_schur_precond_from_state(nb, second, mask_u, False, **kw)
    assert torch.equal(M_grown(v), fresh(v))


SOLVE = dict(dt=0.05, T=0.39, res_scale=3.0, dtype="float64",
             pc_inner_method="rasamg_sup", pc_inner_u=0, pc_inner_p=5,
             pc_ras_size=32, stats_every=1, ksp_restart=20,
             early_stop_tolerance=0.0, output_every=100)
STEPS = 8  # T / dt
PATHS = {
    "pc_lag_steps_2": dict(snes_lag_jacobian=True, pc_lag_steps=2),
    "per_newton": dict(snes_lag_jacobian=False, pc_lag_steps=1),
    "per_newton_pc": dict(snes_lag_jacobian=False, pc_lag_steps=1,
                          snes_lag_preconditioner=False),
}


def _solve(tmp, kw):
    sc = DFG1Benchmark("stabilized_schur", device="cpu", **SOLVE, **kw)
    n = []
    sc.solve(str(tmp), afterStepCallback=lambda t: n.append(t))
    assert len(n) == STEPS
    return sc.solver.u_sol, sc.solver.p_sol


@pytest.mark.parametrize("path", list(PATHS))
def test_solver_bit_for_bit_with_a_cleared_slot(tmp_path, monkeypatch,
                                                path):
    refits = counter("pc_refits").n
    u, p = _solve(tmp_path / "slot", PATHS[path])
    assert counter("pc_refits").n > refits
    load = PrecondSlot.load

    def fresh_load(self, *a, **k):
        self._held.clear()
        return load(self, *a, **k)

    monkeypatch.setattr(PrecondSlot, "load", fresh_load)
    refits = counter("pc_refits").n
    u_fresh, p_fresh = _solve(tmp_path / "fresh", PATHS[path])
    assert counter("pc_refits").n == refits
    assert torch.equal(u, u_fresh) and torch.equal(p, p_fresh)
