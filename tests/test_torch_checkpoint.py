"""Checkpoints of the port against cfdtpu's (JAX): the multistep history
`u_prev2` and `u_n1` (cfdtpu/scenarios/base.py _CKPT_HISTORY) is saved
where the solver holds it, restored where the file has it, and missing
history takes cfdtpu's fallbacks (u_n1 = u_prev; _resume_lost_history
for u_prev2). Either package resumes from the other's checkpoint, and
the Crank-Nicolson solver's checkpoint keeps its six keys.

The solvers are stubs holding random arrays made with numpy from a
seed; save and load are the scenarios' own methods. Exact equality: a
checkpoint stores the arrays as they are.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdtpu.scenarios.base import Scenario as JaxScenario

from cfdtpu_torch.io.state import CKPT_HISTORY
from cfdtpu_torch.scenarios.base import Scenario as TorchScenario
from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark as TorchDFG

torch.set_num_threads(1)

N_U, N_P = 11, 7
BASE = ("u_sol", "p_sol", "u_prev", "p_prev")
SHAPES = {"u_sol": (N_U, 2), "p_sol": (N_P,), "u_prev": (N_U, 2),
          "p_prev": (N_P,), "u_prev2": (N_U, 2), "u_n1": (N_U, 2)}


def _arrays(seed, history):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(SHAPES[k])
            for k in BASE + tuple(history)}


def _held(arrays, hold):
    """Every state name -> its array: the given one, zeros for a state
    array or a held history name not given, None for a history name the
    solver does not hold."""
    out = {}
    for k in BASE + CKPT_HISTORY:
        a = arrays.get(k)
        if a is None and (k in BASE or k in hold):
            a = np.zeros(SHAPES[k])
        out[k] = a
    return out


class _TorchSolver:
    """The attributes a scenario's save and load touch, as torch tensors;
    a history name is held (non-None) when given."""

    def __init__(self, arrays, hold=CKPT_HISTORY):
        for k, a in _held(arrays, hold).items():
            setattr(self, k, None if a is None else self.tensor(a))
        self.step_count = 0

    @staticmethod
    def tensor(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _jax_solver(arrays, hold=CKPT_HISTORY):
    s = types.SimpleNamespace(step_count=0)
    for k, a in _held(arrays, hold).items():
        setattr(s, k, None if a is None else jnp.asarray(a))
    return s


def _torch_save(path, solver, t=0.25, step=5):
    TorchScenario.save_checkpoint(types.SimpleNamespace(solver=solver),
                                  str(path), t, step)


def _torch_load(path, solver):
    return TorchScenario.load_checkpoint(types.SimpleNamespace(solver=solver),
                                         str(path))


def _jax_save(path, solver, t=0.25, step=5):
    JaxScenario.save_checkpoint(types.SimpleNamespace(
        solver=solver, _CKPT_HISTORY=JaxScenario._CKPT_HISTORY), str(path),
        t, step)


def _jax_load(path, solver):
    return JaxScenario.load_checkpoint(types.SimpleNamespace(
        solver=solver, _CKPT_HISTORY=JaxScenario._CKPT_HISTORY), str(path))


def _assert_holds(solver, arrays):
    for k, a in arrays.items():
        np.testing.assert_array_equal(np.asarray(getattr(solver, k)), a)


def test_history_names_match_cfdtpu():
    assert CKPT_HISTORY == JaxScenario._CKPT_HISTORY


def test_port_round_trips_the_history(tmp_path):
    arrays = _arrays(1, CKPT_HISTORY)
    path = tmp_path / "ckpt.npz"
    _torch_save(path, _TorchSolver(arrays))
    with np.load(path) as data:
        assert set(data.files) == set(BASE) | set(CKPT_HISTORY) | {"t",
                                                                  "step"}
    back = _TorchSolver({})
    assert _torch_load(path, back) == (0.25, 5)
    _assert_holds(back, arrays)
    assert back.step_count == 5
    assert not getattr(back, "_resume_lost_history", False)


def test_cfdtpu_checkpoint_without_u_prev2_sets_lost_history(tmp_path):
    arrays = _arrays(2, ("u_n1",))
    path = tmp_path / "ckpt.npz"
    _jax_save(path, _jax_solver(arrays, hold=("u_n1",)))
    with np.load(path) as data:
        assert "u_prev2" not in data.files and "u_n1" in data.files
    back = _TorchSolver({})
    _torch_load(path, back)
    _assert_holds(back, arrays)
    assert back._resume_lost_history is True
    # and cfdtpu's own load of the same file agrees
    ref = _jax_solver({})
    _jax_load(path, ref)
    assert ref._resume_lost_history is True


def test_cfdtpu_checkpoint_without_u_n1_takes_u_prev(tmp_path):
    arrays = _arrays(3, ("u_prev2",))
    path = tmp_path / "ckpt.npz"
    _jax_save(path, _jax_solver(arrays, hold=("u_prev2",)))
    back = _TorchSolver({})
    _torch_load(path, back)
    _assert_holds(back, arrays)
    assert back.u_n1 is back.u_prev
    assert not getattr(back, "_resume_lost_history", False)


def test_a_solver_without_history_ignores_it(tmp_path):
    """A name the loading solver does not hold stays None (cfdtpu skips
    it too), whatever the file has."""
    arrays = _arrays(4, CKPT_HISTORY)
    path = tmp_path / "ckpt.npz"
    _torch_save(path, _TorchSolver(arrays))
    back = _TorchSolver({}, hold=())
    _torch_load(path, back)
    _assert_holds(back, {k: arrays[k] for k in BASE})
    assert back.u_prev2 is None and back.u_n1 is None


@pytest.mark.parametrize("direction", ["port to cfdtpu", "cfdtpu to port"])
def test_either_package_resumes_the_others_history(tmp_path, direction):
    arrays = _arrays(5, CKPT_HISTORY)
    path = tmp_path / "ckpt.npz"
    if direction == "port to cfdtpu":
        _torch_save(path, _TorchSolver(arrays), t=0.5, step=9)
        back = _jax_solver({})
        assert _jax_load(path, back) == (0.5, 9)
    else:
        _jax_save(path, _jax_solver(arrays), t=0.5, step=9)
        back = _TorchSolver({})
        assert _torch_load(path, back) == (0.5, 9)
    _assert_holds(back, arrays)
    assert back.step_count == 9
    assert not getattr(back, "_resume_lost_history", False)


def test_crank_nicolson_checkpoint_keys_unchanged(tmp_path):
    """The ported stabilized_schur solver (Crank-Nicolson) holds no
    history: its checkpoint has the six keys it always had, with the
    solver's arrays."""
    sc = TorchDFG("stabilized_schur", dt=0.05, T=1.0, res_scale=2.5,
                  dtype="float64", device="cpu")
    s = sc.solver
    assert all(getattr(s, k, None) is None for k in CKPT_HISTORY)
    path = tmp_path / "ckpt.npz"
    sc.save_checkpoint(str(path), 0.1, 2)
    with np.load(path) as data:
        assert sorted(data.files) == sorted(BASE + ("t", "step"))
        for k in BASE:
            np.testing.assert_array_equal(data[k], getattr(s, k).numpy())
