"""Solver state carried across from the JAX package.

The port's counterpart of converting weights: the JAX package's state
(numpy arrays, e.g. from the .npz that cfdtpu's Scenario.save_checkpoint
writes) becomes the port's state tensors on the solver's device and
dtype, so both packages can continue from one developed state.
"""

from __future__ import annotations

import numpy as np

STATE_KEYS = ("u_prev", "p_prev", "u_sol", "p_sol")
# solver history beyond STATE_KEYS that multistep schemes need across a
# resume (cfdtpu/scenarios/base.py _CKPT_HISTORY): BDF2's u^{n-1}
# (stabilized family) and the IPCS-BDF2 extrapolation state. A checkpoint
# carries each one the solver holds; the Crank-Nicolson solver holds none.
CKPT_HISTORY = ("u_prev2", "u_n1")


def state_from_numpy(arrays: dict, solver) -> None:
    """Fill solver.u_prev, p_prev, u_sol and p_sol from numpy arrays
    (shapes (n_u, d) and (n_p,)), on the solver's device and dtype."""
    for key in STATE_KEYS:
        cur = getattr(solver, key)
        a = np.asarray(arrays[key])
        if tuple(a.shape) != tuple(cur.shape):
            raise ValueError(f"{key}: shape {a.shape} != {tuple(cur.shape)}")
        setattr(solver, key, solver.tensor(a))


def history_from_numpy(arrays: dict, solver) -> None:
    """Restore each CKPT_HISTORY name the solver holds (non-None) from
    `arrays` (a mapping that may lack it), as cfdtpu's load_checkpoint
    does. A missing u_n1 falls back to the IPCS-BDF2 t=0 convention u_n1
    = u_prev; a missing u_prev2 sets solver._resume_lost_history, so a
    BDF2 solver takes one BDF1 step instead of full BDF2 coefficients
    against a zero u_prev2."""
    for name in CKPT_HISTORY:
        cur = getattr(solver, name, None)
        if cur is None:
            continue
        if name in arrays:
            a = np.asarray(arrays[name])
            if tuple(a.shape) != tuple(cur.shape):
                raise ValueError(
                    f"{name}: shape {a.shape} != {tuple(cur.shape)}")
            setattr(solver, name, solver.tensor(a))
        elif name == "u_n1":
            solver.u_n1 = solver.u_prev
        else:
            solver._resume_lost_history = True


def load_reference_checkpoint(path: str, scenario) -> tuple[float, int]:
    """Read a checkpoint .npz (u_sol, p_sol, u_prev, p_prev, t, step and
    the CKPT_HISTORY names the saving solver held) — the format of
    cfdtpu/scenarios/base.py save_checkpoint, which the port writes too
    — into scenario.solver. Restores the step counter (step-indexed
    behaviour such as the pc_lag rebuild phase continues where it was).
    Returns (t, step)."""
    with np.load(path) as data:
        state_from_numpy({k: data[k] for k in STATE_KEYS}, scenario.solver)
        history_from_numpy({k: data[k] for k in CKPT_HISTORY
                            if k in data.files}, scenario.solver)
        t, step = float(data["t"]), int(data["step"])
    scenario.solver.step_count = step
    return t, step
