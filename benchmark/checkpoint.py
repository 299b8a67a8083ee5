"""The start state's file: a checkpoint .npz (u_sol, p_sol, u_prev,
p_prev, t, step), the format that the program's Scenario resumes from
(its `resume_from`); the reference reads the same file."""

from __future__ import annotations

import numpy as np


def write_checkpoint(path, u, p, dtype):
    u = np.asarray(u).astype(dtype)
    p = np.asarray(p).astype(dtype)
    with open(path, "wb") as f:
        np.savez(f, u_sol=u, p_sol=p, u_prev=u, p_prev=p, t=0.0, step=0)


def read_checkpoint(path):
    """(u, p) of a checkpoint, in float64."""
    with np.load(path) as z:
        return (z["u_sol"].astype(np.float64), z["p_sol"].astype(np.float64))
