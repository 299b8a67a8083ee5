"""Stabilized solver with Dirichlet ramping.

The counterpart of cfdtpu/solvers/stabilized_schur_ramping.py: for the
first RAMP_STEPS steps every Dirichlet velocity value is scaled by
step / RAMP_STEPS before the solve (the values fed to the step, so
nothing needs restoring).
"""

from __future__ import annotations

from .stabilized_schur import Solver as BaseSolver


class Solver(BaseSolver):
    RAMP_STEPS = 10

    def _bc_values(self):
        bc_u_vals, bc_p_vals = super()._bc_values()
        step = self.step_count + 1
        if step <= self.RAMP_STEPS:
            alpha = step / self.RAMP_STEPS
            bc_u_vals = bc_u_vals * alpha
            print(f"[ramping] step {step}: scaling Dirichlet u by {alpha:.2f}")
        return bc_u_vals, bc_p_vals
