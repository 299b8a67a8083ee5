"""Stabilized solver with adaptive time-step retry.

The counterpart of cfdtpu/solvers/stabilized_schur_adaptive.py: on a
Newton failure, halve dt (prm's dt, which the element kernels read per
call) and retry from the previous step, up to MAX_RETRIES times; the
reduced dt is kept for later steps. Under pc_lag_steps the carried
operator and preconditioner are rebuilt whenever dt changed, as in
cfdtpu (_run_step compares the dt they were built at).
"""

from __future__ import annotations

from .stabilized_schur import Solver as BaseSolver


class Solver(BaseSolver):
    MAX_RETRIES = 5

    def solveStep(self) -> None:
        bc_u_vals, bc_p_vals = self._bc_values()
        last_err = None
        for attempt in range(self.MAX_RETRIES + 1):
            u, p, r_u, r_p, stats = self._run_step(bc_u_vals, bc_p_vals)
            if stats["converged"]:
                self.last_stats = dict(stats)
                self.step_stats = self._step_stats(stats, attempt)
                self.u_sol, self.p_sol = u, p
                self.u_residual, self.p_residual = r_u, r_p
                print(
                    f"Solver converged in "
                    f"{self.last_stats['newton_iters']} nonlinear iterations"
                    f" (with total number of"
                    f" {self.last_stats['ksp_iters']} linear iterations)"
                    + (f" [dt reduced to {self.dt:.3e} after {attempt}"
                       f" retries]" if attempt else "")
                )
                self._post_step()
                self.step_count += 1
                return
            last_err = (
                f"newton_iters={int(stats['newton_iters'])}, "
                f"fnorm={float(stats['fnorm']):.3e}"
            )
            self.dt = self.dt / 2.0
            print(
                f"Newton failed ({last_err}); retrying with dt="
                f"{self.dt:.3e} ({attempt + 1}/{self.MAX_RETRIES})"
            )
        raise RuntimeError(
            f"Did not converge after {self.MAX_RETRIES} dt halvings: "
            f"{last_err}"
        )
