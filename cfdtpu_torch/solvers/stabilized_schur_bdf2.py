"""Stabilized solver with BDF2 time integration.

The counterpart of cfdtpu/solvers/stabilized_schur_bdf2.py: the time
term rho (a0 u + a1 u_prev + a2 u_prev2) / dt with the coefficients in
prm, BDF1 (1, -1, 0) on the first step and on the first step after a
resume from a checkpoint without u_prev2, BDF2 (1.5, -2, 0.5) after;
convection and stress at u_sol (kernel K14), and the natural
correction at u_sol on every exterior facet (K7's implicit mode).
"""

from __future__ import annotations

import numpy as np
import torch

from ..forms import StabilizedNSFormBDF2
from ..forms.facet_terms import implicit_velocity, natural_correction
from .stabilized_schur import Solver as BaseSolver


class Solver(BaseSolver):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.u_prev2 = torch.zeros_like(self.u_prev)
        self._bdf = (1.0, -1.0, 0.0)

    def _make_form(self, quad_degree):
        form = StabilizedNSFormBDF2(
            self.V, self.Q, quad_degree=quad_degree,
            boundary_correction=False, device=self.device,
            dtype=self.np_dtype,
        )
        if len(self.mesh.facets):
            form.add_facet_term(
                "natural_correction",
                np.arange(len(self.mesh.facets), dtype=np.int32),
                natural_correction(vel=implicit_velocity),
            )
        return form

    def _aux(self):
        return (self.u_prev, self.u_prev2)

    def extra_params(self):
        a0, a1, a2 = self._bdf
        # pcd_theta: BDF2's convection is at u_sol (theta 1; the PCD
        # preconditioners of queue A10 read it)
        return {"bdf_a0": a0, "bdf_a1": a1, "bdf_a2": a2, "pcd_theta": 1.0}

    def solveStep(self) -> None:
        # BDF1 on the first step, and on the first after a resume that
        # lost u_prev2 (io/state.py sets _resume_lost_history): full BDF2
        # coefficients against a zero u_prev2 would inject a spurious
        # 0.5 u_prev2 / dt; one BDF1 step re-seeds the history
        bdf1 = self.step_count == 0 or getattr(
            self, "_resume_lost_history", False)
        self._bdf = (1.0, -1.0, 0.0) if bdf1 else (1.5, -2.0, 0.5)
        super().solveStep()
        self._resume_lost_history = False

    def _post_step(self) -> None:
        # u_prev (u^n) becomes u^{n-1} for the next step, before the
        # scenario's loop copies u_sol into u_prev
        self.u_prev2 = self.u_prev
        super()._post_step()
