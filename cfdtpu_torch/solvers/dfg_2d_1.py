"""Steady DFG 2D-1 benchmark solver with per-step drag and lift.

The counterpart of cfdtpu/solvers/dfg_2d_1.py: the stabilized solver
without the natural boundary correction, a do-nothing outlet with the
viscous-traction correction `-(2 mu eps(u_mid) n)·v` (kernel K12) and
the backflow stabilisation (kernel K13) on the tagged outlet, tight
Newton tolerances (rtol 1e-10, atol 1e-12, stol 1e-12, max_it 50:
float64 resolves them, float32 does not), and per step the
traction-based drag and lift coefficients c_D = 500 F_x, c_L = 500 F_y
(U_mean = 0.2, L = 0.1, rho = 1), printed as the `DFG Metrics:` line.
"""

from __future__ import annotations

from ..forms.facet_terms import backflow, viscous_traction
from ..postprocess.forces import BoundaryForce
from .stabilized_schur import Solver as BaseSolver


class Solver(BaseSolver):
    BOUNDARY_CORRECTION = False

    def __init__(
        self,
        *args,
        beta_backflow: float = 0.2,
        snes_rtol=None,
        snes_atol=None,
        snes_stol=None,
        snes_max_it=50,
        **kwargs,
    ):
        self.beta_backflow = float(beta_backflow)
        super().__init__(
            *args,
            snes_rtol=1e-10 if snes_rtol is None else snes_rtol,
            snes_atol=1e-12 if snes_atol is None else snes_atol,
            snes_stol=1e-12 if snes_stol is None else snes_stol,
            snes_max_it=snes_max_it,
            **kwargs,
        )
        self.cd = self.cl = float("nan")

    def _setup_boundary_terms(self, facet_tags, tags) -> None:
        if tags is None or tags.get("obstacle") is None:
            raise ValueError(
                "The 'obstacle' tag is required in DFG solver for "
                "drag/lift calculation."
            )
        outlet = self.mesh.tagged_facets(tags["outlet"])
        self.form.add_facet_term("viscous_out", outlet, viscous_traction())
        self.form.add_facet_term("backflow_out", outlet, backflow())
        self._force = BoundaryForce(
            self.V, self.Q, self.mesh.tagged_facets(tags["obstacle"]),
            device=self.device, dtype=self.np_dtype,
        )

    def extra_params(self):
        return {"beta_backflow": self.beta_backflow}

    def _post_step(self) -> None:
        fd, fl = (float(x) for x in self._force.traction_force(
            self.u_sol, self.p_sol, self.mu).cpu())
        self.cd, self.cl = 500.0 * fd, 500.0 * fl
        print(
            f"    DFG Metrics: Fd={fd:.6e}, Fl={fl:.6e} | "
            f"Cd={self.cd:.6f}, Cl={self.cl:.6f}"
        )
        super()._post_step()
