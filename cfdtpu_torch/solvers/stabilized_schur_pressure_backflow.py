"""Weak-pressure inlet, Nitsche, resistance outlet and backflow.

The counterpart of cfdtpu/solvers/stabilized_schur_pressure_backflow.py,
in the sigma (Laplacian) form:

- inlet: the weak pressure `p_inlet (v·n)` (kernel K16) and symmetric
  Nitsche enforcement of u_T = 0 with the penalty beta_nitsche mu / h
  (kernel K17, sigma form);
- outlet: the resistance pressure `0.5 p_c (v·n)` (K16) with
  p_c = R_resistance |Q|, Q the outlet flux of u_prev, updated after
  every step by the damped fixed point
  p_c <- alpha R |Q| + (1 - alpha) p_c; the viscous traction correction
  `-(2 mu eps(u_mid) n)·v` (K12) and the backflow stabilisation (K13).

Only the walls are strong (no-slip), and there is no global natural
correction. p_c is a prm entry, read at every residual call.
"""

from __future__ import annotations

from ..forms.facet_terms import (backflow, nitsche_tangential,
                                 viscous_traction, weak_pressure)
from .stabilized_schur import Solver as BaseSolver


class Solver(BaseSolver):
    BOUNDARY_CORRECTION = False

    def __init__(self, *args, p_inlet=None, beta_nitsche: float = 100.0,
                 beta_backflow: float = 0.2, R_resistance=None,
                 alpha_damping: float = 0.75, **kwargs):
        if p_inlet is None:
            raise ValueError(
                "p_inlet is required for stabilized_schur_pressure_backflow."
                " Pass it via CLI: --p_inlet <value> (physical units)"
            )
        if R_resistance is None:
            raise ValueError(
                "R_resistance is required for "
                "stabilized_schur_pressure_backflow. "
                "Pass it via CLI: --R_resistance <value>"
            )
        self.p_inlet = float(p_inlet)
        self.beta_nitsche = float(beta_nitsche)
        self.beta_backflow = float(beta_backflow)
        self.R_resistance = float(R_resistance)
        self.alpha_damping = float(alpha_damping)
        self.p_c = 0.0
        super().__init__(*args, **kwargs)
        print(
            f"[Solver] p_grade={self.V.degree}, p_inlet={self.p_inlet:.4f}, "
            f"beta_nitsche={self.beta_nitsche:.2f}, "
            f"beta_backflow={self.beta_backflow:.2f}, "
            f"R_resistance={self.R_resistance:.4e}, "
            f"alpha_damping={self.alpha_damping:.2f}",
            flush=True,
        )

    def _setup_boundary_terms(self, facet_tags, tags) -> None:
        if tags is None or tags.get("inlet") is None or (
                tags.get("outlet") is None):
            raise ValueError(
                "stabilized_schur_pressure_backflow needs 'inlet' and "
                "'outlet' facet tags"
            )
        inlet = self.mesh.tagged_facets(tags["inlet"])
        outlet = self.mesh.tagged_facets(tags["outlet"])
        f = self.form
        f.add_facet_term("weak_pressure_in", inlet, weak_pressure("p_inlet"))
        f.add_facet_term("nitsche_in", inlet,
                         nitsche_tangential("beta_nitsche"))
        f.add_facet_term("resistance_out", outlet,
                         weak_pressure("p_c", scale=0.5))
        f.add_facet_term("viscous_out", outlet, viscous_traction())
        f.add_facet_term("backflow_out", outlet, backflow())
        # p_c = R |Q(u_prev)| to start
        q0 = float(f.facet_flux(self.u_prev, "resistance_out"))
        self.p_c = self.R_resistance * abs(q0)

    def extra_params(self):
        return {"p_inlet": self.p_inlet, "p_c": self.p_c,
                "beta_nitsche": self.beta_nitsche,
                "beta_backflow": self.beta_backflow}

    def _post_step(self) -> None:
        # the damped fixed point on the flux of u_prev: the scenario
        # copies u_sol to u_prev after this hook
        q = float(self.form.facet_flux(self.u_prev, "resistance_out"))
        p_new = self.R_resistance * abs(q)
        self.p_c = (self.alpha_damping * p_new
                    + (1 - self.alpha_damping) * self.p_c)
        print(f"  Resistance BC: Q={q:.6e}, p_new={p_new:.4f}, "
              f"p_damped={self.p_c:.4f} (alpha={self.alpha_damping:.2f})")
        super()._post_step()
