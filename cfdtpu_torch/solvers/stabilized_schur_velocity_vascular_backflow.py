"""Sigma-form solver: strong velocity inlet, damped resistance outlet
and backflow stabilisation.

The counterpart of
cfdtpu/solvers/stabilized_schur_velocity_vascular_backflow.py: a strong
Dirichlet parabolic inlet (the scenario's profile, sized by the required
v_max) and the outlet traction sigma·n = -p_c n - rho theta (u·n)_- u:
the weak pressure `0.5 p_c (v·n)` (kernel K16), the viscous traction
correction `-(2 mu eps(u_mid) n)·v` (K12) and the backflow
stabilisation (K13); p_c = R |Q| with Q the outlet flux of u_prev,
updated after every step by the damped fixed point
p_c <- alpha p_new + (1 - alpha) p_c.
"""

from __future__ import annotations

from ..forms.facet_terms import backflow, viscous_traction, weak_pressure
from .stabilized_schur import Solver as BaseSolver


class Solver(BaseSolver):
    BOUNDARY_CORRECTION = False

    def __init__(self, *args, v_max=None, R_resistance=None,
                 beta_backflow: float = 0.2, alpha_damping: float = 0.75,
                 **kwargs):
        if v_max is None:
            raise ValueError(
                "v_max is required for "
                "stabilized_schur_velocity_vascular_backflow. "
                "Pass it via CLI: --v_max <value>"
            )
        if R_resistance is None:
            raise ValueError(
                "R_resistance is required for "
                "stabilized_schur_velocity_vascular_backflow. "
                "Pass it via CLI: --R_resistance <value>"
            )
        self.v_max = float(v_max)
        self.R_resistance = float(R_resistance)
        self.beta_backflow = float(beta_backflow)
        self.alpha_damping = float(alpha_damping)
        self.p_c = 0.0
        super().__init__(*args, **kwargs)
        print(
            f"[Solver] p_grade={self.V.degree}, v_max={self.v_max:.4f}, "
            f"R_resistance={self.R_resistance:.4e}, "
            f"beta_backflow={self.beta_backflow:.2f}, "
            f"alpha_damping={self.alpha_damping:.2f}",
            flush=True,
        )

    def _setup_boundary_terms(self, facet_tags, tags) -> None:
        if tags is None or tags.get("outlet") is None:
            raise ValueError(
                "stabilized_schur_velocity_vascular_backflow needs an "
                "'outlet' facet tag"
            )
        outlet = self.mesh.tagged_facets(tags["outlet"])
        f = self.form
        f.add_facet_term("resistance_out", outlet,
                         weak_pressure("p_c", scale=0.5))
        f.add_facet_term("viscous_out", outlet, viscous_traction())
        f.add_facet_term("backflow_out", outlet, backflow())
        q0 = float(f.facet_flux(self.u_prev, "resistance_out"))
        self.p_c = self.R_resistance * abs(q0)

    def extra_params(self):
        return {"p_c": self.p_c, "beta_backflow": self.beta_backflow}

    def _post_step(self) -> None:
        q = float(self.form.facet_flux(self.u_prev, "resistance_out"))
        p_new = self.R_resistance * abs(q)
        self.p_c = (self.alpha_damping * p_new
                    + (1 - self.alpha_damping) * self.p_c)
        print(f"  Resistance BC: Q={q:.6e}, p_new={p_new:.4f}, "
              f"p_damped={self.p_c:.4f} (alpha={self.alpha_damping:.2f})")
