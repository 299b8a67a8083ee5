"""Stabilized solver with a do-nothing outlet and backflow stabilisation.

The counterpart of cfdtpu/solvers/stabilized_schur_backflow.py: a
strong Dirichlet inlet (imposed by the scenario, sized by the required
v_max), a zero-traction outlet (the base solver's natural boundary
correction is not imposed) and the Moghadam et al. 2011 backflow
stabilisation `- beta rho (u_prev·n)_- (u_mid·v)` on the tagged outlet
(kernel K13).
"""

from __future__ import annotations

from ..forms.facet_terms import backflow
from .stabilized_schur import Solver as BaseSolver


class Solver(BaseSolver):
    BOUNDARY_CORRECTION = False

    def __init__(self, *args, v_max=None, beta_backflow: float = 0.2,
                 **kwargs):
        if v_max is None:
            raise ValueError(
                "v_max is required for stabilized_schur_backflow. "
                "Pass it via CLI: --v_max <value>"
            )
        self.v_max = float(v_max)
        self.beta_backflow = float(beta_backflow)
        super().__init__(*args, **kwargs)
        print(
            f"[Solver] p_grade={self.V.degree}, v_max={self.v_max:.4f}, "
            f"beta_backflow={self.beta_backflow:.2f}",
            flush=True,
        )

    def _setup_boundary_terms(self, facet_tags, tags) -> None:
        if tags is None or tags.get("outlet") is None:
            raise ValueError(
                "stabilized_schur_backflow needs an 'outlet' facet tag"
            )
        outlet = self.mesh.tagged_facets(tags["outlet"])
        self.form.add_facet_term("backflow_out", outlet, backflow())

    def extra_params(self):
        return {"beta_backflow": self.beta_backflow}
