"""vascularbc with the outlet pressure imposed as a strong Dirichlet BC.

The counterpart of cfdtpu/solvers/stabilized_schur_vascularbc_strong.py:
the curl-curl form (kernel K15), the weak pressure and Nitsche at the
inlet only (K16, K17); the outlet pressure is a Dirichlet condition on
the pressure dofs, initialised to initial_ffr * p_inlet / 2 and set
after every step by the fixed point p = R |Q| / 2, Q the outlet flux of
u_sol. Its value is a callable that reads `_p_outlet_strong`, which the
solver's _bc_values re-evaluates (DirichletBC.update) every step. The
outlet is a flux-only block of the form (facet_flux measures Q there;
no term and no launch: cfdtpu's block of zeros changes no sum).
"""

from __future__ import annotations

import numpy as np

from ..forms.facet_terms import nitsche_tangential_curl, weak_pressure
from ..spaces import BoundaryCondition
from .stabilized_schur_vascularbc import Solver as VascularBCSolver


class Solver(VascularBCSolver):
    OUTLET_NITSCHE = False

    def _setup_boundary_terms(self, facet_tags, tags) -> None:
        self._require_tags(tags, "inlet", "outlet")
        inlet = self.mesh.tagged_facets(tags["inlet"])
        outlet = self.mesh.tagged_facets(tags["outlet"])
        f = self.form
        f.add_facet_term("weak_pressure_in", inlet, weak_pressure("p_in_w"))
        f.add_facet_term("nitsche_in", inlet,
                         nitsche_tangential_curl("beta_nitsche"))
        f.add_flux_block("outlet_flux", outlet)
        self._p_outlet_strong = self.p_outlet_w

    def setup(self, bcu, bcp, facet_tags=None, tags=None) -> None:
        # the outlet pressure as a Dirichlet BC whose value is read again
        # at every step
        bc_out = BoundaryCondition(
            lambda x: np.full(x.shape[1], self._p_outlet_strong))
        outlet = self.mesh.tagged_facets(tags["outlet"]) if tags else None
        bc_out.initTopological(self.mesh.dim - 1, outlet)
        super().setup(bcu, list(bcp) + [bc_out], facet_tags, tags)

    def outlet_flux(self) -> float:
        return float(self.form.facet_flux(self.u_sol, "outlet_flux"))

    def _post_step(self) -> None:
        q = self.outlet_flux()
        p_outlet_phys = self.R_resistance * abs(q)
        self._p_outlet_strong = p_outlet_phys / 2
        print(f"  Resistance BC (strong): Q={q:.6e}, "
              f"p_outlet={p_outlet_phys:.4f}")
