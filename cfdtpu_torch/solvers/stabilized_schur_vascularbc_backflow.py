"""Curl-curl solver: weak pressures at both ends (the outlet's from the
FFR), Nitsche at both ends, backflow stabilisation at the outlet.

The counterpart of
cfdtpu/solvers/stabilized_schur_vascularbc_backflow.py: the rotational
form (kernel K15), the weak pressure p_inlet/2 at the inlet and a fixed
p_outlet = initial_ffr * p_inlet / 2 at the outlet (no fixed point;
K16), curl-form Nitsche u_T = 0 at both ends (K17) and the backflow
stabilisation `- beta rho (u_prev·n)_- (u_mid·v)` on the outlet (K13):
five facet blocks in the element kernel's launch.
"""

from __future__ import annotations

from ..forms.facet_terms import backflow
from .stabilized_schur_pressurebc import Solver as PressureBCSolver


class Solver(PressureBCSolver):
    REQUIRED = ("p_inlet",)

    def __init__(self, *args, p_inlet=None, initial_ffr: float = 0.8,
                 beta_backflow: float = 0.2, v_max=None, **kwargs):
        self.initial_ffr = float(initial_ffr)
        self.beta_backflow = float(beta_backflow)
        self.v_max = v_max
        p_outlet0 = self.initial_ffr * float(p_inlet)
        super().__init__(*args, p_inlet=p_inlet, p_outlet=p_outlet0,
                         **kwargs)

    def _setup_boundary_terms(self, facet_tags, tags) -> None:
        super()._setup_boundary_terms(facet_tags, tags)
        outlet = self.mesh.tagged_facets(tags["outlet"])
        self.form.add_facet_term("backflow_out", outlet, backflow())

    def extra_params(self):
        prm = super().extra_params()
        prm["beta_backflow"] = self.beta_backflow
        return prm
