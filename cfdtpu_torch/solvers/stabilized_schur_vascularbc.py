"""Curl-curl solver with a weak pressure inlet and a resistance outlet
(P = R Q).

The counterpart of cfdtpu/solvers/stabilized_schur_vascularbc.py: the
rotational form (kernel K15), the weak pressure p_inlet/2 at the inlet
and a resistance outlet whose weak pressure starts at
initial_ffr * p_inlet / 2 and is set after every step by the fixed
point p_outlet = R_resistance |Q|, Q the outlet flux of the freshly
solved u_sol (kernel K16); curl-form Nitsche on both ends (K17).
"""

from __future__ import annotations

from ..forms.facet_terms import nitsche_tangential_curl, weak_pressure
from .stabilized_schur_pressurebc import Solver as PressureBCSolver


class Solver(PressureBCSolver):
    REQUIRED = ("p_inlet",)
    OUTLET_NITSCHE = True

    def __init__(self, *args, p_inlet=None, R_resistance=None,
                 initial_ffr: float = 0.8, beta_nitsche: float = 100.0,
                 **kwargs):
        if R_resistance is None:
            raise ValueError(
                "R_resistance is required for this solver. "
                "Pass it via CLI: --R_resistance <value>"
            )
        self.R_resistance = float(R_resistance)
        self.initial_ffr = float(initial_ffr)
        p_outlet0 = self.initial_ffr * float(p_inlet)
        super().__init__(*args, p_inlet=p_inlet, p_outlet=p_outlet0,
                         beta_nitsche=beta_nitsche, **kwargs)
        print(f"[Solver] R_resistance={self.R_resistance}, "
              f"initial_ffr={self.initial_ffr}, "
              f"p_outlet_0={p_outlet0:.4f}", flush=True)

    def _setup_boundary_terms(self, facet_tags, tags) -> None:
        self._require_tags(tags, "inlet", "outlet")
        inlet = self.mesh.tagged_facets(tags["inlet"])
        outlet = self.mesh.tagged_facets(tags["outlet"])
        f = self.form
        f.add_facet_term("weak_pressure_in", inlet, weak_pressure("p_in_w"))
        f.add_facet_term("weak_pressure_out", outlet,
                         weak_pressure("p_out_w"))
        f.add_facet_term("nitsche_in", inlet,
                         nitsche_tangential_curl("beta_nitsche"))
        if self.OUTLET_NITSCHE:
            f.add_facet_term("nitsche_out", outlet,
                             nitsche_tangential_curl("beta_nitsche"))

    def outlet_flux(self) -> float:
        """Q = int_out u_sol·n."""
        return float(self.form.facet_flux(self.u_sol, "weak_pressure_out"))

    def _post_step(self) -> None:
        q = self.outlet_flux()
        p_outlet_phys = self.R_resistance * abs(q)
        self.p_outlet_w = p_outlet_phys / 2
        print(f"  Resistance BC: Q={q:.6e}, p_outlet={p_outlet_phys:.4f}")
