"""Curl-curl (rotational) solver with weak pressure BCs and Nitsche.

The counterpart of cfdtpu/solvers/stabilized_schur_pressurebc.py: the
rotational viscous/convective form (StabilizedNSFormCurlCurl, kernel
K15), weak pressures p_inlet/2 and p_outlet/2 on the tagged inlet and
outlet (kernel K16; the weak-form constants carry the 1/2 factor, as in
cfdtpu), and curl-form symmetric Nitsche enforcement of u_T = 0 on both
ends (kernel K17). Only the walls are strong (no-slip); no pressure dof
is pinned.
"""

from __future__ import annotations

from ..forms import StabilizedNSFormCurlCurl
from ..forms.facet_terms import nitsche_tangential_curl, weak_pressure
from .stabilized_schur import Solver as BaseSolver


class Solver(BaseSolver):
    BOUNDARY_CORRECTION = False
    REQUIRED = ("p_inlet", "p_outlet")

    def __init__(self, *args, p_inlet=None, p_outlet=None,
                 beta_nitsche: float = 100.0, **kwargs):
        for name, val in (("p_inlet", p_inlet), ("p_outlet", p_outlet)):
            if name in self.REQUIRED and val is None:
                raise ValueError(
                    f"{name} is required for this solver. "
                    f"Pass it via CLI: --{name} <value>"
                )
        self.p_inlet_w = float(p_inlet) / 2 if p_inlet is not None else 0.0
        self.p_outlet_w = (float(p_outlet) / 2 if p_outlet is not None
                           else 0.0)
        self.beta_nitsche = float(beta_nitsche)
        super().__init__(*args, **kwargs)
        print(f"[Solver] p_grade={self.V.degree}, "
              f"beta_nitsche={self.beta_nitsche}", flush=True)

    def _make_form(self, quad_degree):
        return StabilizedNSFormCurlCurl(
            self.V, self.Q, quad_degree=quad_degree,
            boundary_correction=False, device=self.device,
            dtype=self.np_dtype,
        )

    def _require_tags(self, tags, *names):
        if tags is None or any(tags.get(n) is None for n in names):
            raise ValueError(
                f"{type(self).__module__} needs facet tags: {names}")

    def _setup_boundary_terms(self, facet_tags, tags) -> None:
        self._require_tags(tags, "inlet", "outlet")
        inlet = self.mesh.tagged_facets(tags["inlet"])
        outlet = self.mesh.tagged_facets(tags["outlet"])
        self.form.add_facet_term("weak_pressure_in", inlet,
                                 weak_pressure("p_in_w"))
        self.form.add_facet_term("weak_pressure_out", outlet,
                                 weak_pressure("p_out_w"))
        self.form.add_facet_term("nitsche_in", inlet,
                                 nitsche_tangential_curl("beta_nitsche"))
        self.form.add_facet_term("nitsche_out", outlet,
                                 nitsche_tangential_curl("beta_nitsche"))

    def extra_params(self):
        return {"p_in_w": self.p_inlet_w, "p_out_w": self.p_outlet_w,
                "beta_nitsche": self.beta_nitsche}
