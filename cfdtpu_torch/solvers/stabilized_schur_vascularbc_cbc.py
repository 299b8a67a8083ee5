"""Curl-curl solver with a Dirichlet velocity inlet and a convective
outlet.

The counterpart of cfdtpu/solvers/stabilized_schur_vascularbc_cbc.py:
the rotational form (kernel K15); the inlet velocity is a strong
Dirichlet parabolic profile from the scenario (which needs v_max); the
outlet stress is replaced by the convective boundary condition
sigma·n = 1/2 (u·n) u (Simon & Notsu 2021), the residual term
`- 1/2 (u_prev·n)(u_mid·v)` on the outlet (kernel K18).
"""

from __future__ import annotations

from ..forms import StabilizedNSFormCurlCurl
from ..forms.facet_terms import cbc
from .stabilized_schur import Solver as BaseSolver


class Solver(BaseSolver):
    BOUNDARY_CORRECTION = False

    def __init__(self, *args, v_max=None, **kwargs):
        if v_max is None:
            raise ValueError(
                "v_max is required for stabilized_schur_vascularbc_cbc. "
                "Pass it via CLI: --v_max <value>"
            )
        self.v_max = float(v_max)
        super().__init__(*args, **kwargs)

    def _make_form(self, quad_degree):
        return StabilizedNSFormCurlCurl(
            self.V, self.Q, quad_degree=quad_degree,
            boundary_correction=False, device=self.device,
            dtype=self.np_dtype,
        )

    def _setup_boundary_terms(self, facet_tags, tags) -> None:
        if tags is None or tags.get("outlet") is None:
            raise ValueError(
                "stabilized_schur_vascularbc_cbc needs an 'outlet' tag")
        outlet = self.mesh.tagged_facets(tags["outlet"])
        self.form.add_facet_term("cbc_out", outlet, cbc())
