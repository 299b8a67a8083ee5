"""Curl-curl solver with a directional do-nothing outlet.

The counterpart of cfdtpu/solvers/stabilized_schur_vascularbc_ddn.py:
the rotational form (kernel K15); the outlet stress replaced by the
directional do-nothing condition sigma·n = 1/2 (u·n)_- u (Braack &
Mucha 2014): the do-nothing outlet under outflow plus a reverse-flow
penalty `- 1/2 min(u_prev·n, 0)(u_mid·v)` (kernel K18). The inlet is
the scenario's (a Dirichlet velocity when v_max is given).
"""

from __future__ import annotations

from ..forms import StabilizedNSFormCurlCurl
from ..forms.facet_terms import directional_do_nothing
from .stabilized_schur import Solver as BaseSolver


class Solver(BaseSolver):
    BOUNDARY_CORRECTION = False

    def __init__(self, *args, v_max=None, **kwargs):
        # v_max sizes the scenario's inlet profile; accepted here as
        # cfdtpu's solver accepts it
        self.v_max = v_max
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
                "stabilized_schur_vascularbc_ddn needs an 'outlet' tag")
        outlet = self.mesh.tagged_facets(tags["outlet"])
        self.form.add_facet_term("ddn_out", outlet, directional_do_nothing())
