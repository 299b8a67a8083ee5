"""Stenosis with variable (radius-tied) mesh resolution.

The counterpart of cfdtpu/scenarios/stenosis_mesh_variable.py
(a rebuild of the reference's src/scenarios/stenosis_mesh_variable.py): the
stenosis scenario with a sizing field tied to the local taper radius
(MathEval baseline ~ r_local/n_axial) and Threshold refinement near the
throat (SizeMin = R_min/n_rad, :363-397). Same BC physics and FFR output.
"""

from __future__ import annotations

import numpy as np

from ..geom.delaunay2d import generate_mesh_2d
from ..geom.stenosis2d import (
    _wall_points,
    stenosis_profile_params,
    stenosis_radius_profile,
)
from .stenosis import StenosisSimulation


class StenosisMeshVariableSimulation(StenosisSimulation):
    def __init__(self, *args, n_rad=6, n_axial=10, **kwargs):
        self.n_rad = int(n_rad)
        self.n_axial = int(n_axial)
        super().__init__(*args, **kwargs)

    @property
    def mesh(self):
        if self._mesh is None:
            o = self.mesh_options
            L, R_in, R_out = o["L"], o["R_in"], o["R_out"]
            x_sten = o["x_position_stenosis"]
            prof = stenosis_profile_params(
                L, R_in, R_out, x_sten, o["severity"], o["slope"],
                o["tension"],
            )
            xs, rs = stenosis_radius_profile(
                L, R_in, R_out, x_sten, o["severity"], o["slope"],
                o["tension"],
            )
            R_min, dist_x = prof["R_min"], prof["dist_x"]
            size_min = R_min / self.n_rad

            def size_fn(x):  # batched: points along the LAST axis
                x = np.asarray(x)
                r_local = np.interp(x[..., 0], xs, rs)
                base = r_local / self.n_rad * 2
                d = np.abs(x[..., 0] - x_sten)
                t = np.minimum(d / (2 * dist_x), 1.0)
                return size_min + (base - size_min) * t

            res_bnd = size_min

            def sample_wall(side):
                return _wall_points(
                    L, R_in, R_out, x_sten, prof,
                    max(res_bnd, size_min), side,
                )

            top = sample_wall(+1)
            bot = sample_wall(-1)

            def vline(x, y0, y1, res):
                n = max(1, int(round(abs(y1 - y0) / res)))
                t = np.arange(n) / n
                return np.stack(
                    [np.full(n, x), y0 + t * (y1 - y0)], axis=-1
                )

            loop = np.concatenate(
                [
                    bot,
                    vline(L, R_in - R_out, R_in + R_out, R_out / 4),
                    top[::-1],
                    vline(0.0, 2 * R_in, 0.0, R_in / 4),
                ]
            )
            m = generate_mesh_2d(loop, [], size_fn, dtype=self._dtype)
            m.mark_boundary_facets(
                lambda x: np.isclose(x[0], 0.0, atol=1e-9),
                self.inlet_marker,
            )
            m.mark_boundary_facets(
                lambda x: np.isclose(x[0], L, atol=1e-9),
                self.outlet_marker,
            )
            m.facet_tags[m.facet_tags == 0] = self.wall_marker
            self._mesh = m
        return self._mesh
