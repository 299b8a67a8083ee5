"""Stenosis (pressure-driven) on a structured transfinite grid.

The counterpart of cfdtpu/scenarios/stenosis_pressure_structured.py
(a rebuild of the reference's src/scenarios/stenosis_pressure_structured.py):
same physics as stenosis_pressure but meshed with a structured mapped grid
(setTransfiniteCurve analogue; even radial element counts for symmetry,
:362-380).
"""

from __future__ import annotations

from ..geom.stenosis2d import generate_stenosis_mesh_structured
from .stenosis_pressure import StenosisPressureSimulation


class StenosisPressureStructuredSimulation(StenosisPressureSimulation):
    @property
    def mesh(self):
        if self._mesh is None:
            opts = {
                k: v for k, v in self.mesh_options.items()
                if k in (
                    "L", "R_in", "R_out", "res", "x_position_stenosis",
                    "severity", "slope", "tension",
                )
            }
            self._mesh = generate_stenosis_mesh_structured(
                dtype=self._dtype,
                inlet_marker=self.inlet_marker,
                outlet_marker=self.outlet_marker,
                wall_marker=self.wall_marker,
                **opts,
            )
        return self._mesh
