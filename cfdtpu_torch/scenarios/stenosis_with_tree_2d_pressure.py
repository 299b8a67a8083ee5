"""Pressure-driven stenosis + 2D tree with Reynolds-field output.

The counterpart of cfdtpu/scenarios/stenosis_with_tree_2d_pressure.py
(a rebuild of the reference's
src/scenarios/stenosis_with_tree_2d_pressure.py): the stenosis+tree
union domain driven by weak pressure + Nitsche + resistance terminal
outlets + backflow (stabilized_schur_pressure_backflow physics, header
:1-12), writing FFR and a local Reynolds-number field snapshot
Re = rho |u| (2 R_local) / mu at the end of the run (:724-814). Any
weak-pressure solver runs it; without R_resistance the outlets take
p_outlet (stabilized_schur_pressurebc).
"""

from __future__ import annotations

import os

import numpy as np

from .base import to_numpy
from .stenosis_with_tree_2d import StenosisWithTree2DSimulation


class StenosisWithTree2DPressureSimulation(StenosisWithTree2DSimulation):
    def solve(self, output_folder, afterStepCallback=None):
        result = super().solve(output_folder, afterStepCallback)
        self._write_reynolds_field(output_folder)
        return result

    def _write_reynolds_field(self, output_folder):
        """Local Reynolds field Re(x) = rho |u| D_local / mu with the
        characteristic diameter from the stenosis radius profile inside
        the channel and the root diameter in the tree, written as the
        `reynolds` VTU series (one snapshot) and kept as self.reynolds;
        one host read of u."""
        from ..geom.stenosis2d import stenosis_radius_profile
        from ..io import VTUSeriesWriter

        o = self.mesh_options
        solver = self.solver
        u = to_numpy(solver.u_sol)
        coords = solver.V.dof_coords
        xs, rs = stenosis_radius_profile(
            o["L"], o["R_in"], o["R_out"], o["x_position_stenosis"],
            o["severity"], o["slope"], o["tension"],
        )
        r_local = np.interp(
            coords[:, 0], xs, rs, left=o["R_in"], right=0.9 * o["R_out"]
        )
        speed = np.linalg.norm(u, axis=1)
        re_field = (
            self.solver.rho * speed * 2.0 * r_local / self.solver.mu
        )
        w = VTUSeriesWriter(
            os.path.join(output_folder, "reynolds"), self.mesh,
            "reynolds",
        )
        w.write(0.0, re_field)
        print(f"[reynolds] max local Re = {re_field.max():.2f}")
        self.reynolds = re_field
        return re_field
