"""DFG 3D flow-around-cylinder benchmark scenario (Schafer and Turek
1996, test cases 3D-1Z and 3D-2Z).

A 2.5 x 0.41 x 0.41 channel with a cylinder of diameter D = 0.1 whose
axis runs along z through (0.5, 0.2) (geom/dfg3d.py: the graded DFG
cross-section extruded into P1 tetrahedra); the inflow u_x = 16 U_m y z
(H - y)(H - z) / H^4 (U_m = 0.45: U_mean = 4 U_m / 9 = 0.2 and Re = 20 at
rho = 1, mu = 1e-3; 3D-2Z takes U_m = 2.25), no slip on the walls and
the cylinder, p = 0 on the outlet. Post-processing writes drag_lift.txt
(c_D, c_L = 2 F / (rho U_mean^2 D H) of the traction force on the
cylinder) and pressure_diff.txt (p(0.45, 0.2, 0.205) - p(0.55, 0.2,
0.205)); the published intervals of 3D-1Z are c_D 6.05-6.25, c_L
0.008-0.010 and dp 0.165-0.175.

`device` selects where the solver runs: the CUDA card by default (no
card is an error), device="cpu" for the CPU. dtype="auto" resolves to
float32 on CUDA and float64 on the CPU.
"""

from __future__ import annotations

import numpy as np

from ..geom.dfg3d import H, R, generate_dfg3d_mesh
from ..spaces import BoundaryCondition
from ..utils import resolve_device, resolve_dtype
from .base import Scenario

# the cells' and facets' quadrature: the degree-4 rules, 14 points on a
# tetrahedron and 6 on a triangle (the default 2 k + 1 = 3 is a 5-point
# rule with a negative weight on tetrahedra; DFG 2D-1's triangles take
# the same 6-point rule at degree 3)
QUAD_DEGREE = 4
# the probes of the pressure difference
P_FRONT = (0.45, 0.2, 0.205)
P_BACK = (0.55, 0.2, 0.205)


class DFG3DBenchmark(Scenario):
    fluid_marker = 1
    inlet_marker = 2
    outlet_marker = 3
    wall_marker = 4
    obstacle_marker = 5

    def __init__(self, solver_name, dt, T, f=(0, 0, 0), *, rho=1,
                 mu=1 / 1000, u_max=0.45, res_scale=1.0, layers=16,
                 dtype="auto", device=None, **solver_kwargs):
        self._mesh = None
        self._bcu = None
        self._bcp = None
        self.mu = mu
        self.rho = rho
        self.u_max = float(u_max)
        self.res_scale = float(res_scale)
        self.layers = int(layers)
        self.device = resolve_device(device)
        self._dtype = resolve_dtype(dtype, self.device)
        solver_kwargs.setdefault("quad_degree", QUAD_DEGREE)
        super().__init__(solver_name, "dfg_3d", rho, mu, dt, T, f,
                         device=self.device, **solver_kwargs)
        self.setup()

    # ------------------------------------------------------------------
    @property
    def mesh(self):
        if self._mesh is None:
            self._mesh = generate_dfg3d_mesh(
                res_scale=self.res_scale, layers=self.layers,
                dtype=self._dtype, inlet_marker=self.inlet_marker,
                outlet_marker=self.outlet_marker,
                wall_marker=self.wall_marker,
                obstacle_marker=self.obstacle_marker)
        return self._mesh

    @property
    def bcu(self):
        if self._bcu is None:
            inflow = BoundaryCondition(self.inlet_velocity)
            inflow.initTopological(2, self.mesh.tagged_facets(
                self.inlet_marker))
            obstacle = BoundaryCondition(np.zeros(3, dtype=self._dtype))
            obstacle.initTopological(2, self.mesh.tagged_facets(
                self.obstacle_marker))
            walls = BoundaryCondition(np.zeros(3, dtype=self._dtype))
            walls.initTopological(2, self.mesh.tagged_facets(
                self.wall_marker))
            self._bcu = [inflow, obstacle, walls]
        return self._bcu

    @property
    def bcp(self):
        if self._bcp is None:
            outflow = BoundaryCondition(0.0)
            outflow.initTopological(2, self.mesh.tagged_facets(
                self.outlet_marker))
            self._bcp = [outflow]
        return self._bcp

    def initial_velocity(self, x):
        return np.zeros((3, x.shape[1]), dtype=self._dtype)

    def inlet_velocity(self, x):
        values = np.zeros((3, x.shape[1]))
        y, z = x[1], x[2]
        values[0] = 16 * self.u_max * y * z * (H - y) * (H - z) / H ** 4
        return values

    # ------------------------------------------------------------------
    def force_coefficients(self):
        """(c_D, c_L): 2 F / (rho U_mean^2 D H) of the traction force on
        the cylinder, U_mean = 4 U_m / 9."""
        from ..postprocess.forces import BoundaryForce

        s = self.solver
        bf = BoundaryForce(s.V, s.Q, self.mesh.tagged_facets(
            self.obstacle_marker), device=s.device, dtype=s.np_dtype)
        F = bf.traction_force(s.u_sol, s.p_sol, self.mu).double().cpu()
        scale = 2.0 / (self.rho * (4 * self.u_max / 9) ** 2 * (2 * R) * H)
        return float(scale * F[0]), float(scale * F[1])

    def pressure_difference(self):
        from ..postprocess import eval_at_points
        from .base import to_numpy

        Q = self.solver.Q
        pts = np.array([P_FRONT, P_BACK])
        # where the layers put nodes at z = 0.205 (an even number), each
        # probe is a node on the cylinder; in float32 that node lies ~1e-8
        # off the probe, which then falls outside every fluid cell near a
        # fine cylinder, so a probe that close to a node reads the node
        x = Q.mesh.points.astype(np.float64)
        dist = np.linalg.norm(x[None] - pts[:, None], axis=-1)
        near = dist.argmin(axis=1)
        snap = dist[np.arange(len(pts)), near] < 1e-6
        pts[snap] = x[near[snap]]
        vals = eval_at_points(Q, to_numpy(self.solver.p_sol), pts)
        return float(vals[0] - vals[1])

    def solve(self, output_folder, afterStepCallback=None):
        out_path = super().solve(output_folder, afterStepCallback)
        cd, cl = self.force_coefficients()
        dp = self.pressure_difference()
        print(f"c_D: {cd}\nc_L: {cl}\nPressure difference: {dp}")
        with open(f"{out_path}/drag_lift.txt", "w") as f:
            f.write(f"c_D: {cd}\nc_L: {cl}\n")
        with open(f"{out_path}/pressure_diff.txt", "w") as f:
            f.write(f"Pressure difference: {dp}\n")
        return out_path

