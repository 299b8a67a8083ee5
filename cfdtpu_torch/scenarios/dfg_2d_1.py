"""Steady DFG 2D-1 scenario (paired with the dfg_2d_1 solver).

The counterpart of cfdtpu/scenarios/dfg_2d_1.py: the channel and
cylinder of scenarios/dfg_1.py meshed at `res` (res_min = res near the
obstacle growing to res_max = 3 res; cfdtpu's default res 0.005),
parabolic inlet U_max = 0.3, no-slip walls and obstacle, and no
pressure condition: the outlet's do-nothing, viscous-traction and
backflow terms and the per-step drag and lift live in the dfg_2d_1
solver.

`device` selects where the solver runs: the CUDA card by default
(no card is an error), device="cpu" for the CPU. dtype="auto" resolves
to float32 on CUDA and float64 on the CPU.
"""

from __future__ import annotations

import numpy as np

from ..geom.dfg import generate_dfg_mesh
from ..spaces import BoundaryCondition
from ..utils import resolve_device, resolve_dtype
from .base import Scenario
from .dfg_1 import DFG1Benchmark


class DFG2D1Steady(Scenario):
    fluid_marker = 1
    inlet_marker = 2
    outlet_marker = 3
    wall_marker = 4
    obstacle_marker = 5

    def __init__(
        self,
        solver_name,
        dt,
        T,
        f=(0, 0),
        *,
        rho=1,
        mu=1 / 1000,
        res=0.005,
        dtype="auto",
        device=None,
        **solver_kwargs,
    ):
        self._mesh = None
        self._bcu = None
        self._bcp = None
        self.res = float(res)
        self.device = resolve_device(device)
        self._dtype = resolve_dtype(dtype, self.device)
        super().__init__(
            solver_name, "dfg_2d_1", rho, mu, dt, T, f, device=self.device,
            **solver_kwargs,
        )
        self.setup()

    @property
    def mesh(self):
        if self._mesh is None:
            self._mesh = generate_dfg_mesh(
                res_min=self.res,
                res_max=3 * self.res,
                dtype=self._dtype,
                inlet_marker=self.inlet_marker,
                outlet_marker=self.outlet_marker,
                wall_marker=self.wall_marker,
                obstacle_marker=self.obstacle_marker,
            )
        return self._mesh

    @property
    def bcu(self):
        if self._bcu is None:
            bcu_inflow = BoundaryCondition(self.inlet_velocity)
            bcu_inflow.initTopological(
                1, self.mesh.tagged_facets(self.inlet_marker))
            bcu_walls = BoundaryCondition(np.zeros(2, dtype=self._dtype))
            bcu_walls.initTopological(
                1, self.mesh.tagged_facets(self.wall_marker))
            bcu_obstacle = BoundaryCondition(np.zeros(2, dtype=self._dtype))
            bcu_obstacle.initTopological(
                1, self.mesh.tagged_facets(self.obstacle_marker))
            self._bcu = [bcu_inflow, bcu_obstacle, bcu_walls]
        return self._bcu

    @property
    def bcp(self):
        if self._bcp is None:
            self._bcp = []  # the outlet is weak, in the dfg_2d_1 solver
        return self._bcp

    def initial_velocity(self, x):
        return np.zeros((2, x.shape[1]), dtype=self._dtype)

    inlet_velocity = staticmethod(DFG1Benchmark.inlet_velocity)
