"""Pressure-driven pipe-with-cylinder scenario.

The counterpart of cfdtpu/scenarios/pipe_cylinder_pressurebc.py: the
DFG 2D-1 geometry (geom/dfg.py) driven by weak pressures at the inlet
and outlet (p_inlet and p_outlet are passed to a weak-pressure solver
such as stabilized_schur_pressurebc; a solver that does not take
p_outlet leaves it unused); only the walls and the obstacle are
no-slip, and no pressure is prescribed.

`device` selects where the solver runs: the CUDA card by default (no
card is an error), device="cpu" for the CPU. dtype="auto" resolves to
float32 on CUDA and float64 on the CPU.
"""

from __future__ import annotations

import numpy as np

from ..geom.dfg import generate_dfg_mesh
from ..spaces import BoundaryCondition
from ..utils import resolve_device, resolve_dtype
from .base import Scenario


class PipeCylinderPressureBC(Scenario):
    fluid_marker = 1
    inlet_marker = 2
    outlet_marker = 3
    wall_marker = 4
    obstacle_marker = 5

    def __init__(self, solver_name, dt, T, f=(0, 0), *, rho=1, mu=1 / 1000,
                 p_inlet: float, p_outlet: float, res_scale=1.0,
                 dtype="auto", device=None, **solver_kwargs):
        self._mesh = None
        self._bcu = None
        self._bcp = None
        self.res_scale = float(res_scale)
        self.device = resolve_device(device)
        self._dtype = resolve_dtype(dtype, self.device)
        super().__init__(
            solver_name, "pipe_cylinder_pressurebc", rho, mu, dt, T, f,
            p_inlet=float(p_inlet), p_outlet=float(p_outlet),
            device=self.device, **solver_kwargs,
        )
        self.setup()

    @property
    def mesh(self):
        if self._mesh is None:
            self._mesh = generate_dfg_mesh(
                res_scale=self.res_scale, dtype=self._dtype,
                inlet_marker=self.inlet_marker,
                outlet_marker=self.outlet_marker,
                wall_marker=self.wall_marker,
                obstacle_marker=self.obstacle_marker,
            )
        return self._mesh

    @property
    def bcu(self):
        """No-slip walls and obstacle only (inlet and outlet are driven
        by the weak pressures)."""
        if self._bcu is None:
            walls = BoundaryCondition(np.zeros(2, dtype=self._dtype))
            walls.initTopological(1, self.mesh.tagged_facets(self.wall_marker))
            obs = BoundaryCondition(np.zeros(2, dtype=self._dtype))
            obs.initTopological(
                1, self.mesh.tagged_facets(self.obstacle_marker))
            self._bcu = [walls, obs]
        return self._bcu

    @property
    def bcp(self):
        if self._bcp is None:
            self._bcp = []
        return self._bcp

    def initial_velocity(self, x):
        return np.zeros((2, x.shape[1]), dtype=self._dtype)
