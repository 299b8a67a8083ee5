"""2-D pressure-driven channel flow on a quadrilateral rectangle mesh.

The counterpart of cfdtpu/scenarios/unit_square_pipe.py: an 80 x 1.5 mm
channel of 587 x 11 quadrilaterals, blood in the mm-g-s system
(rho = 1.06e-3 g/mm^3, mu = 3.5e-3 g/(mm s)), Dirichlet pressure
p_inlet at x = 0 and p_outlet at x = L, no-slip walls. Plane Poiseuille
gives dP = 12 mu U_mean L / H^2 ~ 7.47 Pa for U_mean = 5 mm/s.

`device` selects where the solver runs: the CUDA card by default (no
card is an error), device="cpu" for the CPU. dtype="auto" resolves to
float32 on CUDA and float64 on the CPU. The element kernels cover P1
triangles only, so on the card this quadrilateral mesh raises (B5f in
ROADMAP.md); on the CPU the plain versions run.
"""

from __future__ import annotations

import numpy as np

from ..mesh import create_rectangle
from ..spaces import BoundaryCondition
from ..utils import resolve_device, resolve_dtype
from .base import Scenario

_L = 80.0
_H = 1.5
_NX = 587
_NY = 11


class UnitSquarePipeSimulation(Scenario):
    inlet_marker = 1
    outlet_marker = 2
    wall_marker = 3

    def __init__(
        self,
        solver_name: str,
        dt: float,
        T: float,
        f=(0.0, 0.0),
        *,
        rho: float = 1.06e-3,
        mu: float = 3.5e-3,
        p_inlet: float,
        p_outlet: float,
        nx: int = _NX,
        ny: int = _NY,
        early_stop_tolerance: float = 1e-5,
        dtype="auto",
        device=None,
        **solver_kwargs,
    ):
        self.p_inlet = float(p_inlet)
        self.p_outlet = float(p_outlet)
        self.nx, self.ny = int(nx), int(ny)
        self.device = resolve_device(device)
        self._dtype = resolve_dtype(dtype, self.device)
        self._mesh = None
        self._bcu = None
        self._bcp = None
        super().__init__(
            solver_name,
            "unit_square_pipe",
            rho,
            mu,
            dt,
            T,
            list(f),
            early_stop_tolerance=early_stop_tolerance,
            p_inlet=self.p_inlet,
            p_outlet=self.p_outlet,
            device=self.device,
            **solver_kwargs,
        )
        self.setup()

    @property
    def mesh(self):
        if self._mesh is None:
            m = create_rectangle(
                (0.0, 0.0), (_L, _H), (self.nx, self.ny),
                cell_type="quadrilateral", dtype=self._dtype,
            )
            m.mark_boundary_facets(
                lambda x: np.isclose(x[0], 0.0), self.inlet_marker
            )
            m.mark_boundary_facets(
                lambda x: np.isclose(x[0], _L), self.outlet_marker
            )
            m.mark_boundary_facets(
                lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], _H),
                self.wall_marker,
            )
            self._mesh = m
        return self._mesh

    @property
    def bcu(self):
        """No-slip at the walls; inlet and outlet free (pressure-driven)."""
        if self._bcu is None:
            bc_walls = BoundaryCondition(np.zeros(2, dtype=self._dtype))
            bc_walls.initTopological(
                1, self.mesh.tagged_facets(self.wall_marker)
            )
            self._bcu = [bc_walls]
        return self._bcu

    @property
    def bcp(self):
        """Dirichlet pressure at the inlet and the outlet."""
        if self._bcp is None:
            bc_in = BoundaryCondition(float(self.p_inlet))
            bc_in.initTopological(
                1, self.mesh.tagged_facets(self.inlet_marker)
            )
            bc_out = BoundaryCondition(float(self.p_outlet))
            bc_out.initTopological(
                1, self.mesh.tagged_facets(self.outlet_marker)
            )
            self._bcp = [bc_in, bc_out]
        return self._bcp

    def initial_velocity(self, x):
        return np.zeros((2, x.shape[1]), dtype=self._dtype)
