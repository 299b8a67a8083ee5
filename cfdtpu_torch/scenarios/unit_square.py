"""Minimal debugging scenario on the unit square.

The counterpart of cfdtpu/scenarios/unit_square.py: Dirichlet-driven
flow on a coarse built-in mesh (the top edge moves at u = (1, 0), the
other edges are at rest): the cheapest smoke case, with no geometry.

`device` selects where the solver runs: the CUDA card by default (no
card is an error), device="cpu" for the CPU. dtype="auto" resolves to
float32 on CUDA and float64 on the CPU.
"""

from __future__ import annotations

import numpy as np

from ..mesh import create_unit_square
from ..spaces import BoundaryCondition
from ..utils import resolve_device, resolve_dtype
from .base import Scenario


class UnitSquareSimulation(Scenario):
    def __init__(
        self,
        solver_name,
        dt,
        T,
        f=(0, 0),
        *,
        rho=1,
        mu=1,
        nx=16,
        dtype="auto",
        device=None,
        **solver_kwargs,
    ):
        self._mesh = None
        self._bcu = None
        self._bcp = None
        self.nx = int(nx)
        self.device = resolve_device(device)
        self._dtype = resolve_dtype(dtype, self.device)
        super().__init__(
            solver_name, "unit_square", rho, mu, dt, T, f,
            device=self.device, **solver_kwargs,
        )
        self.setup()

    @property
    def mesh(self):
        if self._mesh is None:
            self._mesh = create_unit_square(
                self.nx, self.nx, dtype=self._dtype
            )
        return self._mesh

    @property
    def bcu(self):
        if self._bcu is None:
            facets = self.mesh.locate_boundary_facets(
                lambda x: np.full(x.shape[1], True)
            )
            bc = BoundaryCondition(self.boundary_velocity)
            bc.initTopological(self.mesh.dim - 1, facets)
            self._bcu = [bc]
        return self._bcu

    @property
    def bcp(self):
        if self._bcp is None:
            self._bcp = []
        return self._bcp

    @staticmethod
    def boundary_velocity(x):
        return np.vstack(
            (np.sin(np.pi * x[1]) * 0.0 + 1.0, np.zeros(x.shape[1]))
        ) * np.where(np.isclose(x[1], 1.0), 1.0, 0.0)

    def initial_velocity(self, x):
        return np.zeros((2, x.shape[1]), dtype=self._dtype)
