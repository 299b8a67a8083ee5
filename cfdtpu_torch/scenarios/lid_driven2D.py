"""Lid-driven cavity scenario.

The counterpart of cfdtpu/scenarios/lid_driven2D.py: unit square,
no-slip on the left, right and bottom walls, unit lid velocity on top
excluding the corners, no pressure condition (the solver's numeric
nullspace test on the first Jacobian decides the projection), Re = 1/mu.
After the run, save_benchmark_plot writes benchmark_<Re>.csv, the
centerline u(y) beside Ghia et al.'s Table I (validation/ghia.py), and
a PNG of it where matplotlib is installed.

`device` selects where the solver runs: the CUDA card by default (no
card is an error), device="cpu" for the CPU. dtype="auto" resolves to
float32 on CUDA and float64 on the CPU.
"""

from __future__ import annotations

import os

import numpy as np

from ..mesh import create_unit_square
from ..spaces import BoundaryCondition
from ..utils import resolve_device, resolve_dtype
from .base import Scenario, to_numpy


class LidDriven2DSimulation(Scenario):
    def __init__(
        self,
        solver_name,
        dt,
        T,
        f=(0, 0),
        *,
        rho=1,
        mu=1,
        nx=50,
        dtype="auto",
        device=None,
        **solver_kwargs,
    ):
        self._mesh = None
        self._bcu = None
        self._bcp = None
        self.Re = str(int(1 / mu))
        self.nx = int(nx)
        self.device = resolve_device(device)
        self._dtype = resolve_dtype(dtype, self.device)
        super().__init__(
            solver_name, "lid_driven2D", rho, mu, dt, T, f,
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
            walls_facets = self.mesh.locate_boundary_facets(self.walls)
            bc_noslip = BoundaryCondition(np.zeros(2, dtype=self._dtype))
            bc_noslip.initTopological(self.mesh.dim - 1, walls_facets)

            lid_facets = self.mesh.locate_boundary_facets(self.lid)
            bc_lid = BoundaryCondition(
                lambda x: np.vstack((np.ones(x.shape[1]),
                                     np.zeros(x.shape[1])))
            )
            bc_lid.initTopological(self.mesh.dim - 1, lid_facets)

            self._bcu = [bc_noslip, bc_lid]
        return self._bcu

    @property
    def bcp(self):
        if self._bcp is None:
            self._bcp = []
        return self._bcp

    def initial_velocity(self, x):
        return np.zeros((2, x.shape[1]), dtype=self._dtype)

    def solve(self, output_folder, afterStepCallback=None):
        out_path = super().solve(output_folder, afterStepCallback)
        self.save_benchmark_plot(out_path)
        return out_path

    def centerline_u(self, y) -> np.ndarray:
        """u_x of the current solution at (0.5, y): one host read."""
        from ..postprocess import eval_at_points

        pts = np.stack([np.full_like(y, 0.5), y], axis=-1)
        return eval_at_points(
            self.solver.V, to_numpy(self.solver.u_sol), pts)[:, 0]

    def save_benchmark_plot(self, results_path):
        """Compare the centerline u(y) profile against Ghia et al. and
        save benchmark_<Re>.csv, and benchmark_<Re>.png when matplotlib
        is installed (without it, the PNG alone is skipped)."""
        from ..validation import GHIA_U_CENTERLINE

        re_key = int(self.Re)
        if re_key not in GHIA_U_CENTERLINE:
            print(
                f"Benchmark data for Re={self.Re} not found. Skipping plot."
            )
            return
        y, u_bench = GHIA_U_CENTERLINE[re_key]
        u_sol = self.centerline_u(y)
        csv = os.path.join(results_path, f"benchmark_{self.Re}.csv")
        with open(csv, "w") as f:
            f.write("y,u_solver,u_ghia\n")
            for yy, us, ub in zip(y, u_sol, u_bench):
                f.write(f"{yy},{us},{ub}\n")
        try:
            import matplotlib
        except ImportError:
            return
        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        fig, ax = plt.subplots()
        ax.plot(u_sol, y, "o-", label="cfdtpu_torch")
        ax.plot(u_bench, y, "s--", label="Ghia et al.")
        ax.set_xlabel("u at x=0.5")
        ax.set_ylabel("y")
        ax.legend()
        fig.savefig(os.path.join(results_path, f"benchmark_{self.Re}.png"))
        plt.close(fig)

    @staticmethod
    def lid(x):
        return np.isclose(x[1], 1.0) & (x[0] > 1e-10) & (x[0] < 1.0 - 1e-10)

    @staticmethod
    def walls(x):
        return np.logical_or.reduce(
            (np.isclose(x[0], 0), np.isclose(x[0], 1), np.isclose(x[1], 0))
        )
