"""DFG 2D-1 flow-around-cylinder benchmark scenario.

The counterpart of cfdtpu/scenarios/dfg_1.py: 2.2 x 0.41 channel with
an r = 0.05 cylinder at (0.2, 0.2), parabolic inlet
u_x = 4 U_max y (0.41 - y)/0.41^2 with U_max = 0.3 (Re = 20 at
rho = 1, mu = 1e-3), no-slip walls and obstacle, p = 0 at the outlet.
Post-processing writes drag_lift.txt (c_D = 500 F_D, c_L = 500 F_L),
drag_lift_reaction.txt and pressure_diff.txt from probes at
(0.15, 0.2) / (0.25, 0.2).

`device` selects where the solver runs; dtype="auto" resolves to
float32 on CUDA and float64 on the CPU.
"""

from __future__ import annotations

import numpy as np

from ..geom.dfg import generate_dfg_mesh
from ..spaces import BoundaryCondition
from ..utils import resolve_device, resolve_dtype
from .base import Scenario, to_numpy


class DFG1Benchmark(Scenario):
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
        res_scale=1.0,
        res_min=None,
        res_max=None,
        dtype="auto",
        device="cpu",
        **solver_kwargs,
    ):
        self._mesh = None
        self._bcu = None
        self._bcp = None
        self.mu = mu
        self.rho = rho
        self.res_scale = float(res_scale)
        self.res_min = None if res_min is None else float(res_min)
        self.res_max = None if res_max is None else float(res_max)
        self.device = resolve_device(device)
        self._dtype = resolve_dtype(dtype, self.device)
        super().__init__(
            solver_name, "dfg_1", rho, mu, dt, T, f, device=self.device,
            **solver_kwargs,
        )
        self.setup()

    # ------------------------------------------------------------------
    @property
    def mesh(self):
        if self._mesh is None:
            self._mesh = self.generate_mesh()
        return self._mesh

    def generate_mesh(self):
        return generate_dfg_mesh(
            res_min=self.res_min,
            res_max=self.res_max,
            res_scale=self.res_scale,
            dtype=self._dtype,
            inlet_marker=self.inlet_marker,
            outlet_marker=self.outlet_marker,
            wall_marker=self.wall_marker,
            obstacle_marker=self.obstacle_marker,
        )

    # ------------------------------------------------------------------
    @property
    def bcu(self):
        if self._bcu is None:
            bcu_inflow = BoundaryCondition(self.inlet_velocity)
            bcu_inflow.initTopological(
                1, self.mesh.tagged_facets(self.inlet_marker)
            )
            bcu_walls = BoundaryCondition(np.zeros(2, dtype=self._dtype))
            bcu_walls.initTopological(
                1, self.mesh.tagged_facets(self.wall_marker)
            )
            bcu_obstacle = BoundaryCondition(np.zeros(2, dtype=self._dtype))
            bcu_obstacle.initTopological(
                1, self.mesh.tagged_facets(self.obstacle_marker)
            )
            self._bcu = [bcu_inflow, bcu_obstacle, bcu_walls]
        return self._bcu

    @property
    def bcp(self):
        if self._bcp is None:
            bc_outflow = BoundaryCondition(0.0)
            bc_outflow.initTopological(
                1, self.mesh.tagged_facets(self.outlet_marker)
            )
            self._bcp = [bc_outflow]
        return self._bcp

    def initial_velocity(self, x):
        return np.zeros((2, x.shape[1]), dtype=self._dtype)

    @staticmethod
    def inlet_velocity(x):
        values = np.zeros((2, x.shape[1]))
        values[0] = 4 * 0.3 * x[1] * (0.41 - x[1]) / (0.41 ** 2)
        return values

    # ------------------------------------------------------------------
    def solve(self, output_folder, afterStepCallback=None):
        out_path = super().solve(output_folder, afterStepCallback)
        self.write_benchmark_outputs(out_path)
        return out_path

    def compute_drag_lift(self, method: str = "line"):
        """Obstacle forces. method="line": the boundary line integral
        (first-order accurate on P1). method="reaction": consistent
        reaction forces — the raw weak residual summed over the obstacle
        Dirichlet dofs, with the natural-correction facet block
        removed."""
        s = self.solver
        if method == "reaction":
            form = s.form
            prm = s.params()
            aux = tuple(s.u_sol for _ in range(form.N_AUX))
            ru, _ = form.residual(s.u_sol, s.p_sol, aux, prm)
            for block in form._facet_blocks:
                if block["name"] != "natural_correction":
                    continue
                _, ru_f = form._block_residual(
                    block, s.u_sol, s.p_sol, aux, prm
                )
                ru = ru - block["scatter_u"](
                    ru_f.reshape(-1, ru.shape[1]).contiguous())
            obs = s.V.facet_closure_dofs(
                self.mesh.tagged_facets(self.obstacle_marker)
            )
            F = -to_numpy(ru)[obs].sum(axis=0)
            return float(F[0]), float(F[1])

        from ..postprocess.forces import BoundaryForce

        bf = BoundaryForce(
            s.V, s.Q, self.mesh.tagged_facets(self.obstacle_marker),
            device=s.device, dtype=s.np_dtype,
        )
        fd, fl = bf.drag_lift(s.u_sol, s.p_sol, self.mu)
        return float(fd), float(fl)

    def compute_pressure_diff(self):
        from ..postprocess import eval_at_points

        pts = np.array([[0.15, 0.2], [0.25, 0.2]])
        vals = eval_at_points(self.solver.Q, to_numpy(self.solver.p_sol),
                              pts)
        return float(vals[0] - vals[1])

    def write_benchmark_outputs(self, out_path):
        fd, fl = self.compute_drag_lift()
        print(f"Drag: {500 * fd}")
        print(f"Lift: {500 * fl}")
        with open(f"{out_path}/drag_lift.txt", "w") as f:
            f.write(f"Drag: {500 * fd}\n")
            f.write(f"Lift: {500 * fl}\n")
        fdr, flr = self.compute_drag_lift(method="reaction")
        with open(f"{out_path}/drag_lift_reaction.txt", "w") as f:
            f.write(f"Drag: {500 * fdr}\n")
            f.write(f"Lift: {500 * flr}\n")
        p_diff = self.compute_pressure_diff()
        print(f"Pressure difference: {p_diff}")
        with open(f"{out_path}/pressure_diff.txt", "w") as f:
            f.write(f"Pressure difference: {p_diff}\n")
