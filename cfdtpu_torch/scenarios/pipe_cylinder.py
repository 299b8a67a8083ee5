"""Pipe-with-cylinder scenarios: the DFG geometry with a parabolic inlet.

The counterpart of cfdtpu/scenarios/pipe_cylinder.py: the dfg_1
channel and cylinder (geom/dfg.py) with a parabolic inlet of peak
u_max and p = 0 Dirichlet at the outlet (PipeCylinderSimulation), and
PipeCylinder2D2Simulation, the unsteady DFG 2D-2 benchmark, which
records the drag and lift coefficients of every step into
bdforces.txt, to be held against the FEATFLOW series of
validation/data/pipe_cylinder (validation/dfg.py,
scripts/validate_dfg2d2.py).

`device` selects where the solver runs: the CUDA card by default (no
card is an error), device="cpu" for the CPU. dtype="auto" resolves to
float32 on CUDA and float64 on the CPU.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..geom.dfg import generate_dfg_mesh
from ..spaces import BoundaryCondition
from ..utils import resolve_device, resolve_dtype
from .base import Scenario

FLUSH_ROWS = 64  # force rows kept on the card between two host reads


def _write_row(f, row):
    f.write(f"{row[0]} {row[1]:.6f} {row[2]:.8e} {row[3]:.8e}\n")


class PipeCylinderSimulation(Scenario):
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
        u_max=0.3,
        res_scale=1.0,
        dtype="auto",
        device=None,
        **solver_kwargs,
    ):
        self._mesh = None
        self._bcu = None
        self._bcp = None
        self.u_max = float(u_max)
        self.res_scale = float(res_scale)
        self.device = resolve_device(device)
        self._dtype = resolve_dtype(dtype, self.device)
        super().__init__(
            solver_name, "pipe_cylinder", rho, mu, dt, T, f,
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
        if self._bcu is None:
            u_max = self.u_max

            def inlet(x):
                values = np.zeros((2, x.shape[1]))
                values[0] = 4 * u_max * x[1] * (0.41 - x[1]) / (0.41 ** 2)
                return values

            bcu_in = BoundaryCondition(inlet)
            bcu_in.initTopological(
                1, self.mesh.tagged_facets(self.inlet_marker)
            )
            bcu_walls = BoundaryCondition(np.zeros(2, dtype=self._dtype))
            bcu_walls.initTopological(
                1, self.mesh.tagged_facets(self.wall_marker)
            )
            bcu_obs = BoundaryCondition(np.zeros(2, dtype=self._dtype))
            bcu_obs.initTopological(
                1, self.mesh.tagged_facets(self.obstacle_marker)
            )
            self._bcu = [bcu_in, bcu_obs, bcu_walls]
        return self._bcu

    @property
    def bcp(self):
        if self._bcp is None:
            bc_out = BoundaryCondition(0.0)
            bc_out.initTopological(
                1, self.mesh.tagged_facets(self.outlet_marker)
            )
            self._bcp = [bc_out]
        return self._bcp

    def initial_velocity(self, x):
        return np.zeros((2, x.shape[1]), dtype=self._dtype)


class PipeCylinder2D2Simulation(PipeCylinderSimulation):
    """DFG 2D-2: unsteady periodic vortex shedding at Re = 100
    (u_max = 1.5, U_mean = 1.0). Writes bdforces.txt, one row a step
    with the columns `timestep time cd cl`, the quantities of the
    FEATFLOW series in validation/data/pipe_cylinder. Compare with
    validation.dfg.featflow_reference_stats and DFG_2D2_INTERVALS
    (c_Dmax, c_Lmax, Strouhal) once the shedding is developed
    (scripts/validate_dfg2d2.py).

    The forces stay on the card during the march: each step's (F_D, F_L)
    pair is kept as a tensor, and every FLUSH_ROWS steps the pending
    pairs are stacked and read to the host at once, then appended to
    bdforces_partial.txt; so is a partial chunk before every checkpoint
    save (pre_checkpoint) and at the end. A run killed mid-march keeps
    its series up to the last flush, and a run resumed from a checkpoint
    appends to it."""

    def __init__(self, solver_name, dt, T, **kw):
        kw.setdefault("u_max", 1.5)
        kw.setdefault("mu", 1e-3)
        self._force_rows = []
        super().__init__(solver_name, dt, T, **kw)

    def _coef_scale(self):
        # c = 2 F / (rho U_mean^2 L), U_mean = 2/3 u_max, L = 0.1
        um = 2.0 / 3.0 * self.u_max
        return 2.0 / (float(self.solver.rho) * um * um * 0.1)

    def _reconcile(self, part_path):
        """The rows of bdforces_partial.txt that the checkpoint resumed
        from owns. Flushes and checkpoints keep cadences of their own,
        so a leg killed mid-march may have flushed past its last
        checkpoint; replaying from it would then append duplicate rows
        with time going backward (which breaks the zero-crossing
        Strouhal statistics). Row k holds step k + 1, so a checkpoint at
        step c owns the first c rows: the rest are dropped, and the file
        rewritten. (Rows cannot be missing behind the checkpoint:
        pre_checkpoint flushes before every save.)"""
        step_ckpt = int(np.load(self.resume_from)["step"])
        prior = np.loadtxt(part_path, ndmin=2)
        self._force_rows = [
            (int(r[0]), float(r[1]), float(r[2]), float(r[3]))
            for r in prior if int(r[0]) < step_ckpt
        ]
        if len(self._force_rows) < prior.shape[0]:
            with open(part_path, "w") as f:
                f.write("# timestep time cd cl\n")
                for row in self._force_rows:
                    _write_row(f, row)

    def solve(self, output_folder, afterStepCallback=None):
        from ..postprocess.forces import BoundaryForce

        s = self.solver
        bf = BoundaryForce(
            s.V, s.Q, self.mesh.tagged_facets(self.obstacle_marker),
            device=s.device, dtype=s.np_dtype,
        )
        scale = self._coef_scale()
        self._force_rows = []
        part_path = os.path.join(output_folder, "bdforces_partial.txt")
        if self.resume_from and os.path.exists(part_path):
            self._reconcile(part_path)
        else:
            os.makedirs(output_folder, exist_ok=True)
            with open(part_path, "w") as f:
                f.write("# timestep time cd cl\n")
        pend: list = []

        def flush():
            if not pend:
                return
            ts = [t for t, _ in pend]
            arr = torch.stack([v for _, v in pend]).cpu().numpy()
            pend.clear()
            base = len(self._force_rows)
            with open(part_path, "a") as f:
                for j in range(arr.shape[0]):
                    row = (base + j, ts[j], scale * float(arr[j, 0]),
                           scale * float(arr[j, 1]))
                    self._force_rows.append(row)
                    _write_row(f, row)

        def record(t):
            fd, fl = bf.drag_lift(s.u_sol, s.p_sol, s.mu)
            pend.append((float(t), torch.stack([fd, fl])))
            if len(pend) == FLUSH_ROWS:
                flush()
            if afterStepCallback:
                afterStepCallback(t)

        self.pre_checkpoint = flush
        try:
            out_path = super().solve(output_folder, record)
        finally:
            del self.pre_checkpoint  # back to the class's no-op
        flush()
        with open(f"{out_path}/bdforces.txt", "w") as f:
            f.write("# timestep time cd cl\n")
            for row in self._force_rows:
                _write_row(f, row)
        return out_path
