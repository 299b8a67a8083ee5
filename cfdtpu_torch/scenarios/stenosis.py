"""Stenosed-artery scenario with FFR output.

The counterpart of cfdtpu/scenarios/stenosis.py (itself a rebuild of
the reference's src/scenarios/stenosis.py): 2D stenosed channel
(cubic-Bezier bump with C1 continuity) in the mm-g-s unit system
(1 mmHg = 133.322 g/(mm s^2), :14-18); blood parameters
rho = 1.060e-3 g/mm^3, mu = 3.5e-3 g/(mm s); stenosis grades
mild/moderate/severe = severity 0.25/0.50/0.75 at slope 0.3 (:27-31);
pressure-driven through the solver's weak pressure machinery
(p_inlet = 75 mmHg, p_outlet = 10 mmHg by default, converted to cgs-mm).
Outputs FFR = p_distal/p_proximal at the centerline endpoints (:163-211)
to ffr.txt. With v_max given (CBC/ddn/velocity solvers), a parabolic
Dirichlet inlet and a stenosis-aware flow-conserving initial velocity
(cosine-bump approximation of the Bezier profile, :220-261) are used.

`device` selects where the solver runs: the CUDA card by default (no
card is an error), device="cpu" for the CPU. dtype="auto" resolves to
float32 on CUDA and float64 on the CPU. The pressures are near 1e4 in
these units (75 mmHg = 9,999 g/(mm s^2)).
"""

from __future__ import annotations

import os

import numpy as np

from ..geom.stenosis2d import generate_stenosis_mesh_2d
from ..spaces import BoundaryCondition
from ..utils import resolve_device, resolve_dtype
from .base import Scenario, to_numpy

_MMHG = 133.322


class StenosisSimulation(Scenario):
    fluid_marker = 1
    inlet_marker = 2
    outlet_marker = 3
    wall_marker = 4

    stenosis_grades = {
        "mild": {"severity": 0.25, "slope": 0.3},
        "moderate": {"severity": 0.50, "slope": 0.3},
        "severe": {"severity": 0.75, "slope": 0.3},
    }

    def __init__(
        self,
        solver_name,
        dt,
        T,
        f=(0, 0),
        grade="severe",
        p_inlet: float = 75.0,  # mmHg
        p_outlet: float = 10.0,  # mmHg
        *,
        rho: float = 1.060e-3,
        mu: float = 3.5e-3,
        dtype="auto",
        device=None,
        **kwargs,
    ):
        self._mesh = None
        self._bcu = None
        self._bcp = None
        self.device = resolve_device(device)
        self._dtype = resolve_dtype(dtype, self.device)

        p_grade = kwargs.pop("p_grade", 1)
        beta_nitsche = kwargs.pop("beta_nitsche", 100.0)
        beta_backflow = kwargs.pop("beta_backflow", None)
        R_resistance = kwargs.pop("R_resistance", None)
        initial_ffr = kwargs.pop("initial_ffr", 0.8)
        v_max = kwargs.pop("v_max", None)
        solver_passthrough = {
            k: kwargs.pop(k)
            for k in list(kwargs)
            if k in (
                "pc_type", "pc_inner_u", "pc_inner_p", "pc_inner_method",
                "pc_schur_fact", "operator_format", "snes_ksp_ew",
                "ksp_restart", "ksp_rtol", "snes_rtol", "snes_max_it",
                "output_every", "early_stop_tolerance", "n_shards",
                "quad_degree",
            )
        }
        self.mesh_options = kwargs.copy()

        defaults = {
            "L": 138.0,
            "R_in": 1.57,
            "R_out": 1.2,
            "res": 0.15,
            "x_position_stenosis": 30.0,
            "severity": 0.567,
            "slope": 0.4,
            "tension": 0.5,
        }
        for k, v in defaults.items():
            self.mesh_options.setdefault(k, v)
        grade_params = self.stenosis_grades.get(
            grade, self.stenosis_grades["severe"]
        )
        for k, v in grade_params.items():
            self.mesh_options.setdefault(k, v)

        self._v_max = v_max

        solver_kwargs = {
            "p_inlet": float(p_inlet) * _MMHG,
            "p_grade": p_grade,
            "beta_nitsche": beta_nitsche,
            **solver_passthrough,
        }
        if beta_backflow is not None:
            solver_kwargs["beta_backflow"] = float(beta_backflow)
        if v_max is not None:
            solver_kwargs["v_max"] = float(v_max)
        if R_resistance is not None:
            solver_kwargs["R_resistance"] = float(R_resistance)
            solver_kwargs["initial_ffr"] = initial_ffr
        else:
            solver_kwargs["p_outlet"] = float(p_outlet) * _MMHG

        super().__init__(
            solver_name, "stenosis", rho, mu, dt, T, f, device=self.device,
            **solver_kwargs,
        )
        self.setup()

    # ------------------------------------------------------------------
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
            self._mesh = generate_stenosis_mesh_2d(
                dtype=self._dtype,
                inlet_marker=self.inlet_marker,
                outlet_marker=self.outlet_marker,
                wall_marker=self.wall_marker,
                **opts,
            )
        return self._mesh

    @property
    def bcu(self):
        if self._bcu is None:
            bcu_walls = BoundaryCondition(np.zeros(2, dtype=self._dtype))
            bcu_walls.initTopological(
                1, self.mesh.tagged_facets(self.wall_marker)
            )
            self._bcu = [bcu_walls]
            if self._v_max is not None:
                R_in = self.mesh_options["R_in"]
                v_max = float(self._v_max)

                def parabolic_inlet(x):
                    values = np.zeros((2, x.shape[1]))
                    r = x[1] - R_in
                    values[0] = v_max * (1.0 - (r / R_in) ** 2)
                    return values

                bcu_inlet = BoundaryCondition(parabolic_inlet)
                bcu_inlet.initTopological(
                    1, self.mesh.tagged_facets(self.inlet_marker)
                )
                self._bcu.append(bcu_inlet)
        return self._bcu

    @property
    def bcp(self):
        """Empty: pressure enters through the solver's weak BCs."""
        if self._bcp is None:
            self._bcp = []
        return self._bcp

    # ------------------------------------------------------------------
    def initial_velocity(self, x):
        if self._v_max is None:
            return np.zeros((2, x.shape[1]), dtype=self._dtype)

        o = self.mesh_options
        R_in, R_out, L = o["R_in"], o["R_out"], o["L"]
        x_sten = o["x_position_stenosis"]
        severity, slope = o["severity"], o["slope"]
        v_max = float(self._v_max)

        R_taper = R_in + (R_out - R_in) * (x[0] / L)
        r_taper_mid = R_in + (R_out - R_in) * (x_sten / L)
        h_sten = severity * r_taper_mid
        dist_x = h_sten / slope if slope > 0 else L / 4
        dist_x = max(dist_x, L * 0.05)
        dist_x = min(dist_x, min(x_sten, L - x_sten) * 0.95)

        dx_abs = np.abs(x[0] - x_sten)
        bump = np.where(
            dx_abs < dist_x,
            h_sten * 0.5 * (1.0 + np.cos(np.pi * dx_abs / dist_x)),
            0.0,
        )
        R_local = np.maximum(R_taper - bump, 1e-6)
        v_max_local = v_max * R_in / R_local
        r = x[1] - R_in
        values = np.zeros((2, x.shape[1]))
        values[0] = np.maximum(
            v_max_local * (1.0 - (r / R_local) ** 2), 0.0
        )
        return values

    # ------------------------------------------------------------------
    def solve(self, output_folder, afterStepCallback=None):
        result = super().solve(output_folder, afterStepCallback)
        self._compute_ffr(output_folder)
        return result

    def _compute_ffr(self, output_folder):
        """FFR = p_distal / p_proximal at the centerline's ends, printed
        and written to ffr.txt; returns it."""
        from ..postprocess import eval_at_points

        o = self.mesh_options
        R_in, L = o["R_in"], o["L"]
        pts = np.array([[0.0, R_in], [L, R_in]])
        p_vals = eval_at_points(
            self.solver.Q, to_numpy(self.solver.p_sol), pts
        )
        p_proximal, p_distal = float(p_vals[0]), float(p_vals[1])
        ffr = (
            p_distal / p_proximal
            if abs(p_proximal) > 1e-12
            else float("nan")
        )
        lines = [
            f"p_proximal (inlet center):  {p_proximal:.6f}",
            f"p_distal   (outlet center): {p_distal:.6f}",
            f"FFR = p_distal / p_proximal: {ffr:.6f}",
        ]
        txt = "\n".join(lines)
        print(f"\n[FFR] {txt}", flush=True)
        with open(os.path.join(output_folder, "ffr.txt"), "w") as f:
            f.write(txt + "\n")
        return ffr
