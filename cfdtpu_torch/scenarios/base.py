"""Scenario base class: solver loading, the time loop, outputs, early stop.

The counterpart of cfdtpu/scenarios/base.py: abstract mesh/bcu/bcp
properties, solver discovery by module name with kwarg filtering, the
time loop writing VTU series and solver_stats.txt, the early-stop
criterion (||u_sol - u_prev||_inf / ||u_sol||_inf) / dt < tol checked
every 10 steps, norms.txt, and checkpoints in cfdtpu's .npz format,
each save preceded by the pre_checkpoint hook (after the step
callback). Single process: there is no rank-0 I/O guard. Not ported
yet: the jax.profiler and --monitor hooks, and the exact-solution
error log (taylor_green, not ported, is its only user).
"""

from __future__ import annotations

import inspect
import os
import time
from abc import ABC, abstractmethod
from importlib import import_module
from typing import Callable

import numpy as np
import torch

from ..mesh import Mesh
from ..spaces import BoundaryCondition
from ..utils import trace
from ..solvers.base import SolverBase


def to_numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


class Scenario(ABC):
    @property
    @abstractmethod
    def mesh(self) -> Mesh:
        ...

    @property
    @abstractmethod
    def bcu(self) -> list[BoundaryCondition]:
        ...

    @property
    @abstractmethod
    def bcp(self) -> list[BoundaryCondition]:
        ...

    @abstractmethod
    def initial_velocity(self, x: np.ndarray) -> np.ndarray:
        ...

    def __init__(
        self,
        solver_name: str,
        scenario_name: str,
        rho: float,
        mu: float,
        dt: float,
        T: float,
        f,
        early_stop_tolerance: float = 1e-3,
        output_every: int = 1,
        checkpoint_every: int = 0,
        resume_from: str | None = None,
        **solver_kwargs,
    ):
        self.solver_name = solver_name
        self.scenario_name = scenario_name
        self.early_stop_tolerance = early_stop_tolerance
        self.output_every = max(1, int(output_every))
        self.checkpoint_every = int(checkpoint_every)
        self.resume_from = resume_from

        try:
            solver_module = import_module(
                f"cfdtpu_torch.solvers.{solver_name}")
        except ImportError as e:
            raise ImportError(
                f"Could not import solver '{solver_name}'. "
                f"Ensure cfdtpu_torch/solvers/{solver_name}.py exists.\n"
                f"Underlying error: {e}\n"
                f"Available solvers: {self._list_available_solvers()}"
            ) from e
        if not hasattr(solver_module, "Solver"):
            raise ValueError(
                f"Solver module 'cfdtpu_torch/solvers/{solver_name}.py' "
                f"does not define a 'Solver' class."
            )
        self.solverClass: type[SolverBase] = solver_module.Solver

        sig = inspect.signature(self.solverClass.__init__)
        accepted = sig.parameters
        has_var_keyword = any(
            p.kind == inspect.Parameter.VAR_KEYWORD for p in accepted.values()
        )
        filtered_kwargs = (
            solver_kwargs
            if has_var_keyword
            else {k: v for k, v in solver_kwargs.items() if k in accepted}
        )
        try:
            self.solver = self.solverClass(
                self.mesh, dt, rho, mu, f,
                initial_velocity=self.initial_velocity,
                **filtered_kwargs,
            )
        except TypeError as e:
            raise RuntimeError(
                f"Failed to instantiate solver '{solver_name}': {e}. Check "
                f"that the Solver class has the correct constructor "
                f"signature."
            ) from e

        self.T = T
        self.dt = dt
        self._is_setup = False

    @staticmethod
    def _list_available_solvers():
        solvers_dir = os.path.join(
            os.path.dirname(os.path.dirname(__file__)), "solvers"
        )
        files = os.listdir(solvers_dir)
        return [f[:-3] for f in files
                if f.endswith(".py") and not f.startswith("_")
                and f != "base.py"] or ["(none found)"]

    # ------------------------------------------------------------------
    @property
    def facet_tags(self):
        return getattr(self, "_ft", None)

    @property
    def tags(self) -> dict:
        """The boundary markers a solver variant may attach terms to."""
        return {
            "inlet": getattr(self, "inlet_marker", None),
            "outlet": getattr(self, "outlet_marker", None),
            "wall": getattr(self, "wall_marker", None),
            "obstacle": getattr(self, "obstacle_marker", None),
        }

    def setup(self):
        if self._is_setup:
            return
        self.solver.setup(self.bcu, self.bcp, facet_tags=self.facet_tags,
                          tags=self.tags)
        self._is_setup = True
        num_dofs_V = self.solver.V.num_global_dofs
        num_dofs_Q = self.solver.Q.num_global_dofs
        total = num_dofs_V + num_dofs_Q
        print(
            f"DOFs: {total} (Velocity: {num_dofs_V}, Pressure: {num_dofs_Q})"
        )

    # ------------------------------------------------------------------
    def solve(
        self, output_folder: str,
        afterStepCallback: Callable[[float], None] | None = None,
    ) -> str:
        """Run the time loop; returns the output folder path."""
        from ..io import VTUSeriesWriter

        solver = self.solver
        mesh = self.mesh
        T = self.T
        os.makedirs(output_folder, exist_ok=True)

        solver.initStressForm()
        writers = {
            name: VTUSeriesWriter(f"{output_folder}/{name}", mesh, field)
            for name, field in (
                ("v", "velocity"), ("p", "pressure"),
                ("u_residual", "u_residual"),
                ("p_residual", "p_residual"), ("wss", "shear_stress"),
            )
        }

        t = 0.0
        i = 0
        if self.resume_from:
            t, i = self.load_checkpoint(self.resume_from)
            print(f"[checkpoint] resumed from {self.resume_from} at "
                  f"t={t:.4f} (step {i})")
        else:
            solver.u_sol = solver.tensor(
                solver.V.interpolate(self.initial_velocity))
        solver.assemble_wss()

        def write_all(t):
            writers["v"].write(t, to_numpy(solver.u_sol))
            writers["p"].write(t, to_numpy(solver.p_sol))
            writers["u_residual"].write(t, to_numpy(solver.u_residual))
            writers["p_residual"].write(t, to_numpy(solver.p_residual))
            writers["wss"].write(t, to_numpy(solver.shear_stress))

        write_all(t)
        # line-buffered: a run killed by a timeout still leaves its
        # per-step stats behind
        stats_log = open(f"{output_folder}/solver_stats.txt", "w",
                         buffering=1)
        stats_log.write("# step t wall_s newton_iters ksp_iters fnorm\n")

        try:
            while t < T:
                # tracing for this iteration: on under enable() or while a
                # torch.profiler records (utils/trace.py)
                trace.begin_step(i + 1)
                with trace.span("step"):
                    with trace.span("solve"):
                        _t0 = time.perf_counter()
                        solver.solveStep()
                        _wall = time.perf_counter() - _t0
                    i += 1
                    t += self.dt
                    st = getattr(solver, "last_stats", {})
                    if not st.get("skipped"):
                        stats_log.write(
                            f"{i} {t:.6f} {_wall:.4f} "
                            f"{st.get('newton_iters', 0)} "
                            f"{st.get('ksp_iters', 0)} "
                            f"{st.get('fnorm', float('nan'))}\n"
                        )

                    if i % self.output_every == 0:
                        with trace.span("output"):
                            solver.assemble_wss()
                            write_all(t)

                if afterStepCallback:
                    afterStepCallback(t)

                # the checkpoint after the step callback and the
                # pre_checkpoint hook: a per-step series recorder (the
                # DFG 2D-2 forces) has seen step i, and flushed it, before
                # the step-i checkpoint exists
                if self.checkpoint_every and i % self.checkpoint_every == 0:
                    with trace.span("checkpoint"):
                        self.pre_checkpoint()
                        self.save_checkpoint(
                            os.path.join(output_folder, "checkpoint.npz"),
                            t, i)

                if (i + 1) % 10 == 0:
                    with trace.span("early_stop"):
                        # one fused host read of both norms
                        u_sol_norm, u_diff_norm = (
                            float(x) for x in torch.stack([
                                torch.abs(solver.u_sol).max(),
                                torch.abs(solver.u_sol - solver.u_prev).max(),
                            ]).cpu())
                    rel_diff = (u_diff_norm / max(u_sol_norm, 1e-12)
                                ) / self.dt
                    if rel_diff < self.early_stop_tolerance:
                        print(
                            f"Early stopping at t={t:.3f}, because "
                            f"(||u_sol - u_prev||_inf / ||u_sol||_inf) / "
                            f"dt = {rel_diff:.20e} < "
                            f"{self.early_stop_tolerance}"
                        )
                        break

                solver.u_prev = solver.u_sol
                solver.p_prev = solver.p_sol
        finally:
            trace.end_loop()
            for w in writers.values():
                w.close()
            stats_log.close()
        if self.checkpoint_every:
            self.pre_checkpoint()
            self.save_checkpoint(
                os.path.join(output_folder, "checkpoint.npz"), t, i
            )

        norm_v = float(torch.sqrt(solver.l2_norm_sq(solver.u_sol)))
        norm_p = float(torch.sqrt(solver.l2_norm_sq(solver.p_sol)))
        with open(os.path.join(output_folder, "norms.txt"), "w") as f:
            f.write(f"L2 norm of velocity: {norm_v}\n")
            f.write(f"L2 norm of pressure: {norm_p}\n")
        return output_folder

    # ------------------------------------------------------------------
    # Checkpoint / resume: one npz of (u_sol, p_sol, u_prev, p_prev, t,
    # step) and the multistep history the solver holds, the same format
    # as cfdtpu's, so either package resumes from the other's checkpoint
    # (io/state.py)
    # ------------------------------------------------------------------
    def pre_checkpoint(self) -> None:
        """Called just before every save_checkpoint, after the step
        callback. A scenario that keeps a per-step series on the card
        (the DFG 2D-2 force recorder) sets it to its flush, so the series
        on disk never trails the checkpoint it is resumed from."""

    def save_checkpoint(self, path: str, t: float, step: int) -> None:
        from ..io.state import CKPT_HISTORY

        s = self.solver
        extra = {name: to_numpy(getattr(s, name)) for name in CKPT_HISTORY
                 if getattr(s, name, None) is not None}
        np.savez(
            path,
            u_sol=to_numpy(s.u_sol), p_sol=to_numpy(s.p_sol),
            u_prev=to_numpy(s.u_prev), p_prev=to_numpy(s.p_prev),
            t=t, step=step, **extra,
        )

    def load_checkpoint(self, path: str) -> tuple[float, int]:
        from ..io.state import load_reference_checkpoint

        return load_reference_checkpoint(path, self)
