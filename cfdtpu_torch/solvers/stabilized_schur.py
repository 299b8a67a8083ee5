"""SUPG/PSPG/LSIC-stabilized Newton-Krylov solver (Crank-Nicolson midpoint).

The counterpart of cfdtpu/solvers/stabilized_schur.py for the
configuration this port covers: the assembled node-BSR operator
(supernode layout), the Schur fieldsplit preconditioner with the
AMG-family inner methods of la/schur.py (amg_p, amg_up, ras_up,
rasamg_up, amg_sup, rasamg_sup), flexible GMRES inside Newton with line search, and the
pc_lag_steps build/reuse split that carries the operator and
preconditioner state across time steps. Unsupported option values raise
NotImplementedError rather than being replaced silently.

cfdtpu jit-compiles each step (with const-args wrappers for its remote
TPU compiler); here the step runs eagerly and the hot operations are
the CUDA kernels of cfdtpu_torch/kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..forms import StabilizedNSForm
from ..la import NewtonParams, newton_solve
from ..la.nodebsr import NodeBSR
from ..la.schur import (_check_method, build_schur_state,
                        make_schur_precond_from_state)
from ..mesh import Mesh
from ..spaces.dirichlet import combine_bcs, gather_values
from ..utils.dtypes import default_tolerances
from .base import SolverBase


def _unsupported(name, value):
    raise NotImplementedError(f"{name}={value!r} is not ported")


class Solver(SolverBase):
    BOUNDARY_CORRECTION = True

    def __init__(
        self,
        mesh: Mesh,
        dt: float,
        rho: float,
        mu: float,
        f,
        initial_velocity: Callable | None = None,
        p_grade: int = 1,
        snes_rtol: float | None = None,
        snes_atol: float | None = None,
        snes_stol: float | None = None,
        snes_max_it: int = 100,
        ksp_rtol: float | None = None,
        ksp_restart: int = 60,
        ksp_ortho_chunk: int = 0,
        ksp_max_it: int = 1000,
        quad_degree: int | None = None,
        n_shards: int | None = None,
        pc_type: str = "schur",
        pc_inner_u: int = 6,
        pc_inner_p: int | None = None,
        pc_schur_fact: str = "full",
        pc_inner_method: str = "amg_p",
        operator_format: str = "node_bsr",
        snes_ksp_ew: bool = False,
        snes_lag_preconditioner: bool = True,
        snes_lag_jacobian: bool = False,
        predictor: str = "previous",
        pc_dtype: str = "same",
        pc_amg_pairwise: bool = False,
        pc_amg_smooth: int = 1,
        pc_amg_kcycle: bool = False,
        pc_amg_wcycle: bool = False,
        pc_amg_cheby: int = 0,
        pc_ras_size: int = 16,
        pc_ras_overlap: int = 4,
        pc_lag_steps: int = 1,
        stats_every: int = 1,
        supernode_g: int = 4,
        device="cpu",
        dtype=None,
        **kwargs,
    ):
        if n_shards:
            _unsupported("n_shards", n_shards)
        if pc_type != "schur":
            _unsupported("pc_type", pc_type)
        if operator_format != "node_bsr":
            _unsupported("operator_format", operator_format)
        _check_method(pc_inner_method)
        if ksp_ortho_chunk:
            _unsupported("ksp_ortho_chunk", ksp_ortho_chunk)
        if pc_dtype != "same":
            _unsupported("pc_dtype", pc_dtype)
        for name, val in (("pc_amg_kcycle", pc_amg_kcycle),
                          ("pc_amg_wcycle", pc_amg_wcycle),
                          ("pc_amg_cheby", pc_amg_cheby)):
            if val:
                _unsupported(name, val)
        if predictor not in ("previous", "extrapolate"):
            raise ValueError(f"unknown predictor {predictor!r}")
        if pc_schur_fact not in ("full", "lower"):
            raise ValueError(f"unknown pc_schur_fact {pc_schur_fact!r}")
        # pc_lag_steps > 1: rebuild the operator + PC numeric state every
        # K time steps and REUSE it in between (the cross-step analogue
        # of PETSc -snes_lag_preconditioner_persists); the residual stays
        # exact, only the Jacobian action / PC go K-1 steps stale
        self.pc_lag_steps = int(pc_lag_steps)
        self._op_state = None
        # stats_every > 1: check convergence only every N-th step; the
        # skipped steps' flags are ANDed and checked at the window end
        self.stats_every = max(1, int(stats_every))
        self.supernode_g = int(supernode_g)
        self.pc_amg_pairwise = bool(pc_amg_pairwise)
        self.pc_amg_smooth = int(pc_amg_smooth)
        self.pc_ras_size = int(pc_ras_size)
        self.pc_ras_overlap = int(pc_ras_overlap)
        self.predictor = predictor
        self.pc_type = pc_type
        self.pc_inner_u = int(pc_inner_u)
        self.pc_inner_p = None if pc_inner_p is None else int(pc_inner_p)
        self.pc_schur_fact = pc_schur_fact
        self.pc_inner_method = pc_inner_method
        self.operator_format = operator_format
        super().__init__(mesh, dt, rho, mu, f, initial_velocity,
                         device=device, dtype=dtype)
        tols = default_tolerances(self.np_dtype)
        snes_rtol = tols["snes_rtol"] if snes_rtol is None else snes_rtol
        snes_atol = tols["snes_atol"] if snes_atol is None else snes_atol
        snes_stol = tols["snes_stol"] if snes_stol is None else snes_stol
        ksp_rtol = tols["ksp_rtol"] if ksp_rtol is None else ksp_rtol

        self.initVelocitySpace(int(p_grade))
        self.initPressureSpace(int(p_grade))

        if initial_velocity is not None:
            self.u_prev = self.tensor(self.V.interpolate(initial_velocity))

        self.quad_degree = quad_degree
        self.form = self._make_form(quad_degree)
        self.newton_params = NewtonParams(
            max_it=int(snes_max_it),
            rtol=float(snes_rtol),
            atol=float(snes_atol),
            stol=float(snes_stol),
            ksp_rtol=float(ksp_rtol),
            ksp_restart=int(ksp_restart),
            ksp_maxiter=int(ksp_max_it),
            ew=bool(snes_ksp_ew),
            pc_lag=bool(snes_lag_preconditioner),
            jac_lag=bool(snes_lag_jacobian),
        )
        self.last_stats: dict = {}
        self.step_count = 0

    # -- variant hooks --------------------------------------------------
    def _make_form(self, quad_degree):
        return StabilizedNSForm(
            self.V, self.Q, quad_degree=quad_degree,
            boundary_correction=self.BOUNDARY_CORRECTION,
            device=self.device, dtype=self.np_dtype,
        )

    def _aux(self) -> tuple:
        return (self.u_prev,)

    def params(self) -> dict:
        return self.base_params()

    # ------------------------------------------------------------------
    def setup(self, bcu, bcp) -> None:
        self.bcu_d = [bc.getBC(self.V) for bc in bcu]
        self.bcp_d = [bc.getBC(self.Q) for bc in bcp]
        self.bc_dofs_u, self._keep_u = combine_bcs(self.bcu_d,
                                                   self.mesh.gdim)
        self.bc_dofs_p, self._keep_p = combine_bcs(self.bcp_d, 1)
        # the constant-pressure nullspace is tested NUMERICALLY on the
        # initial-state Jacobian, like the reference's nullsp.test(A)
        self.pin_pressure = (
            len(self.bc_dofs_p) == 0 and self._test_pressure_nullspace()
        )
        self._build_step()

    def _test_pressure_nullspace(self) -> bool:
        """True if J e_p ~ 0 for the constant-pressure vector e_p, with
        Dirichlet-velocity rows masked (identity rows in the solve)."""
        form = self.form
        n_u, n_p = self.V.num_dofs, self.Q.num_dofs
        dim = self.mesh.gdim
        A_cells, A_blocks = form.element_jacobians(
            self.u_prev, self.p_prev, self._aux(), self.params()
        )
        e = torch.cat([
            torch.zeros((n_u * dim,), dtype=self.dtype, device=self.device),
            torch.ones((n_p,), dtype=self.dtype, device=self.device),
        ])
        y = form.apply_element_matrices(A_cells, A_blocks, e)
        mask = np.zeros(n_u * dim + n_p, dtype=bool)
        for d0 in range(dim):
            mask[self.bc_dofs_u.astype(np.int64) * dim + d0] = True
        y = torch.where(torch.as_tensor(mask, device=self.device), 0.0, y)
        # scale: the operator's response to a unit random vector (numpy,
        # fixed seed, as in cfdtpu)
        rng = np.random.default_rng(0)
        v = self.tensor(rng.standard_normal(n_u * dim + n_p))
        v = v / torch.linalg.vector_norm(v)
        yv = form.apply_element_matrices(A_cells, A_blocks, v)
        scale = torch.linalg.vector_norm(yv)
        rel = float(
            torch.linalg.vector_norm(y) / np.sqrt(n_p)
            / torch.clamp(scale, min=1e-30)
        )
        tol = 1e-6 if self.np_dtype == np.float64 else 1e-3
        return rel < tol

    # ------------------------------------------------------------------
    def _build_step(self) -> None:
        form = self.form
        n_u = self.V.num_dofs
        n_p = self.Q.num_dofs
        dim = self.mesh.gdim
        dev = self.device
        bc_dofs_u = torch.as_tensor(self.bc_dofs_u.astype(np.int64),
                                    device=dev)
        bc_dofs_p = torch.as_tensor(self.bc_dofs_p.astype(np.int64),
                                    device=dev)
        has_bc_u = len(self.bc_dofs_u) > 0
        has_bc_p = len(self.bc_dofs_p) > 0
        pin_pressure = self.pin_pressure
        newton_params = self.newton_params

        def ravel(u, p):
            return torch.cat([u.reshape(-1), p])

        def unravel(x):
            return x[: n_u * dim].reshape(n_u, dim), x[n_u * dim:]

        self._ravel, self._unravel = ravel, unravel

        # flat-layout BC mask: True at constrained rows
        bc_mask_np = np.zeros(n_u * dim + n_p, dtype=bool)
        for d0 in range(dim):
            bc_mask_np[self.bc_dofs_u.astype(np.int64) * dim + d0] = True
        bc_mask_np[n_u * dim + self.bc_dofs_p.astype(np.int64)] = True
        bc_mask = torch.as_tensor(bc_mask_np, device=dev)
        bc_mask_u = bc_mask[: n_u * dim]
        bc_mask_p = bc_mask[n_u * dim:] if has_bc_p else None

        # assembled node-BSR operator, static SELFP sparsity and the AMG
        # hierarchies (and the RAS window maps): numpy, built once
        nodebsr = NodeBSR(form, supernode_g=self.supernode_g)
        nodebsr.sp_structure()
        nodebsr.sp_amg(pairwise=self.pc_amg_pairwise,
                       n_smooth=self.pc_amg_smooth)
        ras_opts = (self.pc_ras_size, self.pc_ras_overlap)
        method = self.pc_inner_method
        if method in ("amg_up", "amg_sup"):
            nodebsr.uu_amg()
        elif method == "ras_up":
            nodebsr.uu_ras(*ras_opts)
        elif method in ("rasamg_up", "rasamg_sup"):
            nodebsr.uu_amg(fine_smoother=nodebsr.uu_ras(*ras_opts))
        self._nodebsr = nodebsr
        pc_inner_p = 10 if self.pc_inner_p is None else self.pc_inner_p
        pc_pin = pin_pressure and not has_bc_p
        pc_kw = dict(
            m_u=self.pc_inner_u, m_p=pc_inner_p,
            full=self.pc_schur_fact == "full", bc_mask_p=bc_mask_p,
            inner_method=method, ras_opts=ras_opts,
        )

        def project(dx):
            du, dp = unravel(dx)
            return ravel(du, dp - torch.mean(dp))

        def make_F(aux, bc_u_vals, bc_p_vals, prm):
            def F(x):
                u, p = unravel(x)
                ru, rp = form.residual(u, p, aux, prm)
                if has_bc_u:
                    ru[bc_dofs_u] = u[bc_dofs_u] - bc_u_vals
                if has_bc_p:
                    rp[bc_dofs_p] = p[bc_dofs_p] - bc_p_vals
                if pin_pressure:
                    rp = rp - torch.mean(rp)
                return ravel(ru, rp)

            return F

        def make_matvec(vals):
            def matvec(v):
                y = nodebsr.apply_element_matrices(vals, (), v)
                y = torch.where(bc_mask, v, y)
                if pin_pressure:
                    y = project(y)
                return y

            return matvec

        def build_op_state(u, p, aux, prm):
            """Element Jacobians -> node-BSR values -> PC numeric state."""
            A_cells, A_blocks = form.element_jacobians(u, p, aux, prm)
            vals = nodebsr.assemble(A_cells, A_blocks)
            pc_state = build_schur_state(nodebsr, vals, bc_mask_u, pc_pin,
                                         **pc_kw)
            return {"vals": vals, "pc": pc_state}

        def solve(F, x0, params, make_operator):
            if pin_pressure:
                x0 = project(x0)
            x, stats = newton_solve(
                F, x0, params, make_operator=make_operator,
                project=project if pin_pressure else None,
            )
            u, p = unravel(x)
            r_u, r_p = unravel(stats.pop("final_residual"))
            return u, p, r_u, r_p, stats

        def step(u_guess, p_guess, aux, bc_u_vals, bc_p_vals, prm):
            """Operator rebuilt per Newton iteration (the PC per
            make_operator call, or once per step under pc_lag)."""

            def make_operator(x):
                u, p = unravel(x)
                A_cells, A_blocks = form.element_jacobians(u, p, aux, prm)
                vals = nodebsr.assemble(A_cells, A_blocks)
                built = {}

                def precond(v):
                    # built on first use: under pc_lag Newton drops the
                    # per-iteration preconditioner unused, and then it
                    # is never built (what dead-code elimination does
                    # for the jitted cfdtpu step)
                    if "M" not in built:
                        st = build_schur_state(nodebsr, vals, bc_mask_u,
                                               pc_pin, **pc_kw)
                        built["M"] = make_schur_precond_from_state(
                            nodebsr, st, bc_mask_u, pc_pin, **pc_kw)
                    return built["M"](v)

                return make_matvec(vals), precond

            return solve(make_F(aux, bc_u_vals, bc_p_vals, prm),
                         ravel(u_guess, p_guess), newton_params,
                         make_operator)

        reuse_params = dataclasses.replace(newton_params, jac_lag=True)

        def step_reuse(u_guess, p_guess, aux, bc_u_vals, bc_p_vals, prm,
                       op_state):
            """Newton over a fresh residual with the carried operator
            and preconditioner state (chord Newton)."""
            matvec = make_matvec(op_state["vals"])
            precond = make_schur_precond_from_state(
                nodebsr, op_state["pc"], bc_mask_u, pc_pin, **pc_kw)
            return solve(make_F(aux, bc_u_vals, bc_p_vals, prm),
                         ravel(u_guess, p_guess), reuse_params,
                         lambda x: (matvec, precond))

        self._step = step
        if self.pc_lag_steps > 1:
            self._build_op_state = build_op_state
            self._reuse_step = step_reuse
        else:
            self._reuse_step = None

    # ------------------------------------------------------------------
    def _bc_values(self):
        for bc in self.bcu_d:
            bc.update()
        for bc in self.bcp_d:
            bc.update()
        if self.bcu_d:
            bc_u_vals = self.tensor(gather_values(self.bcu_d, self._keep_u))
        else:
            bc_u_vals = self.tensor(np.zeros((0, self.mesh.gdim)))
        if self.bcp_d:
            bc_p_vals = self.tensor(gather_values(self.bcp_d, self._keep_p))
        else:
            bc_p_vals = self.tensor(np.zeros((0,)))
        return bc_u_vals, bc_p_vals

    def _run_step(self, bc_u_vals, bc_p_vals):
        # Newton warm start: previous solution, or the second-order
        # extrapolation 2 u_prev - u_older under predictor="extrapolate"
        u_old = getattr(self, "_u_extrap_old", None)
        if self.predictor == "extrapolate" and u_old is not None and (
            u_old.shape == self.u_prev.shape
        ):
            u_guess = 2.0 * self.u_prev - u_old
            p_guess = 2.0 * self.p_prev - self._p_extrap_old
        else:
            u_guess, p_guess = self.u_prev, self.p_prev
        self._u_extrap_old = self.u_prev
        self._p_extrap_old = self.p_prev
        prm = self.params()
        if self._reuse_step is not None:
            # rebuild the carried operator/PC state every pc_lag_steps
            # steps, whenever dt changed, or on a rebuild hint
            dt_now = prm.get("dt")
            self._op_state_fresh = False
            if (
                self._op_state is None
                or self.step_count % self.pc_lag_steps == 0
                or getattr(self, "_op_state_dt", None) != dt_now
                or getattr(self, "_rebuild_hint", False)
            ):
                self._rebuild_hint = False
                self._op_state = self._build_op_state(
                    u_guess, p_guess, self._aux(), prm
                )
                self._op_state_dt = dt_now
                self._op_state_fresh = True
            return self._reuse_step(
                u_guess, p_guess, self._aux(), bc_u_vals, bc_p_vals,
                prm, self._op_state,
            )
        return self._step(
            u_guess, p_guess, self._aux(), bc_u_vals, bc_p_vals, prm,
        )

    def _note_newton_iters(self, iters: int) -> None:
        # Convergence-aware PC lag: request an early operator/PC rebuild
        # when the Newton count spikes above 2x the rolling median (min
        # +2), a sign the carried state has drifted too far
        if self._reuse_step is None:
            return
        hist = getattr(self, "_newton_hist", None)
        if hist is None:
            hist = self._newton_hist = []
        if len(hist) >= 3:
            med = sorted(hist)[len(hist) // 2]
            if iters > max(2 * med, med + 2):
                self._rebuild_hint = True
                # don't let the spike poison the median window
                hist.clear()
                return
        hist.append(iters)
        if len(hist) > 8:
            hist.pop(0)

    def solveStep(self) -> None:
        bc_u_vals, bc_p_vals = self._bc_values()
        u, p, r_u, r_p, stats = self._run_step(bc_u_vals, bc_p_vals)
        if (self.step_count + 1) % self.stats_every == 0:
            win_conv = getattr(self, "_win_converged", None)
            self._win_converged = None
            converged = stats["converged"]
            if not converged and not getattr(self, "_op_state_fresh", True):
                # self-healing reuse: the K-stale operator/PC was too
                # stale for this step. Rebuild at the current guess and
                # retry once; only a fresh-state failure is divergence.
                self._op_state = None
                u, p, r_u, r_p, stats = self._run_step(bc_u_vals,
                                                       bc_p_vals)
                converged = stats["converged"]
            self.last_stats = dict(stats)
            # AND of the skipped steps' converged flags: an unconverged
            # step inside the window committed a bad state that the
            # checked step may have re-converged from
            if win_conv is not None and not win_conv:
                raise RuntimeError(
                    "An unfetched step inside the last stats_every="
                    f"{self.stats_every} window did not converge "
                    "(detected at the window check; rerun with "
                    "stats_every=1 to locate the step)."
                )
            if not converged:
                raise RuntimeError(
                    f"Did not converge, reason: newton_iters="
                    f"{self.last_stats['newton_iters']}, "
                    f"fnorm={self.last_stats['fnorm']:.3e} "
                    f"(f0norm={self.last_stats['f0norm']:.3e})."
                )
            print(
                f"Solver converged in"
                f" {self.last_stats['newton_iters']} nonlinear"
                f" iterations (with total number of"
                f" {self.last_stats['ksp_iters']} linear iterations)"
            )
            self._note_newton_iters(int(self.last_stats["newton_iters"]))
        else:
            # Newton already read its flag on the host (it reads ||F||
            # every iteration), so the window AND needs no device read
            acc = getattr(self, "_win_converged", None)
            flag = stats["converged"]
            self._win_converged = flag if acc is None else (acc and flag)
            self.last_stats = {"skipped": True}
        # counts of every step, checked or not (host numbers already)
        self.step_stats = dict(stats)
        self.u_sol, self.p_sol = u, p
        self.u_residual, self.p_residual = r_u, r_p
        self.step_count += 1
