"""Schur-complement fieldsplit preconditioner (SELFP-style).

The counterpart of cfdtpu/la/schur.py on its AMG-family branches. Full
(LDU) application for rhs (r_u, r_p):
    z_u1 = Auu^-1 r_u
    r_s  = r_p - A_pu z_u1
    z_p  = S^-1 r_s            gmres_fixed(S, M = SELFP-AMG V-cycle, m_p)
    z_u  = z_u1 - Auu^-1 (A_up z_p)

inner_method picks the velocity stage Auu^-1 and the Schur operator S:
    amg_p       gmres_fixed(Auu, M = node-block Jacobi, m_u)
    amg_up      gmres_fixed(Auu, M = block-AMG V-cycle, m_u)
    ras_up      gmres_fixed(Auu, M = RAS, m_u)
    rasamg_up   gmres_fixed(Auu, M = block-AMG V-cycle with a RAS fine
                smoother, m_u)
    amg_sup, rasamg_sup
                as amg_up / rasamg_up, and S becomes the near-true Schur
                operator App - Apu V(Aup) with one block-AMG V-cycle V
                in place of diag(Auu)^-1
With a block-AMG V-cycle available and m_u == 0, the velocity stage is
preonly: one V-cycle, no Krylov wrap. Otherwise S is the SELFP action
App - Apu diag(Auu)^-1 Aup, applied with the fused p-column pass
(apply_p_coupled). The AMG hierarchy of the S sweeps always runs on the
explicit SELFP matrix Sp (NodeBSR.sp_vals).

build_schur_state computes the numeric state once (it can be carried
across time steps, pc_lag_steps); make_schur_precond_from_state only
builds closures. Every other inner_method raises NotImplementedError.
"""

from __future__ import annotations

import torch

from .gmres import gmres_fixed

_UU_AMG_METHODS = ("amg_up", "amg_sup", "rasamg_up", "rasamg_sup")
SUPPORTED_INNER = ("amg_p", "amg_up", "ras_up", "rasamg_up", "amg_sup",
                   "rasamg_sup")


def _check_method(inner_method: str) -> None:
    if inner_method not in SUPPORTED_INNER:
        raise NotImplementedError(
            f"pc_inner_method={inner_method!r} is not ported; "
            f"supported: {SUPPORTED_INNER}"
        )


def _safe(d):
    scale = torch.max(torch.abs(d))
    floor = 1e-12 * scale
    return torch.where(
        torch.abs(d) < floor, torch.where(d < 0, -floor, floor), d
    )


def _sub_ops(form, A, bc_mask_u, bc_mask_p, pin_pressure, inv_d_u):
    """The four sub-block actions and the SELFP Schur action S."""

    def Auu(v):
        y = form.apply_sub_block(A, (), v, "uu")
        return torch.where(bc_mask_u, v, y)

    def Aup(v_p):
        y = form.apply_sub_block(A, (), v_p, "up")
        return torch.where(bc_mask_u, 0.0, y)

    def Apu(v_u):
        return form.apply_sub_block(A, (), v_u, "pu")

    def App(v_p):
        return form.apply_sub_block(A, (), v_p, "pp")

    def S(v_p):
        """SELFP Schur action, fused: (Aup v, App v) in one pass."""
        w, y_pp = form.apply_p_coupled(A, v_p)
        w = torch.where(bc_mask_u, 0.0, w)
        y = y_pp - Apu(inv_d_u * w)
        if bc_mask_p is not None:
            y = torch.where(bc_mask_p, v_p, y)
        if pin_pressure:
            y = y - torch.mean(y)
        return y

    return Auu, Aup, Apu, App, S


def _uu_amg(form, inner_method, ras_opts):
    """The cached block-AMG hierarchy of the velocity block, with the
    RAS fine smoother for the rasamg_* methods."""
    ras = (form.uu_ras(*ras_opts) if inner_method.startswith("rasamg")
           else None)
    return form.uu_amg(fine_smoother=ras)


def build_schur_state(form, A, bc_mask_u, pin_pressure: bool,
                      m_u: int = 8, m_p: int = 10, full: bool = True,
                      bc_mask_p=None, inner_method: str = "amg_p",
                      ras_opts: tuple[int, int] = (16, 4)):
    """Numeric preconditioner state: the operator values, the velocity
    diagonal, the velocity-block AMG / RAS values of the *_up / *_sup
    methods and the SELFP-AMG level values."""
    _check_method(inner_method)
    n_u_flat = form.n_u_flat
    d_full = form.jacobian_diagonal(A, ())
    d_u = _safe(torch.where(bc_mask_u, 1.0, d_full[:n_u_flat]))
    inv_d_u = 1.0 / d_u
    state = {"A": A, "d_u": d_u}
    if inner_method in _UU_AMG_METHODS:
        state["uu_built"] = _uu_amg(form, inner_method, ras_opts).build(
            form.uu_vals(A, bc_mask_u))
    if inner_method == "ras_up":
        state["ras_inv"] = form.uu_ras(*ras_opts).build(
            form.uu_vals(A, bc_mask_u))
    # aggregation-MG V-cycle on the EXPLICIT SELFP matrix as the inner
    # PC of the S sweeps (AMG on App alone fails: in stabilized P1-P1
    # the pressure Laplacian lives in the product term). It keeps
    # diag(Auu) under *_sup too.
    amg = form.sp_amg()
    sp = form.sp_vals(A, torch.where(bc_mask_u, 0.0, inv_d_u))
    if bc_mask_p is not None:
        # identity rows at pressure-Dirichlet dofs, matching the
        # matrix-free S
        sp = torch.where(bc_mask_p[form._sp_row], 0.0, sp)
        diag = form._sp_diag_pos
        sp[diag] = torch.where(bc_mask_p, 1.0, sp[diag])
    state["sp_built"] = amg.build(sp)
    return state


def make_schur_precond_from_state(form, state, bc_mask_u,
                                  pin_pressure: bool, m_u: int = 8,
                                  m_p: int = 10, full: bool = True,
                                  bc_mask_p=None,
                                  inner_method: str = "amg_p",
                                  ras_opts: tuple[int, int] = (16, 4)):
    """v -> M v approximating J^-1 v from a prebuilt numeric state.
    Closure construction only: the state can be reused across steps."""
    _check_method(inner_method)
    n_u_flat = form.n_u_flat
    A = state["A"]
    inv_d_u = 1.0 / state["d_u"]
    Auu, Aup, Apu, App, S = _sub_ops(form, A, bc_mask_u, bc_mask_p,
                                     pin_pressure, inv_d_u)

    uu_vcycle = None
    if "uu_built" in state:
        uu_amg = _uu_amg(form, inner_method, ras_opts)
        uu_built = state["uu_built"]

        def uu_vcycle(r):
            return uu_amg.v_cycle(uu_built, r)

    if "ras_inv" in state:
        ras = form.uu_ras(*ras_opts)
        ras_inv = state["ras_inv"]

        def Mu(r):
            return ras.apply(ras_inv, r)
    elif uu_vcycle is not None:
        Mu = uu_vcycle
    else:
        # exact (dim x dim) node-block Jacobi: stronger than the scalar
        # diagonal once convection couples the velocity components
        Mu = form.uu_block_jacobi(A, bc_mask_u)

    if m_u == 0 and uu_vcycle is not None:
        # preonly u-stage (PETSc's fieldsplit_u preonly): one V-cycle,
        # no Krylov wrap; the outer FGMRES corrects the error
        solve_Auu = uu_vcycle
    else:
        def solve_Auu(r):
            # single-orthogonalisation sweeps: the PC only needs an
            # approximate inverse
            return gmres_fixed(Auu, r, precond=Mu, m=m_u, reorth=False)

    if inner_method in ("amg_sup", "rasamg_sup"):
        def S(v_p):  # noqa: F811
            """Near-true Schur action App v - Apu V(Aup v). The V-cycle
            is plain (kcycle=False): it is part of a LINEAR operator
            swept by fixed GMRES."""
            w = Aup(v_p)
            z = uu_amg.v_cycle(uu_built, w, kcycle=False)
            z = torch.where(bc_mask_u, 0.0, z)
            y = App(v_p) - Apu(z)
            if bc_mask_p is not None:
                y = torch.where(bc_mask_p, v_p, y)
            if pin_pressure:
                y = y - torch.mean(y)
            return y

    amg = form.sp_amg()
    level_vals = state["sp_built"]

    def Mp_vcycle(v):
        return amg.v_cycle(level_vals, v)

    def solve_S(r):
        if pin_pressure:
            r = r - torch.mean(r)
        if m_p == 0:  # preonly S-stage: one SELFP-AMG V-cycle
            z = Mp_vcycle(r)
        else:
            z = gmres_fixed(S, r, precond=Mp_vcycle, m=m_p, reorth=False)
        if pin_pressure:
            z = z - torch.mean(z)
        return z

    def precond(v):
        r_u, r_p = v[:n_u_flat], v[n_u_flat:]
        z_u = solve_Auu(r_u)
        r_s = r_p - Apu(z_u)
        z_p = solve_S(r_s)
        if full:
            z_u = z_u - solve_Auu(Aup(z_p))
        return torch.cat([z_u, z_p])

    return precond
