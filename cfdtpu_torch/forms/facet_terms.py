"""Boundary (facet) term kernels.

The counterpart of cfdtpu/forms/facet_terms.py for the terms that have
a CUDA kernel:

- natural_correction: `p n·v - mu (nabla_grad u)^T n·v` on all exterior
  facets (kernel K7, kernels/ns_facet.py);
- viscous_traction: `sign (2 mu eps(u) n)·v`, the outlet stress
  correction (kernel K12, kernels/ns_facet.py);
- backflow: `- beta rho (u_prev·n)_- (u·v)` (kernel K13,
  kernels/ns_facet.py);
- weak_pressure: `scale pbar (v·n)`, a weak (natural) pressure on an
  inlet or outlet (kernel K16);
- nitsche_tangential and nitsche_tangential_curl: symmetric Nitsche
  enforcement of u_T = 0, `-(2 mu eps(u) n)·v_T - (2 mu eps(v) n)·u_T +
  (beta mu / h) u_T·v_T` and its curl form (kernel K17);
- cbc, `- 1/2 (u_prev·n)(u·v)`, and directional_do_nothing, `- 1/2
  min(u_prev·n, 0)(u·v)`: the convective and directional do-nothing
  outlets (kernel K18).

A factory returns a per-facet kernel
    kernel(u_e, p_e, aux_e, coords_e, tabs, prm) -> r_u (nbu, dim)
in plain torch, which torch.func.vmap maps over facets (and jacfwd
differentiates for the element Jacobians): the plain version of its
CUDA kernel. A kernel names that kernel and its options in its `fused`
attribute, a kernels.ns_facet.FacetTerm; StabilizedNSForm takes only
kernels that have one. The `vel` selector picks the time-scheme
velocity the term acts on: the Crank-Nicolson midpoint by default,
`implicit_velocity` for BDF2.

Not ported yet: natural_correction_full_stress (ROADMAP A11).
"""

from __future__ import annotations

import torch

from ..kernels.ns_facet import FacetTerm
from ..utils import det_and_inv


def midpoint_velocity(u_e, aux_e):
    return 0.5 * (u_e + aux_e[0])


def implicit_velocity(u_e, aux_e):
    return u_e


def _implicit(vel) -> bool:
    if vel is midpoint_velocity:
        return False
    if vel is implicit_velocity:
        return True
    raise NotImplementedError(
        f"vel={vel!r}: the facet kernels take midpoint_velocity or "
        "implicit_velocity")


def _phys_grad_u(tabs, coords_e):
    """Physical gradients of the velocity basis at the facet quadrature
    points: (nq, nbu, gdim)."""
    J = torch.einsum("vg,qvd->qgd", coords_e, tabs["gdphi"])
    _, invJ = det_and_inv(J)
    return torch.einsum("qbd,qdg->qbg", tabs["dphi_u"], invJ)


def natural_correction(vel=midpoint_velocity):
    """`p n·v - mu (nabla_grad u)^T n·v` (UFL transpose convention)."""

    def kernel(u_e, p_e, aux_e, coords_e, tabs, prm):
        mu = prm["mu"]
        n, dS = tabs["normal"], tabs["dS"]
        gu = _phys_grad_u(tabs, coords_e)
        um = vel(u_e, aux_e)
        grad_um = torch.einsum("bi,qbg->qig", um, gu)
        p_q = tabs["phi_p"] @ p_e
        gtn = torch.einsum("qjg,qj->qg", grad_um, n)
        term = p_q[:, None] * n - mu * gtn
        return torch.einsum("q,qb,qi->bi", dS, tabs["phi_u"], term)

    kernel.fused = FacetTerm("natural", _implicit(vel))
    return kernel


def viscous_traction(vel=midpoint_velocity, sign: float = -1.0):
    """`sign * (2 mu eps(u) n)·v` (outlet stress correction)."""

    def kernel(u_e, p_e, aux_e, coords_e, tabs, prm):
        mu = prm["mu"]
        n, dS = tabs["normal"], tabs["dS"]
        gu = _phys_grad_u(tabs, coords_e)
        um = vel(u_e, aux_e)
        grad_um = torch.einsum("bi,qbg->qig", um, gu)
        eps_u = 0.5 * (grad_um + grad_um.transpose(1, 2))
        tn = 2.0 * mu * torch.einsum("qig,qg->qi", eps_u, n)
        return sign * torch.einsum("q,qb,qi->bi", dS, tabs["phi_u"], tn)

    kernel.fused = FacetTerm("viscous", _implicit(vel), sign=float(sign))
    return kernel


def backflow(beta_key: str = "beta_backflow", vel=midpoint_velocity):
    """`- beta rho (u_prev·n)_- (u·v)`; (u·n)_- = (u·n - |u·n|)/2, the
    coefficient taken at u_prev, so the term is linear in u."""

    def kernel(u_e, p_e, aux_e, coords_e, tabs, prm):
        rho = prm["rho"]
        beta = prm[beta_key]
        n, dS = tabs["normal"], tabs["dS"]
        phi_u = tabs["phi_u"]
        up_q = torch.einsum("qb,bi->qi", phi_u, aux_e[0])
        un_prev = torch.einsum("qi,qi->q", up_q, n)
        un_minus = 0.5 * (un_prev - torch.abs(un_prev))
        um = vel(u_e, aux_e)
        u_q = torch.einsum("qb,bi->qi", phi_u, um)
        return -beta * rho * torch.einsum(
            "q,qb,qi->bi", dS * un_minus, phi_u, u_q)

    kernel.fused = FacetTerm("backflow", _implicit(vel), beta_key=beta_key)
    return kernel


def weak_pressure(pressure_key: str, scale: float = 1.0):
    """`+ scale * prm[pressure_key] * (v·n)`: a weak pressure traction.
    It reads no state: its Jacobian is zero."""

    def kernel(u_e, p_e, aux_e, coords_e, tabs, prm):
        pbar = prm[pressure_key]
        n, dS = tabs["normal"], tabs["dS"]
        return torch.einsum("q,qb,qi->bi", dS * scale * pbar, tabs["phi_u"],
                            n)

    kernel.fused = FacetTerm("weakp", pressure_key=pressure_key,
                             scale=float(scale))
    return kernel


def nitsche_tangential(beta_key: str = "beta_nitsche",
                       vel=midpoint_velocity):
    """Symmetric Nitsche enforcement of zero tangential velocity:
    `-(2 mu eps(u) n)·v_T - (2 mu eps(v) n)·u_T + (beta mu / h) u_T·v_T`."""

    def kernel(u_e, p_e, aux_e, coords_e, tabs, prm):
        mu = prm["mu"]
        beta = prm[beta_key]
        n, dS, h = tabs["normal"], tabs["dS"], tabs["h"]
        phi_u = tabs["phi_u"]
        gu = _phys_grad_u(tabs, coords_e)
        um = vel(u_e, aux_e)
        grad_um = torch.einsum("bi,qbg->qig", um, gu)
        eps_u = 0.5 * (grad_um + grad_um.transpose(1, 2))
        u_q = torch.einsum("qb,bi->qi", phi_u, um)
        uT = u_q - torch.einsum("qi,qi->q", u_q, n)[:, None] * n

        # consistency: -(2 mu eps(u) n)·v_T
        sn = 2.0 * mu * torch.einsum("qig,qg->qi", eps_u, n)
        sn_T = sn - torch.einsum("qi,qi->q", sn, n)[:, None] * n
        ru = -torch.einsum("q,qb,qi->bi", dS, phi_u, sn_T)

        # symmetry: -(2 mu eps(v) n)·u_T for v = phi_b e_i:
        # mu (grad phi_b·n) u_T,i + mu (grad phi_b·u_T) n_i
        gphin = torch.einsum("qbg,qg->qb", gu, n)
        gphiuT = torch.einsum("qbg,qg->qb", gu, uT)
        ru = ru - mu * torch.einsum("q,qb,qi->bi", dS, gphin, uT)
        ru = ru - mu * torch.einsum("q,qb,qi->bi", dS, gphiuT, n)

        # penalty: (beta mu / h) u_T·v_T = phi_b u_T,i (u_T·n = 0)
        return ru + beta * mu * torch.einsum("q,qb,qi->bi", dS / h, phi_u,
                                             uT)

    kernel.fused = FacetTerm("nitsche", _implicit(vel), beta_key=beta_key)
    return kernel


def nitsche_tangential_curl(beta_key: str = "beta_nitsche",
                            vel=midpoint_velocity):
    """Curl-form symmetric Nitsche enforcement of u_T = 0:
    `- mu (curl u x n)·v_T - mu (curl v x n)·u_T + (beta mu/h) u_T·v_T`.
    2D: curl x n = (-omega n_y, omega n_x) with omega = du_y/dx - du_x/dy
    (the 3D form waits for the 3D cell bodies)."""

    def kernel(u_e, p_e, aux_e, coords_e, tabs, prm):
        mu = prm["mu"]
        beta = prm[beta_key]
        n, dS, h = tabs["normal"], tabs["dS"], tabs["h"]
        if n.shape[-1] != 2:
            raise NotImplementedError("nitsche_tangential_curl is 2D")
        phi_u = tabs["phi_u"]
        gu = _phys_grad_u(tabs, coords_e)  # (q, b, g)
        um = vel(u_e, aux_e)
        grad_um = torch.einsum("bi,qbg->qig", um, gu)
        u_q = torch.einsum("qb,bi->qi", phi_u, um)
        uT = u_q - torch.einsum("qi,qi->q", u_q, n)[:, None] * n

        omega = grad_um[:, 1, 0] - grad_um[:, 0, 1]
        ccn_u = torch.stack([-omega * n[:, 1], omega * n[:, 0]], dim=-1)
        # curl(phi_b e_i) x n: i = 0 rot -dphi/dy, i = 1 rot dphi/dx
        rot_v = torch.stack([-gu[:, :, 1], gu[:, :, 0]], dim=-1)  # (q, b, i)
        ccn_v = torch.stack(
            [-torch.einsum("qbi,q->qbi", rot_v, n[:, 1]),
             torch.einsum("qbi,q->qbi", rot_v, n[:, 0])], dim=-1)

        # consistency: -mu (curl u x n)·v_T
        ccn_uT = ccn_u - torch.einsum("qk,qk->q", ccn_u, n)[:, None] * n
        ru = -mu * torch.einsum("q,qb,qi->bi", dS, phi_u, ccn_uT)
        # symmetry: -mu (curl v x n)·u_T
        ru = ru - mu * torch.einsum("q,qbik,qk->bi", dS, ccn_v, uT)
        # penalty
        return ru + beta * mu * torch.einsum("q,qb,qi->bi", dS / h, phi_u,
                                             uT)

    kernel.fused = FacetTerm("nitsche_curl", _implicit(vel),
                             beta_key=beta_key)
    return kernel


def _un_prev(aux_e, tabs):
    """u_prev·n at the facet's points."""
    up_q = torch.einsum("qb,bi->qi", tabs["phi_u"], aux_e[0])
    return torch.einsum("qi,qi->q", up_q, tabs["normal"])


def cbc(vel=midpoint_velocity):
    """Convective boundary condition: sigma·n replaced by
    `1/2 (u_prev·n) u`, the residual term `- 1/2 (u_prev·n)(u·v)`."""

    def kernel(u_e, p_e, aux_e, coords_e, tabs, prm):
        phi_u = tabs["phi_u"]
        u_q = torch.einsum("qb,bi->qi", phi_u, vel(u_e, aux_e))
        return -0.5 * torch.einsum("q,qb,qi->bi",
                                   tabs["dS"] * _un_prev(aux_e, tabs),
                                   phi_u, u_q)

    kernel.fused = FacetTerm("cbc", _implicit(vel))
    return kernel


def directional_do_nothing(vel=midpoint_velocity):
    """Directional do-nothing outlet: `sigma·n = 1/2 (u·n)_- u`, active
    only under backflow (no rho factor); the residual term
    `- 1/2 min(u_prev·n, 0)(u·v)`, the coefficient at u_prev."""

    def kernel(u_e, p_e, aux_e, coords_e, tabs, prm):
        phi_u = tabs["phi_u"]
        un_minus = torch.clamp(_un_prev(aux_e, tabs), max=0.0)
        u_q = torch.einsum("qb,bi->qi", phi_u, vel(u_e, aux_e))
        return -0.5 * torch.einsum("q,qb,qi->bi", tabs["dS"] * un_minus,
                                   phi_u, u_q)

    kernel.fused = FacetTerm("ddn", _implicit(vel))
    return kernel
