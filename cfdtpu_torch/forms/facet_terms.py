"""Boundary (facet) term kernels.

The counterpart of cfdtpu/forms/facet_terms.py for the terms that have
a CUDA kernel:

- natural_correction: `p n·v - mu (nabla_grad u)^T n·v` on all exterior
  facets (kernel K7, kernels/ns_facet.py);
- viscous_traction: `sign (2 mu eps(u) n)·v`, the outlet stress
  correction (kernel K12, kernels/ns_facet.py);
- backflow: `- beta rho (u_prev·n)_- (u·v)` (kernel K13,
  kernels/ns_facet.py).

A factory returns a per-facet kernel
    kernel(u_e, p_e, aux_e, coords_e, tabs, prm) -> r_u (nbu, dim)
in plain torch, which torch.func.vmap maps over facets (and jacfwd
differentiates for the element Jacobians): the plain version of its
CUDA kernel. A kernel names that kernel and its options in its `fused`
attribute, a kernels.ns_facet.FacetTerm; StabilizedNSForm takes only
kernels that have one. The `vel` selector picks the time-scheme
velocity the term acts on: the Crank-Nicolson midpoint by default,
`implicit_velocity` for BDF2.

Not ported yet (ROADMAP queue B5f): weak_pressure, nitsche_tangential,
nitsche_tangential_curl, cbc, directional_do_nothing and
natural_correction_full_stress.
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
