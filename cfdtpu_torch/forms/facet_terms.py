"""Boundary (facet) term kernels.

The counterpart of cfdtpu/forms/facet_terms.py; only the term on the
DFG 2D-1 path is ported, the natural correction
`p n·v - mu (nabla_grad u)^T n·v` on all exterior facets. A factory
returns a per-facet kernel
    kernel(u_e, p_e, aux_e, coords_e, tabs, prm) -> r_u (nbu, dim)
in plain torch, which torch.func.vmap maps over facets (and jacfwd
differentiates for the element Jacobians). A kernel names its CUDA
counterpart in its `fused` attribute, and StabilizedNSForm takes only
kernels that have one: the natural correction is kernel K7
(kernels/ns_facet_natural.py), whose plain version is the vmap of the
kernel below.
"""

from __future__ import annotations

import torch

from ..utils import det_and_inv


def _phys_grad_u(tabs, coords_e):
    """Physical gradients of the velocity basis at the facet quadrature
    points: (nq, nbu, gdim)."""
    J = torch.einsum("vg,qvd->qgd", coords_e, tabs["gdphi"])
    _, invJ = det_and_inv(J)
    return torch.einsum("qbd,qdg->qbg", tabs["dphi_u"], invJ)


def natural_correction():
    """`p n·v - mu (nabla_grad u)^T n·v` (UFL transpose convention), at
    the Crank-Nicolson midpoint velocity."""

    def kernel(u_e, p_e, aux_e, coords_e, tabs, prm):
        mu = prm["mu"]
        n, dS = tabs["normal"], tabs["dS"]
        gu = _phys_grad_u(tabs, coords_e)
        um = 0.5 * (u_e + aux_e[0])
        grad_um = torch.einsum("bi,qbg->qig", um, gu)
        p_q = tabs["phi_p"] @ p_e
        gtn = torch.einsum("qjg,qj->qg", grad_um, n)
        term = p_q[:, None] * n - mu * gtn
        return torch.einsum("q,qb,qi->bi", dS, tabs["phi_u"], term)

    kernel.fused = "natural_correction"
    return kernel
