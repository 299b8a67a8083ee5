"""Drag/lift boundary-force functionals (plain torch).

The counterpart of cfdtpu/postprocess/forces.py: with n the facet
normal flipped to point from the obstacle into the fluid and
t = (n_y, -n_x),

    F_D = int_obs ( mu d(u·t)/dn n_y - p n_x ) ds
    F_L = -int_obs ( mu d(u·t)/dn n_x + p n_y ) ds

and the traction-based force F_i = int (-sigma(u, p) n)_i ds that the
dfg_2d_1 solver prints every step. Both are output-side facet
quadratures over the obstacle facets in torch ops; their one host read
is the caller's float().
"""

from __future__ import annotations

import numpy as np
import torch

from ..assembly import FacetQuadrature
from ..elements import LagrangeElement
from ..spaces import FunctionSpace
from ..utils import det_and_inv, torch_dtype


class BoundaryForce:
    """Precomputed facet data for force functionals over a tagged facet
    subset (the obstacle boundary), on `device`."""

    def __init__(self, V: FunctionSpace, Q: FunctionSpace, facet_indices,
                 device, dtype=None):
        mesh = V.mesh
        self.V, self.Q = V, Q
        fq = FacetQuadrature(mesh, facet_indices, 2 * V.degree + 1)
        phi_u, dphi_u = fq.tabulate(V.element)
        phi_p, _ = fq.tabulate(Q.element)
        geom = LagrangeElement.create(mesh.cell_type, 1)
        _, gdphi = fq.tabulate(geom)
        _, normal, dS = fq.geometry()

        np_dt = np.dtype(mesh.points.dtype if dtype is None else dtype)
        dt = torch_dtype(np_dt)

        def t(a):
            return torch.as_tensor(np.asarray(a).astype(np_dt), dtype=dt,
                                   device=device)

        def i(a):
            return torch.as_tensor(np.asarray(a).astype(np.int64),
                                   device=device)

        g = fq.group
        self.cells = fq.cells
        self.phi_u = t(phi_u)[i(g)]
        self.dphi_u = t(dphi_u)[i(g)]
        self.phi_p = t(phi_p)[i(g)]
        self.gdphi = t(gdphi)[i(g)]
        self.normal = t(normal)
        self.dS = t(dS)
        self.dofmap_u = i(np.asarray(V.dofmap)[fq.cells])
        self.dofmap_p = i(np.asarray(Q.dofmap)[fq.cells])
        self.coords = t(mesh.points[mesh.cells][fq.cells])

    def _fields(self, u, p):
        u_e = u[self.dofmap_u]
        p_e = p[self.dofmap_p]
        J = torch.einsum("fvg,fqvd->fqgd", self.coords, self.gdphi)
        _, invJ = det_and_inv(J)
        gu = torch.einsum("fqbd,fqdg->fqbg", self.dphi_u, invJ)
        grad_u = torch.einsum("fbi,fqbg->fqig", u_e, gu)  # (f, q, i, g)
        u_q = torch.einsum("fqb,fbi->fqi", self.phi_u, u_e)
        p_q = torch.einsum("fqb,fb->fq", self.phi_p, p_e)
        return u_q, grad_u, p_q

    def drag_lift(self, u, p, mu: float):
        """DFG drag/lift line integrals. The stored facet normal points
        out of the fluid; the formula uses the flipped normal."""
        _, grad_u, p_q = self._fields(u, p)
        n = -self.normal  # (f, q, 2)
        t = torch.stack([n[..., 1], -n[..., 0]], dim=-1)
        dut_dn = torch.einsum("fqi,fqig,fqg->fq", t, grad_u, n)
        fd = torch.sum((mu * dut_dn * n[..., 1] - p_q * n[..., 0]) * self.dS)
        fl = -torch.sum(
            (mu * dut_dn * n[..., 0] + p_q * n[..., 1]) * self.dS)
        return fd, fl

    def traction_force(self, u, p, mu: float):
        """F_i = int (-sigma(u, p) n)_i ds with the outward fluid
        normal: a (2,) tensor."""
        _, grad_u, p_q = self._fields(u, p)
        n = self.normal
        eps_u = 0.5 * (grad_u + grad_u.transpose(2, 3))
        sig_n = (2.0 * mu * torch.einsum("fqig,fqg->fqi", eps_u, n)
                 - p_q[..., None] * n)
        return -torch.einsum("fqi,fq->i", sig_n, self.dS)
