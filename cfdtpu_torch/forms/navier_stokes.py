"""SUPG/PSPG/LSIC-stabilized incompressible Navier-Stokes residual.

The counterpart of cfdtpu/forms/navier_stokes.py StabilizedNSForm
(Crank-Nicolson midpoint, equal-order Pk-Pk): the cell residual is
kernel K3 (kernels/ns_cell_residual.py, P1 triangles on CUDA; its plain
vmapped version elsewhere) reduced to the nodes by K2; the facet terms
are plain torch mapped with torch.func.vmap and reduced to the nodes by
K2 too, over one sorted scatter per facet block, so the residual is the
same on every run (an index_add on CUDA sums with atomics in no fixed
order).
The exact element Jacobians are torch.func.vmap(jacfwd(...)) of the
same plain kernels — the analogue of jax.vmap(jax.jacfwd(...)).

Parameters `prm` are a dict of Python floats: dt, rho, mu, and the body
force f as a tuple. Velocity u is (n_u, d); p is (n_p,).
"""

from __future__ import annotations

import numpy as np
import torch

from ..assembly import FacetQuadrature
from ..elements import LagrangeElement, quadrature
from ..kernels.ns_cell_residual import (CellTabs, ns_cell_kernel,
                                        ns_cell_residual_p1)
from ..spaces import FunctionSpace
from ..utils import SortedScatter, det_and_inv, torch_dtype
from .facet_terms import natural_correction


def _eps_for(dtype) -> float:
    """Division guard matching PETSc ScalarType resolution semantics."""
    return float(np.finfo(np.dtype(dtype)).resolution)


class StabilizedNSForm:
    """Residual of the stabilized NS equations (CN-midpoint stepping).

    aux: tuple of velocity history arrays; (u_prev,) here.
    """

    N_AUX = 1

    def __init__(
        self,
        V: FunctionSpace,
        Q: FunctionSpace,
        quad_degree: int | None = None,
        boundary_correction: bool = True,
        *,
        device,
        dtype=None,
    ):
        if V.mesh is not Q.mesh:
            raise ValueError("V and Q must live on the same mesh")
        mesh = V.mesh
        self.V, self.Q = V, Q
        self.mesh = mesh
        self.dim = mesh.dim
        self.device = torch.device(device)
        np_dt = np.dtype(mesh.points.dtype if dtype is None else dtype)
        self.np_dtype = np_dt
        self.dtype = dt = torch_dtype(np_dt)
        self.eps = _eps_for(np_dt)

        qd = quad_degree if quad_degree is not None else 2 * V.degree + 1
        self.quad_degree = qd
        xi, w = quadrature(mesh.cell_type, qd)

        nderiv = 2 if V.degree > 1 else 1
        tabs_u = V.element.tabulate(xi, nderiv=nderiv)
        tabs_p = Q.element.tabulate(xi, nderiv=1)
        geom = LagrangeElement.create(mesh.cell_type, 1)
        _, gdphi = geom.tabulate(xi, nderiv=1)
        same_dofmap = np.array_equal(np.asarray(V.dofmap),
                                     np.asarray(Q.dofmap))
        # cast on the host first, as cfdtpu does (jnp.asarray(.., dt))
        cast = (lambda a: None if a is None
                else np.asarray(a).astype(np_dt))
        self.tabs = CellTabs.create(
            cast(w), cast(tabs_u[0]), cast(tabs_u[1]),
            cast(tabs_u[2]) if nderiv == 2 else None,
            cast(tabs_p[0]), cast(tabs_p[1]), cast(gdphi),
            same_dofmap, self.device, dt,
        )

        dev = self.device
        self.dofmap_u = torch.as_tensor(np.asarray(V.dofmap, np.int32),
                                        device=dev)
        self.dofmap_p = torch.as_tensor(np.asarray(Q.dofmap, np.int32),
                                        device=dev)
        self._dmu_long = self.dofmap_u.long()
        self._dmp_long = self.dofmap_p.long()
        self.cell_coords = torch.as_tensor(
            mesh.points[mesh.cells].astype(np_dt), device=dev)
        self.cell_h = torch.as_tensor(mesh.h().astype(np_dt), device=dev)

        # flat per-element dof layout [u(b,i) row-major, then p(b)]
        # matching the solver's ravel convention (u.reshape(-1) ++ p)
        nbu, nbp = V.element.ndofs, Q.element.ndofs
        dim = self.dim
        dmf = (
            np.asarray(V.dofmap)[:, :, None] * dim
            + np.arange(dim)[None, None, :]
        ).reshape(-1, nbu * dim)
        self._dmf_np = np.concatenate(
            [dmf, V.num_dofs * dim + np.asarray(Q.dofmap)], axis=1
        ).astype(np.int32)
        self.dofmap_flat = torch.as_tensor(self._dmf_np.astype(np.int64),
                                           device=dev)
        self.nloc = nbu * dim + nbp
        self.n_flat = V.num_dofs * dim + Q.num_dofs

        # sorted ELL scatters (kernel K2) for the residual and the
        # element-block operator
        self._scatter_u = SortedScatter(np.asarray(V.dofmap), V.num_dofs,
                                        device=dev)
        self._scatter_p = SortedScatter(np.asarray(Q.dofmap), Q.num_dofs,
                                        device=dev)
        self._scatter_flat = SortedScatter(self._dmf_np, self.n_flat,
                                           device=dev)

        self._facet_blocks: list[dict] = []
        if boundary_correction and len(mesh.facets):
            self.add_facet_term(
                "natural_correction",
                np.arange(len(mesh.facets), dtype=np.int32),
                natural_correction(),
            )

    # ------------------------------------------------------------------
    def _cell_kernel(self, prm):
        """One-cell residual closure over prm for torch.func."""
        tabs, eps = self.tabs, self.eps
        f = torch.as_tensor(prm["f"], dtype=self.dtype, device=self.device)
        rho, mu, dt = prm["rho"], prm["mu"], prm["dt"]

        def kernel(u_e, p_e, uprev_e, coords_e, h_e):
            return ns_cell_kernel(u_e, p_e, uprev_e, coords_e, h_e, tabs,
                                  rho, mu, dt, f, eps)

        return kernel

    # ------------------------------------------------------------------
    # facet-term blocks
    # ------------------------------------------------------------------
    def add_facet_term(self, name: str, facet_indices, kernel) -> None:
        """Attach a boundary term over a facet subset.

        kernel(u_e, p_e, aux_e, coords_e, tabs, prm) -> r_u (nbu, dim);
        tabs = dict(phi_u (nq, nbu), dphi_u (nq, nbu, d), phi_p (nq, nbp),
        gdphi (nq, nvg, d), normal (nq, d), dS (nq,), h scalar).
        """
        mesh = self.mesh
        facet_indices = np.asarray(facet_indices, dtype=np.int32)
        if facet_indices.size == 0:
            return
        fq = FacetQuadrature(mesh, facet_indices, self.quad_degree)
        phi_u, dphi_u = fq.tabulate(self.V.element)
        phi_p, _ = fq.tabulate(self.Q.element)
        geom = LagrangeElement.create(mesh.cell_type, 1)
        _, gdphi = fq.tabulate(geom)
        _, normal, dS = fq.geometry()

        np_dt, dev = self.np_dtype, self.device
        g = fq.group
        cells = fq.cells

        def t(a):
            return torch.as_tensor(np.asarray(a).astype(np_dt), device=dev)

        dm_u = np.asarray(self.V.dofmap)[cells].astype(np.int64)
        block = {
            "name": name,
            "kernel": kernel,
            "dofmap_u": torch.as_tensor(dm_u, device=dev),
            # deterministic facet -> node reduction (K2), cf. _scatter_u
            "scatter_u": SortedScatter(dm_u, self.V.num_dofs, device=dev),
            "dofmap_p": torch.as_tensor(
                np.asarray(self.Q.dofmap)[cells].astype(np.int64),
                device=dev),
            "dofmap_flat_np": self._dmf_np[cells],
            "dofmap_flat": torch.as_tensor(
                self._dmf_np[cells].astype(np.int64), device=dev),
            "tabs": {
                "phi_u": t(phi_u.astype(np_dt)[g]),
                "dphi_u": t(dphi_u.astype(np_dt)[g]),
                "phi_p": t(phi_p.astype(np_dt)[g]),
                "gdphi": t(gdphi.astype(np_dt)[g]),
                "normal": t(normal),
                "dS": t(dS),
                "h": self.cell_h[torch.as_tensor(cells.astype(np.int64),
                                                 device=dev)],
            },
            "coords": self.cell_coords[
                torch.as_tensor(cells.astype(np.int64), device=dev)],
        }
        self._facet_blocks.append(block)

    def _block_residual(self, block, u, p, aux, prm):
        dm_u = block["dofmap_u"]
        dm_p = block["dofmap_p"]
        aux_e = tuple(a[dm_u] for a in aux)
        kernel = block["kernel"]

        def one(ue, pe, ae, ce, tb):
            return kernel(ue, pe, ae, ce, tb, prm)

        ru_f = torch.func.vmap(one)(u[dm_u], p[dm_p], aux_e,
                                    block["coords"], block["tabs"])
        return dm_u, ru_f

    # ------------------------------------------------------------------
    def residual(self, u, p, aux, prm):
        """Assembled residual (r_u (n_u, d), r_p (n_p,))."""
        (u_prev,) = aux
        ru_e, rp_e = ns_cell_residual_p1(
            u, u_prev, p, self.dofmap_u, self.dofmap_p, self.cell_coords,
            self.cell_h, self.tabs, prm["rho"], prm["mu"], prm["dt"],
            prm["f"], self.eps,
        )
        ru = self._scatter_u(ru_e.reshape(-1, self.dim))
        rp = self._scatter_p(rp_e.reshape(-1))
        # cells first, then each facet block in order: a fixed order of
        # sums (cfdtpu adds with .at[dm_u].add)
        for block in self._facet_blocks:
            _, ru_f = self._block_residual(block, u, p, aux, prm)
            ru = ru + block["scatter_u"](
                ru_f.reshape(-1, self.dim).contiguous())
        return ru, rp

    # ------------------------------------------------------------------
    def element_jacobians(self, u, p, aux, prm):
        """Exact element Jacobian blocks: (A_cells (nc, nloc, nloc),
        [(dofmap_flat, A_block) per facet term])."""
        nbu = self.V.element.ndofs
        dim = self.dim
        nc = self.mesh.num_cells
        (u_prev,) = aux
        xe = torch.cat(
            [u[self._dmu_long].reshape(nc, -1), p[self._dmp_long]], dim=1)
        kernel = self._cell_kernel(prm)

        def fk(x, upe, ce, he):
            ru, rp = kernel(x[: nbu * dim].reshape(nbu, dim), x[nbu * dim:],
                            upe, ce, he)
            return torch.cat([ru.reshape(-1), rp])

        A_cells = torch.func.vmap(torch.func.jacfwd(fk))(
            xe, u_prev[self._dmu_long], self.cell_coords, self.cell_h)

        nbp = self.Q.element.ndofs
        A_blocks = []
        for block in self._facet_blocks:
            dm_u = block["dofmap_u"]
            dm_p = block["dofmap_p"]
            xef = torch.cat([u[dm_u].reshape(len(dm_u), -1), p[dm_p]],
                            dim=1)
            aux_ef = tuple(a[dm_u] for a in aux)
            fkern = block["kernel"]

            def ffk(x, ae, ce, tb, _k=fkern):
                ru = _k(x[: nbu * dim].reshape(nbu, dim), x[nbu * dim:],
                        ae, ce, tb, prm)
                return torch.cat([ru.reshape(-1),
                                  torch.zeros((nbp,), dtype=ru.dtype,
                                              device=ru.device)])

            A_f = torch.func.vmap(torch.func.jacfwd(ffk))(
                xef, aux_ef, block["coords"], block["tabs"])
            A_blocks.append((block["dofmap_flat"], A_f))
        return A_cells, A_blocks

    # ------------------------------------------------------------------
    # element-block operator (used by the pressure-nullspace test; the
    # solve path applies the assembled node-BSR operator)
    # ------------------------------------------------------------------
    def apply_element_matrices(self, A_cells, A_blocks, v_flat):
        """y = A v with A given as element blocks; flat dof layout."""
        ve = v_flat[self.dofmap_flat]  # (nc, nloc)
        ye = torch.einsum("cab,cb->ca", A_cells, ve)
        y = self._scatter_flat(ye.reshape(-1))
        for dmf, A_f in A_blocks:
            yf = torch.einsum("fab,fb->fa", A_f, v_flat[dmf])
            y = y.index_add(0, dmf.reshape(-1), yf.reshape(-1))
        return y

    @property
    def n_u_flat(self):
        return self.V.num_dofs * self.dim

    def apply_sub_block(self, A_cells, A_blocks, v, which: str):
        """Apply one 2x2 fieldsplit sub-block of the element-block
        operator: which in {"uu", "up", "pu", "pp"}."""
        nud = self.V.element.ndofs * self.dim
        row_u = which[0] == "u"
        col_u = which[1] == "u"
        rs = slice(0, nud) if row_u else slice(nud, self.nloc)
        cs = slice(0, nud) if col_u else slice(nud, self.nloc)
        n_u_flat = self.n_u_flat
        n_out = n_u_flat if row_u else self.Q.num_dofs

        def split(dm):
            dc = dm[:, cs] if col_u else dm[:, cs] - n_u_flat
            dr = dm[:, rs] if row_u else dm[:, rs] - n_u_flat
            return dc, dr

        y = torch.zeros((n_out,), dtype=v.dtype, device=v.device)
        for dm, A in [(self.dofmap_flat, A_cells), *A_blocks]:
            dc, dr = split(dm)
            ye = torch.einsum("cab,cb->ca", A[:, rs, cs], v[dc])
            y = y.index_add(0, dr.reshape(-1), ye.reshape(-1))
        return y

    def jacobian_diagonal(self, A_cells, A_blocks):
        """Assembled diagonal of the element-block operator."""
        d = self._scatter_flat(
            torch.diagonal(A_cells, dim1=1, dim2=2).reshape(-1))
        for dmf, A_f in A_blocks:
            d = d.index_add(0, dmf.reshape(-1),
                            torch.diagonal(A_f, dim1=1, dim2=2).reshape(-1))
        return d

    # ------------------------------------------------------------------
    def l2_norm_sq(self, fn):
        """Integral of |fn|^2 over the domain (norms.txt)."""
        t = self.tabs
        if fn.dim() == 1:
            is_p = fn.shape[0] == self.Q.num_dofs
            phi = t.phi_p if is_p else t.phi_u
            dm = self._dmp_long if is_p else self._dmu_long
            vals = torch.einsum("qb,cb->cq", phi, fn[dm]) ** 2
        else:
            v = torch.einsum("qb,cbi->cqi", t.phi_u, fn[self._dmu_long])
            vals = torch.sum(v * v, dim=-1)
        J = torch.einsum("cvg,qvd->cqgd", self.cell_coords, t.gdphi)
        detJ, _ = det_and_inv(J)
        return torch.sum(vals * detJ.abs() * t.qw[None, :])
