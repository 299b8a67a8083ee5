"""SUPG/PSPG/LSIC-stabilized incompressible Navier-Stokes residual.

The counterpart of cfdtpu/forms/navier_stokes.py StabilizedNSForm
(Crank-Nicolson midpoint, equal-order Pk-Pk), StabilizedNSFormBDF2 and
StabilizedNSFormCurlCurl. The cell residual and the exact element
Jacobians are the entry points of kernel K3 (kernels/
ns_cell_residual.py: P1 triangles on CUDA, elsewhere the plain vmapped
cell kernel and vmap(jacfwd(.)) of it, the analogue of
jax.vmap(jax.jacfwd(.))), under BDF2 those of K14, in the curl-curl form
those of K15. A form carries any number of facet blocks (up to the
launch's MAX_FACET_BLOCKS), several on the same facets if need be: the
natural correction (K7), the viscous traction (K12), the backflow
stabilisation (K13), the weak pressure (K16), Nitsche's u_T = 0 (K17)
and the convective and directional do-nothing outlets (K18), each at the
midpoint or at u (forms/facet_terms.py), and flux-only blocks, which
facet_flux reads and no kernel runs. Their bodies run inside the element
kernel's launch, residual and Jacobian alike: one launch a residual, one
a Jacobian build. Cell and facet contributions are reduced to the nodes
by K2, the cells first, then each facet block over its own sorted
scatter in the order the blocks were added (cfdtpu's .at[dm_u].add
order), so the residual is the same on every run (an index_add on CUDA
sums with atomics in no fixed order).

Parameters `prm` are a dict of Python floats: dt, rho, mu, and the body
force f as a tuple, plus what the facet terms read (beta_backflow,
beta_nitsche, the weak pressures such as p_inlet or p_c) and, under
BDF2, bdf_a0..bdf_a2. Velocity u is (n_u, d); p is (n_p,).
"""

from __future__ import annotations

import numpy as np
import torch

from ..assembly import FacetQuadrature
from ..elements import LagrangeElement, quadrature
from ..kernels.ns_cell_residual import (CellTabs, ns_cell_jacobian_bdf2_p1,
                                        ns_cell_jacobian_curl_p1,
                                        ns_cell_jacobian_p1,
                                        ns_cell_residual_bdf2_p1,
                                        ns_cell_residual_curl_p1,
                                        ns_cell_residual_p1)
from ..kernels.ns_facet import FacetBlock, FacetTerm, facet_call
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
    # the cell body's entry points (residual, Jacobian): K3
    CELL_KERNELS = (ns_cell_residual_p1, ns_cell_jacobian_p1)

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

        # sorted scatters of the sub-block row maps (apply_sub_block),
        # built at first use: {(block index or -1 for the cells, "u" or
        # "p"): SortedScatter}
        self._row_scatters: dict = {}
        self._facet_blocks: list[dict] = []
        # blocks that only measure a flux (facet_flux): no term, no launch
        self._flux_blocks: list[dict] = []
        if boundary_correction and len(mesh.facets):
            self.add_facet_term(
                "natural_correction",
                np.arange(len(mesh.facets), dtype=np.int32),
                natural_correction(),
            )

    # ------------------------------------------------------------------
    # facet-term blocks
    # ------------------------------------------------------------------
    def add_facet_term(self, name: str, facet_indices, kernel) -> None:
        """Attach a boundary term over a facet subset.

        kernel(u_e, p_e, aux_e, coords_e, tabs, prm) -> r_u (nbu, dim);
        tabs = dict(phi_u (nq, nbu), dphi_u (nq, nbu, d), phi_p (nq, nbp),
        gdphi (nq, nvg, d), normal (nq, d), dS (nq,), h scalar). The
        kernel must be one of forms/facet_terms.py's, whose `fused`
        names its CUDA kernel; any other raises.
        """
        term = getattr(kernel, "fused", None)
        if not isinstance(term, FacetTerm):
            raise NotImplementedError(
                f"facet term {name!r} has no CUDA kernel: the ported facet "
                "terms are natural_correction (K7), viscous_traction (K12), "
                "backflow (K13), weak_pressure (K16), nitsche_tangential "
                "and nitsche_tangential_curl (K17), cbc and "
                "directional_do_nothing (K18); "
                "natural_correction_full_stress comes with ROADMAP A11")
        block = self._make_block(name, facet_indices)
        if block is not None:
            block["term"] = term
            self._facet_blocks.append(block)

    def add_flux_block(self, name: str, facet_indices) -> None:
        """A facet subset that facet_flux measures and no term acts on
        (cfdtpu adds a term of zeros for it, which changes no sum)."""
        block = self._make_block(name, facet_indices)
        if block is not None:
            self._flux_blocks.append(block)

    def _make_block(self, name: str, facet_indices):
        """A facet block's tables and maps (None for no facets)."""
        mesh = self.mesh
        facet_indices = np.asarray(facet_indices, dtype=np.int32)
        if facet_indices.size == 0:
            return None
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
        dm_p = np.asarray(self.Q.dofmap)[cells].astype(np.int64)
        return {
            "name": name,
            "dofmap_u": torch.as_tensor(dm_u, device=dev),
            # int32 copies for the facet kernels' gathers
            "dofmap_u32": torch.as_tensor(dm_u.astype(np.int32), device=dev),
            "dofmap_p32": torch.as_tensor(dm_p.astype(np.int32), device=dev),
            # deterministic facet -> node reduction (K2), cf. _scatter_u
            "scatter_u": SortedScatter(dm_u, self.V.num_dofs, device=dev),
            # the same for the element-block operator (flat dof layout)
            "scatter_flat": SortedScatter(self._dmf_np[cells], self.n_flat,
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

    @staticmethod
    def _fused_args(block, u, p, aux, prm):
        """The arguments of K7's entry points for a natural-correction
        block at the midpoint."""
        return (u, aux[0], p, block["dofmap_u32"], block["dofmap_p32"],
                block["coords"], block["tabs"], prm["mu"])

    @staticmethod
    def _kernel_block(block, prm) -> FacetBlock:
        """A facet block as the element kernels take it."""
        term = block["term"]
        return FacetBlock(term, block["dofmap_u32"], block["dofmap_p32"],
                          block["coords"], block["tabs"], term.scalars(prm))

    def _block_residual(self, block, u, p, aux, prm):
        """One facet block's residual alone (its term's own launch): the
        reaction force takes the natural correction out of the assembled
        residual."""
        kb = self._kernel_block(block, prm)
        return block["dofmap_u"], facet_call(kb.term, kb.scalars, False, u,
                                             aux[0], p, *kb.args())

    def _element_call(self, jacobian: bool, u, p, aux, prm):
        """One element-kernel launch: the cells and every facet block
        (CELL_KERNELS; K14 in the BDF2 form)."""
        fn = self.CELL_KERNELS[jacobian]
        out = fn(u, aux[0], p, self.dofmap_u, self.dofmap_p,
                 self.cell_coords, self.cell_h, self.tabs, prm["rho"],
                 prm["mu"], prm["dt"], prm["f"], self.eps,
                 facets=[self._kernel_block(b, prm)
                         for b in self._facet_blocks])
        return out

    # ------------------------------------------------------------------
    def residual(self, u, p, aux, prm):
        """Assembled residual (r_u (n_u, d), r_p (n_p,)): one element
        kernel launch with every facet block in it, then the K2 sums."""
        out = self._element_call(False, u, p, aux, prm)
        ru = self._scatter_u(out[0].reshape(-1, self.dim))
        rp = self._scatter_p(out[1].reshape(-1))
        # cells first, then each facet block in the order it was added: a
        # fixed order of sums (cfdtpu adds with .at[dm_u].add)
        for block, ru_f in zip(self._facet_blocks, out[2:]):
            ru = ru + block["scatter_u"](
                ru_f.reshape(-1, self.dim).contiguous())
        return ru, rp

    # ------------------------------------------------------------------
    def element_jacobians(self, u, p, aux, prm):
        """Exact element Jacobian blocks: (A_cells (nc, nloc, nloc),
        [(dofmap_flat, A_block) per facet block]), from one launch."""
        out = self._element_call(True, u, p, aux, prm)
        if not self._facet_blocks:
            return out, []
        return out[0], [(block["dofmap_flat"], A_f) for block, A_f
                        in zip(self._facet_blocks, out[1:])]

    def facet_flux(self, u, name: str):
        """Q = int u·n dS over the named facet block or flux-only block
        (torch ops)."""
        for block in self._facet_blocks + self._flux_blocks:
            if block["name"] == name:
                tabs = block["tabs"]
                u_q = torch.einsum("fqb,fbi->fqi", tabs["phi_u"],
                                   u[block["dofmap_u"]])
                un = torch.einsum("fqi,fqi->fq", u_q, tabs["normal"])
                return torch.sum(un * tabs["dS"])
        raise KeyError(f"no facet block named {name!r}")

    # ------------------------------------------------------------------
    # element-block operator (used by the pressure-nullspace test; the
    # solve path applies the assembled node-BSR operator)
    # ------------------------------------------------------------------
    def _facet_pairs(self, A_blocks):
        """(facet block, (dofmap_flat, A_f)) for each facet term, A_blocks
        as element_jacobians returns them."""
        if len(A_blocks) != len(self._facet_blocks):
            raise ValueError(f"{len(A_blocks)} facet blocks given, the form "
                             f"has {len(self._facet_blocks)}")
        return zip(self._facet_blocks, A_blocks)

    def apply_element_matrices(self, A_cells, A_blocks, v_flat):
        """y = A v with A given as element blocks; flat dof layout. Each
        block's rows are summed by K2 over its sorted scatter (cfdtpu:
        .at[].add), cells first, then the facet blocks in order."""
        ve = v_flat[self.dofmap_flat]  # (nc, nloc)
        ye = torch.einsum("cab,cb->ca", A_cells, ve)
        y = self._scatter_flat(ye.reshape(-1))
        for block, (dmf, A_f) in self._facet_pairs(A_blocks):
            yf = torch.einsum("fab,fb->fa", A_f, v_flat[dmf])
            y = y + block["scatter_flat"](yf.reshape(-1))
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

        y = None
        blocks = [(-1, self.dofmap_flat, A_cells)]
        blocks += [(k, dmf, A_f) for k, (_, (dmf, A_f))
                   in enumerate(self._facet_pairs(A_blocks))]
        for key, dm, A in blocks:
            dc, dr = split(dm)
            ye = torch.einsum("cab,cb->ca", A[:, rs, cs], v[dc])
            yb = self._row_scatter(key, which[0], dr, n_out)(ye.reshape(-1))
            y = yb if y is None else y + yb
        return y

    def _row_scatter(self, key, row: str, dr, n_out: int):
        """The sorted scatter (K2) of one block's sub-block row map `dr`
        (rows "u" or "p"), built once."""
        scat = self._row_scatters.get((key, row))
        if scat is None:
            scat = SortedScatter(dr.cpu().numpy(), n_out, device=self.device)
            self._row_scatters[(key, row)] = scat
        return scat

    def jacobian_diagonal(self, A_cells, A_blocks):
        """Assembled diagonal of the element-block operator."""
        d = self._scatter_flat(
            torch.diagonal(A_cells, dim1=1, dim2=2).reshape(-1))
        for block, (_, A_f) in self._facet_pairs(A_blocks):
            d = d + block["scatter_flat"](
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


class StabilizedNSFormBDF2(StabilizedNSForm):
    """BDF2 variant (cfdtpu's StabilizedNSFormBDF2): time term
    rho (a0 u + a1 u_prev + a2 u_prev2) / dt with the coefficients in
    prm (bdf_a0, bdf_a1, bdf_a2: BDF1 on a first step), convection,
    stress and continuity at u; tau still from u_prev. The cell body is
    kernel K14.

    aux = (u_prev, u_prev2).
    """

    N_AUX = 2

    def _element_call(self, jacobian: bool, u, p, aux, prm):
        fn = (ns_cell_jacobian_bdf2_p1 if jacobian
              else ns_cell_residual_bdf2_p1)
        return fn(u, aux[0], aux[1], p, self.dofmap_u, self.dofmap_p,
                  self.cell_coords, self.cell_h, self.tabs, prm["rho"],
                  prm["mu"], prm["dt"], prm["f"], self.eps,
                  (prm["bdf_a0"], prm["bdf_a1"], prm["bdf_a2"]),
                  facets=[self._kernel_block(b, prm)
                          for b in self._facet_blocks])


class StabilizedNSFormCurlCurl(StabilizedNSForm):
    """Curl-curl (rotational) formulation (cfdtpu's
    StabilizedNSFormCurlCurl): viscous term mu curl(u_mid)·curl(v),
    Lamb-form convection rho (curl(u_mid) x u_mid)·v - rho/2 |u_mid|^2
    div(v), pressure -p div(v), continuity q div(u_mid); SUPG/PSPG/LSIC
    with the strong residual R = rho(du/dt + curl(u_mid) x u_mid) +
    grad p - rho f. 2D (the scalar rotation omega). The cell body is
    kernel K15.
    """

    CELL_KERNELS = (ns_cell_residual_curl_p1, ns_cell_jacobian_curl_p1)
