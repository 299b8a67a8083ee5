"""Plain reference of one time step of the stabilised Navier-Stokes
equations on P1 triangles.

Crank-Nicolson midpoint in time; Galerkin terms with SUPG, PSPG and
LSIC stabilisation (Tezduyar's tau from the previous velocity, the
element size h the longest edge); the natural-correction term
`(p n - mu (grad u_m)^T n) . v` on every boundary facet; the velocity's
Dirichlet values and p = 0 on the nodes that the problem gives
(benchmark/problems). Integrals use the 6-point degree-4
rule of Dunavant (1985) on the cells and 2-point Gauss-Legendre on the
facets.

Everything is worked out from the inputs the benchmark makes (the mesh
arrays, the physical parameters, the boundary data and a state), with
plain torch tensor operations and a SciPy sparse LU: the dofmaps, the
geometry, the Dirichlet rows, the residual, its exact Jacobian (forward-mode
derivatives of the element residuals) and Newton's method to the
rounding floor. `dtype` selects the arithmetic of the residual and the
state: float64 for the reference; float32 or bfloat16 for the control,
where the solves run in float32 because SciPy has no lower precision.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch
import torch.autograd.forward_ad as fwAD

# Dunavant's degree-4 rule: barycentric points and weights (sum 1/2)
_A1, _B1 = 0.445948490915965, 0.108103018168070
_A2, _B2 = 0.091576213509771, 0.816847572980459
_W1, _W2 = 0.223381589678011 / 2, 0.109951743655322 / 2
QUAD_XI = np.array([[_A1, _A1], [_A1, _B1], [_B1, _A1],
                    [_A2, _A2], [_A2, _B2], [_B2, _A2]])
QUAD_W = np.array([_W1] * 3 + [_W2] * 3)
# 2-point Gauss-Legendre on [0, 1]
_G = 0.5 / np.sqrt(3.0)
FACET_S = np.array([0.5 - _G, 0.5 + _G])
FACET_W = np.array([0.5, 0.5])
# reference gradients of the P1 basis, local vertex order 0, 1, 2
DPHI = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
TRI_FACETS = ((1, 2), (0, 2), (0, 1))


def p1_values(xi):
    """P1 basis values at reference points xi (n, 2): (n, 3)."""
    xi = np.asarray(xi, dtype=np.float64)
    return np.stack([1 - xi[:, 0] - xi[:, 1], xi[:, 0], xi[:, 1]], axis=1)


class Problem:
    """The discrete problem of one cell: its geometry and boundary data
    in float64 NumPy, and the residual in `dtype` on `device`.

    mesh: dict with points (n, 2), cells (nc, 3), facets (nf, 2)
    (every boundary facet) and facet_cells (nf,); phys: rho, mu, dt, eps
    (the division guard of tau, the configuration's float resolution);
    bc_u (n,) the nodes whose velocity is given, g (n, 2) its values
    there; bc_p (n,) the nodes whose pressure is 0.
    """

    def __init__(self, mesh, phys, bc_u, g, bc_p, device="cpu",
                 dtype=torch.float64):
        self.device = torch.device(device)
        self.dtype = dtype
        x = np.asarray(mesh["points"], dtype=np.float64)
        cells = np.asarray(mesh["cells"], dtype=np.int64)
        self.n = n = len(x)
        self.nc = len(cells)
        self.rho, self.mu = float(phys["rho"]), float(phys["mu"])
        self.dt = float(phys["dt"])
        self.eps = float(phys["eps"])

        xc = x[cells]                                   # (nc, 3, 2)
        J = np.einsum("cvg,vd->cgd", xc, DPHI)          # dx_g / dxi_d
        det = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
        invJ = np.stack([np.stack([J[:, 1, 1], -J[:, 0, 1]], -1),
                         np.stack([-J[:, 1, 0], J[:, 0, 0]], -1)], 1)
        invJ = invJ / det[:, None, None]                # dxi_d / dx_g
        grad = np.einsum("bd,cdg->cbg", DPHI, invJ)     # (nc, 3, 2)
        edges = np.linalg.norm(xc[:, :, None, :] - xc[:, None, :, :],
                               axis=-1)
        h = edges.max(axis=(1, 2))
        phi = p1_values(QUAD_XI)                        # (6, 3)
        wdet = QUAD_W[None, :] * np.abs(det)[:, None]   # (nc, 6)

        # the natural correction on every boundary facet, as a term of
        # the cell that holds the facet
        facets = np.asarray(mesh["facets"], dtype=np.int64)
        fcells = np.asarray(mesh["facet_cells"], dtype=np.int64)
        fx = x[facets]                                  # (nf, 2, 2)
        tvec = fx[:, 1] - fx[:, 0]
        flen = np.linalg.norm(tvec, axis=1)
        normal = np.stack([tvec[:, 1], -tvec[:, 0]], -1) / flen[:, None]
        inward = x[cells[fcells]].mean(axis=1) - fx.mean(axis=1)
        if np.any((normal * inward).sum(axis=1) > 0):
            raise ValueError("boundary facets are not oriented outward")
        # P1 values of the cell's three basis functions at the facet's
        # Gauss points: linear along the facet, 0 for the third vertex
        loc = (cells[fcells][:, :, None] == facets[:, None, :])  # (nf,3,2)
        fphi = (loc[:, :, None, 0] * (1 - FACET_S)[None, None, :]
                + loc[:, :, None, 1] * FACET_S[None, None, :])   # (nf,3,2q)
        fdS = FACET_W[None, :] * flen[:, None]          # (nf, 2)

        bc_u = np.asarray(bc_u, dtype=bool)
        bc_p = np.asarray(bc_p, dtype=bool)
        g = np.asarray(g, dtype=np.float64)
        self.bc_u, self.bc_p, self.g = bc_u, bc_p, g
        # flat node-interleaved layout: dof 3 i + c, c = u_x, u_y, p
        self.bc_flat = np.stack([bc_u, bc_u, bc_p], axis=1).reshape(-1)
        self.g_flat = np.stack([g[:, 0], g[:, 1], np.zeros(n)],
                               axis=1).reshape(-1)
        self.cells_np = cells
        # seconds spent in each part of step(), for the run's record
        self.seconds = {"jacobian": 0.0, "factor": 0.0, "residual": 0.0}

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float64),
                                   device=self.device).to(dtype)

        self.cells = torch.as_tensor(cells, device=self.device)
        self.grad, self.h, self.wdet, self.phi = t(grad), t(h), t(wdet), \
            t(phi)
        self.fcells = torch.as_tensor(fcells, device=self.device)
        self.fgrad = self.grad[self.fcells]
        self.fphi, self.fdS, self.normal = t(fphi), t(fdS), t(normal)

    # ------------------------------------------------------------------
    def element_residual(self, xe, xe_prev):
        """Element residuals (nc, 3, 3) of the element unknowns xe (nc,
        3, 3): per vertex (u_x, u_y, p); xe_prev the previous state's."""
        rho, mu, dt = self.rho, self.mu, self.dt
        nu = mu / rho
        phi, gr, wdet, h = self.phi, self.grad, self.wdet, self.h
        u_e, p_e = xe[..., :2], xe[..., 2]
        up_e = xe_prev[..., :2]
        u_q = torch.einsum("qb,cbi->cqi", phi, u_e)
        up_q = torch.einsum("qb,cbi->cqi", phi, up_e)
        um_q = 0.5 * (u_q + up_q)
        grad_um = torch.einsum("cbi,cbg->cig", 0.5 * (u_e + up_e), gr)
        p_q = torch.einsum("qb,cb->cq", phi, p_e)
        grad_p = torch.einsum("cb,cbg->cg", p_e, gr)
        div_um = grad_um[:, 0, 0] + grad_um[:, 1, 1]            # (nc,)
        conv = torch.einsum("cig,cqg->cqi", grad_um, um_q)
        dudt = (u_q - up_q) / dt
        R = rho * (dudt + conv) + grad_p[:, None, :]            # f = 0
        vn = torch.sqrt(torch.sum(up_q * up_q, dim=-1))         # (nc, q)
        hq = h[:, None]
        t1 = hq / torch.clamp(2.0 * vn, min=self.eps)
        t2 = dt / 2.0
        t3 = hq * hq / (4.0 * nu)
        tau = (t1 ** -2.0 + t2 ** -2.0 + t3 ** -2.0) ** -0.5
        z = torch.clamp(vn * hq / (2.0 * nu) / 3.0, max=1.0)
        tau_lsic = vn * hq * z / 2.0
        sym = mu * (grad_um + grad_um.transpose(1, 2))          # (nc, 2, 2)

        ru = torch.einsum("cq,qb,cqi->cbi", wdet, phi, rho * (dudt + conv))
        # (sig : grad v) with sig = mu (grad + grad^T) - p I
        ru = ru + wdet.sum(1)[:, None, None] * torch.einsum(
            "cij,cbj->cbi", sym, gr)
        ru = ru - torch.einsum("cq,cq,cbi->cbi", wdet, p_q, gr)
        adv = torch.einsum("cbg,cqg->cqb", gr, um_q)
        ru = ru + torch.einsum("cq,cqi,cqb->cbi", wdet * tau, R, adv)
        ru = ru + rho * torch.einsum("cq,c,cbi->cbi", wdet * tau_lsic,
                                     div_um, gr)
        rp = torch.einsum("cq,c,qb->cb", wdet, div_um, phi)
        rp = rp + torch.einsum("cq,cqi,cbi->cb", wdet * tau / rho, R, gr)

        # natural correction: (p n - mu (grad u_m)^T n) . v on the facets
        fx = xe[self.fcells]
        fxp = xe_prev[self.fcells]
        g_um = torch.einsum("fbi,fbg->fig", 0.5 * (fx[..., :2]
                                                   + fxp[..., :2]),
                            self.fgrad)
        gtn = torch.einsum("fjg,fj->fg", g_um, self.normal)      # (nf, 2)
        p_f = torch.einsum("fbq,fb->fq", self.fphi, fx[..., 2])
        term = (p_f[..., None] * self.normal[:, None, :]
                - mu * gtn[:, None, :])                          # (nf,q,2)
        ru_f = torch.einsum("fq,fbq,fqi->fbi", self.fdS, self.fphi, term)
        ru = torch.index_add(ru, 0, self.fcells, ru_f)
        return torch.cat([ru, rp[..., None]], dim=-1)

    def residual(self, x, x_prev):
        """Assembled residual (3 n,) in the flat layout, Dirichlet rows
        replaced by x - g."""
        X = x.reshape(self.n, 3)
        re = self.element_residual(X[self.cells], x_prev.reshape(
            self.n, 3)[self.cells])
        r = torch.zeros(self.n, 3, dtype=re.dtype, device=re.device)
        r = r.index_add(0, self.cells.reshape(-1), re.reshape(-1, 3))
        r = r.reshape(-1)
        bc = torch.as_tensor(self.bc_flat, device=r.device)
        g = torch.as_tensor(self.g_flat, device=r.device).to(r.dtype)
        return torch.where(bc, x - g, r)

    def jacobian(self, x, x_prev) -> sp.csr_matrix:
        """Exact Jacobian (float64 SciPy CSR) of `residual` at x: the
        element Jacobians from forward-mode derivatives, assembled, and
        identity rows at the Dirichlet dofs."""
        X = x.reshape(self.n, 3)[self.cells]
        Xp = x_prev.reshape(self.n, 3)[self.cells]
        cols = []
        with fwAD.dual_level():
            for k in range(9):
                tan = torch.zeros_like(X)
                tan.view(self.nc, 9)[:, k] = 1
                out = self.element_residual(fwAD.make_dual(X, tan), Xp)
                cols.append(fwAD.unpack_dual(out).tangent.reshape(self.nc, 9))
        Ae = torch.stack(cols, dim=-1).to(torch.float64).cpu().numpy()
        dof = (3 * self.cells_np[:, :, None]
               + np.arange(3)[None, None, :]).reshape(self.nc, 9)
        rows = np.repeat(dof, 9, axis=1).reshape(-1)
        colidx = np.tile(dof, (1, 9)).reshape(-1)
        N = 3 * self.n
        A = sp.csr_matrix((Ae.reshape(-1), (rows, colidx)), shape=(N, N))
        keep = sp.diags((~self.bc_flat).astype(np.float64))
        ident = sp.diags(self.bc_flat.astype(np.float64))
        return (keep @ A + ident).tocsc()

    # ------------------------------------------------------------------
    def flat(self, u, p):
        """The flat state (torch, this problem's dtype) of u (n, 2), p (n,)
        given as NumPy arrays."""
        x = np.concatenate([np.asarray(u, np.float64).reshape(self.n, 2),
                            np.asarray(p, np.float64).reshape(self.n, 1)],
                           axis=1).reshape(-1)
        return torch.as_tensor(x, device=self.device).to(self.dtype)

    @staticmethod
    def split(x):
        a = x.to(torch.float64).cpu().numpy().reshape(-1, 3)
        return a[:, :2].copy(), a[:, 2].copy()

    def step(self, u_prev, p_prev, max_it=20, rtol=1e-13):
        """One time step from (u_prev, p_prev): Newton's method started at
        the previous state, as the program starts it, with the exact
        Jacobian factored (SciPy's sparse LU) at the start and again
        whenever an update shrinks by less than a factor 10 (a chord
        iteration that slows down), until the update falls under rtol of
        the state or stops shrinking. Returns (u, p, factorizations)."""
        xp = self.flat(u_prev, p_prev)
        x = xp.clone()
        solve_dtype = (np.float64 if self.dtype == torch.float64
                       else np.float32)
        lu, factored, last = None, 0, np.inf
        for _ in range(max_it):
            if lu is None:
                t0 = time.perf_counter()
                A = self.jacobian(x, xp).astype(solve_dtype)
                t1 = time.perf_counter()
                lu = spla.splu(A)
                self.seconds["jacobian"] += t1 - t0
                self.seconds["factor"] += time.perf_counter() - t1
                factored += 1
            t0 = time.perf_counter()
            r = self.residual(x, xp).to(torch.float64).cpu().numpy()
            self.seconds["residual"] += time.perf_counter() - t0
            dx = lu.solve(-r.astype(solve_dtype)).astype(np.float64)
            x = (x.to(torch.float64)
                 + torch.as_tensor(dx, device=x.device)).to(self.dtype)
            size = float(np.abs(dx).max())
            if size <= rtol * float(x.abs().max()) or size >= last:
                break
            if size > 0.1 * last:
                lu = None
            last = size
        u, p = self.split(x)
        return u, p, factored
