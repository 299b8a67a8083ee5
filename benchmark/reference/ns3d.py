"""Plain reference of one time step of the stabilised Navier-Stokes
equations on P1 tetrahedra.

The equations of benchmark/reference/ns.py in three dimensions:
Crank-Nicolson midpoint in time; Galerkin terms with SUPG, PSPG and LSIC
stabilisation (Tezduyar's tau from the previous velocity, the element
size h the longest edge); the natural-correction term `(p n - mu (grad
u_m)^T n) . v` on every boundary facet; the velocity's Dirichlet values
and p = 0 on the nodes that the problem gives (benchmark/problems).
Integrals use a 14-point rule of degree 5 on the tetrahedra (Walkington
2000) and the 6-point degree-4 rule of Dunavant (1985) on the
triangular facets.

Everything is worked out from the inputs the benchmark makes (the mesh
arrays, the physical parameters, the boundary data and a state), with
plain torch tensor operations on `device`: the dofmaps, the geometry,
the Dirichlet rows, the residual, its exact Jacobian (forward-mode
derivatives of the element residuals, 16 tangents, assembled as a torch
sparse CSR matrix from its 4 x 4 node blocks) and Newton's method to the
rounding floor. Each linear solve is unrestarted GMRES (Arnoldi with
classical Gram-Schmidt done twice), right-preconditioned by the inverse
4 x 4 node-block diagonal of the Jacobian, to a relative residual of
1e-10 (float64 solves) or 1e-5 (float32 solves), at most MAX_IT
iterations; a solve that reaches the cap returns NaN, so that a loose
reference fails the comparison instead of passing it. `solver="lu"`
solves with SciPy's sparse LU on the host instead (the tests check the
GMRES path against it at small sizes). `dtype` selects the arithmetic of
the residual, the Jacobian and the state: float64 for the reference;
float32 or bfloat16 for the control, where the solves run in float32.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from benchmark.reference.ns import QUAD_W as TRI_W
from benchmark.reference.ns import QUAD_XI as TRI_XI

# Walkington's 14-point rule of degree 5: barycentric points (the first
# three coordinates) and weights (sum 1/6)
_A1, _B1 = 0.0673422422100983, 0.3108859192633005
_A2, _B2 = 0.7217942490673264, 0.0927352503108912
_A3, _B3 = 0.4544962958743506, 0.0455037041256494
_W1, _W2, _W3 = (0.1126879257180162 / 6, 0.0734930431163619 / 6,
                 0.0425460207770812 / 6)
QUAD_XI = np.array(
    [[_A1, _B1, _B1], [_B1, _A1, _B1], [_B1, _B1, _A1], [_B1, _B1, _B1],
     [_A2, _B2, _B2], [_B2, _A2, _B2], [_B2, _B2, _A2], [_B2, _B2, _B2],
     [_A3, _A3, _B3], [_A3, _B3, _A3], [_B3, _A3, _A3],
     [_A3, _B3, _B3], [_B3, _A3, _B3], [_B3, _B3, _A3]])
QUAD_W = np.array([_W1] * 4 + [_W2] * 4 + [_W3] * 6)
# reference gradients of the P1 basis, local vertex order 0..3
DPHI = np.array([[-1.0, -1.0, -1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                 [0.0, 0.0, 1.0]])
MAX_IT = 3000
RTOL = {torch.float64: 1e-10, torch.float32: 1e-5}
CHUNK = 128  # Krylov vectors a block of the basis


def p1_values(xi):
    """P1 basis values at reference points xi (n, 3): (n, 4)."""
    xi = np.asarray(xi, dtype=np.float64)
    return np.column_stack([1 - xi.sum(axis=1), xi])


def gmres(matvec, prec, b, rtol, max_it):
    """x with |b - A x| <= rtol |b| for A = matvec, right-preconditioned
    by prec, unrestarted, and the iterations taken; x is NaN where
    max_it iterations do not get there."""
    beta = float(torch.linalg.vector_norm(b))
    if beta == 0.0:
        return torch.zeros_like(b), 0
    n = b.shape[0]
    blocks = []  # the basis, CHUNK vectors a block

    def basis(j):
        """The first j basis vectors, block by block."""
        out, left = [], j
        for blk in blocks:
            m = min(left, CHUNK)
            if m <= 0:
                break
            out.append(blk[:m])
            left -= m
        return out

    def put(j, v):
        if j % CHUNK == 0:
            blocks.append(torch.empty((CHUNK, n), dtype=b.dtype,
                                      device=b.device))
        blocks[j // CHUNK][j % CHUNK] = v

    H = np.zeros((max_it + 1, max_it))
    cs, sn = np.zeros(max_it), np.zeros(max_it)
    g = np.zeros(max_it + 1)
    g[0] = beta
    put(0, b / beta)
    k, done = 0, False
    for j in range(max_it):
        w = matvec(prec(blocks[j // CHUNK][j % CHUNK]))
        V = basis(j + 1)
        h = torch.zeros(j + 1, dtype=b.dtype, device=b.device)
        for _ in range(2):
            hs = torch.cat([blk @ w for blk in V])
            off = 0
            for blk in V:
                w = w - hs[off:off + blk.shape[0]] @ blk
                off += blk.shape[0]
            h = h + hs
        hn = float(torch.linalg.vector_norm(w))
        col = np.append(h.double().cpu().numpy(), hn)
        for i in range(j):
            a, c = col[i], col[i + 1]
            col[i], col[i + 1] = cs[i] * a + sn[i] * c, -sn[i] * a + cs[i] * c
        r = np.hypot(col[j], col[j + 1])
        cs[j], sn[j] = (col[j] / r, col[j + 1] / r) if r > 0 else (1.0, 0.0)
        col[j], col[j + 1] = r, 0.0
        g[j + 1] = -sn[j] * g[j]
        g[j] = cs[j] * g[j]
        H[: j + 2, j] = col
        k = j + 1
        if abs(g[j + 1]) <= rtol * beta or hn == 0.0:
            done = True
            break
        put(j + 1, w / hn)
    y = np.linalg.solve(np.triu(H[:k, :k]), g[:k])
    yt = torch.as_tensor(y, device=b.device).to(b.dtype)
    z = torch.zeros_like(b)
    off = 0
    for blk in basis(k):
        z = z + yt[off:off + blk.shape[0]] @ blk
        off += blk.shape[0]
    x = prec(z)
    if not done:
        x = torch.full_like(b, float("nan"))
    return x, k


class Problem:
    """The discrete problem of one cell: its geometry and boundary data
    in float64 NumPy, the residual and the Jacobian in `dtype` on
    `device`.

    mesh: dict with points (n, 3), cells (nc, 4), facets (nf, 3) (every
    boundary facet) and facet_cells (nf,); phys: rho, mu, dt, eps (the
    division guard of tau, the configuration's float resolution); bc_u
    (n,) the nodes whose velocity is given, g (n, 3) its values there;
    bc_p (n,) the nodes whose pressure is 0; solver "gmres" (on
    `device`) or "lu" (SciPy, on the host).
    """

    def __init__(self, mesh, phys, bc_u, g, bc_p, device="cpu",
                 dtype=torch.float64, solver="gmres"):
        self.device = torch.device(device)
        self.dtype = dtype
        self.solver = solver
        x = np.asarray(mesh["points"], dtype=np.float64)
        cells = np.asarray(mesh["cells"], dtype=np.int64)
        self.n = n = len(x)
        self.nc = nc = len(cells)
        self.rho, self.mu = float(phys["rho"]), float(phys["mu"])
        self.dt = float(phys["dt"])
        self.eps = float(phys["eps"])

        xc = x[cells]                                   # (nc, 4, 3)
        J = np.einsum("cvg,vd->cgd", xc, DPHI)          # dx_g / dxi_d
        det = np.linalg.det(J)
        invJ = np.linalg.inv(J)                         # dxi_d / dx_g
        grad = np.einsum("bd,cdg->cbg", DPHI, invJ)     # (nc, 4, 3)
        h = np.zeros(nc)
        for a in range(4):
            for b in range(a + 1, 4):
                h = np.maximum(h, np.linalg.norm(xc[:, a] - xc[:, b],
                                                 axis=1))
        phi = p1_values(QUAD_XI)                        # (14, 4)
        wdet = QUAD_W[None, :] * np.abs(det)[:, None]   # (nc, 14)

        # the natural correction on every boundary facet, as a term of
        # the cell that holds the facet
        facets = np.asarray(mesh["facets"], dtype=np.int64)
        fcells = np.asarray(mesh["facet_cells"], dtype=np.int64)
        fx = x[facets]                                  # (nf, 3, 3)
        cr = np.cross(fx[:, 1] - fx[:, 0], fx[:, 2] - fx[:, 0])
        area2 = np.linalg.norm(cr, axis=1)              # twice the area
        normal = cr / area2[:, None]
        inward = x[cells[fcells]].mean(axis=1) - fx.mean(axis=1)
        if np.any((normal * inward).sum(axis=1) > 0):
            raise ValueError("boundary facets are not oriented outward")
        # P1 values of the cell's four basis functions at the facet's
        # points: the facet's barycentric coordinates, 0 for the vertex
        # opposite the facet
        lam = np.column_stack([1 - TRI_XI.sum(axis=1), TRI_XI])  # (6, 3)
        loc = (cells[fcells][:, :, None] == facets[:, None, :])  # (nf,4,3)
        fphi = np.einsum("fbk,qk->fbq", loc.astype(np.float64), lam)
        fdS = TRI_W[None, :] * area2[:, None]           # (nf, 6)

        bc_u = np.asarray(bc_u, dtype=bool)
        bc_p = np.asarray(bc_p, dtype=bool)
        g = np.asarray(g, dtype=np.float64)
        self.bc_u, self.bc_p, self.g = bc_u, bc_p, g
        # flat node-interleaved layout: dof 4 i + c, c = u_x, u_y, u_z, p
        self.bc_flat = np.column_stack([bc_u, bc_u, bc_u, bc_p]).reshape(-1)
        self.g_flat = np.column_stack([g, np.zeros(n)]).reshape(-1)
        self.cells_np = cells
        # seconds spent in each part of step(), and each solve's
        # iterations, for the run's record
        self.seconds = {"jacobian": 0.0, "solve": 0.0, "residual": 0.0,
                        "iterations": []}

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float64),
                                   device=self.device).to(dtype)

        dev = self.device
        self.cells = torch.as_tensor(cells, device=dev)
        self.grad, self.h, self.wdet, self.phi = t(grad), t(h), t(wdet), \
            t(phi)
        self.fcells = torch.as_tensor(fcells, device=dev)
        self.fgrad = self.grad[self.fcells]
        self.fphi, self.fdS, self.normal = t(fphi), t(fdS), t(normal)
        self.bc = torch.as_tensor(self.bc_flat, device=dev)
        self.gvals = torch.as_tensor(self.g_flat, device=dev)
        self._pattern()

    def _pattern(self):
        """The Jacobian's node-block sparsity: each cell's 16 (row node,
        column node) pairs mapped to the distinct pairs (sorted by row,
        then column), and the CSR layout of their 4 x 4 blocks."""
        dev, n = self.device, self.n
        c = self.cells
        key = (c[:, :, None] * n + c[:, None, :]).reshape(-1)
        uniq, self.pair_of = torch.unique(key, return_inverse=True)
        self.nb = nb = uniq.shape[0]
        brow, bcol = uniq // n, uniq % n
        count = torch.bincount(brow, minlength=n)
        start = torch.cumsum(count, 0) - count
        k = torch.arange(nb, device=dev)
        i = torch.arange(4, device=dev)
        # block k's value (i, j) goes to row 4 brow + i of the CSR matrix,
        # at place 4 (k - start) + j of that row
        dst = (16 * start[brow][:, None, None]
               + 4 * count[brow][:, None, None] * i[None, :, None]
               + 4 * (k - start[brow])[:, None, None] + i[None, None, :])
        self.csr_dst = dst.reshape(-1)
        col = (4 * bcol[:, None, None] + i[None, None, :]).expand(
            nb, 4, 4).reshape(-1)
        self.csr_col = torch.empty_like(col)
        self.csr_col[self.csr_dst] = col
        rows = torch.repeat_interleave(4 * count, 4)
        self.csr_crow = torch.cat([torch.zeros(1, dtype=torch.int64,
                                               device=dev),
                                   torch.cumsum(rows, 0)])
        self.diag_block = torch.nonzero(brow == bcol).reshape(-1)
        # the Dirichlet rows of each block: (nb, 4, 1), 1 where the row is
        # a Dirichlet dof
        self.block_bc = self.bc.reshape(n, 4)[brow][:, :, None]
        self.diag_bc = self.bc.reshape(n, 4)

    # ------------------------------------------------------------------
    def element_residual(self, xe, xe_prev):
        """Element residuals (nc, 4, 4) of the element unknowns xe (nc,
        4, 4): per vertex (u_x, u_y, u_z, p); xe_prev the previous
        state's."""
        rho, mu, dt = self.rho, self.mu, self.dt
        nu = mu / rho
        phi, gr, wdet, h = self.phi, self.grad, self.wdet, self.h
        u_e, p_e = xe[..., :3], xe[..., 3]
        up_e = xe_prev[..., :3]
        u_q = torch.einsum("qb,cbi->cqi", phi, u_e)
        up_q = torch.einsum("qb,cbi->cqi", phi, up_e)
        um_q = 0.5 * (u_q + up_q)
        grad_um = torch.einsum("cbi,cbg->cig", 0.5 * (u_e + up_e), gr)
        p_q = torch.einsum("qb,cb->cq", phi, p_e)
        grad_p = torch.einsum("cb,cbg->cg", p_e, gr)
        div_um = torch.diagonal(grad_um, dim1=1, dim2=2).sum(-1)  # (nc,)
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
        sym = mu * (grad_um + grad_um.transpose(1, 2))          # (nc, 3, 3)

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
        g_um = torch.einsum("fbi,fbg->fig", 0.5 * (fx[..., :3]
                                                   + fxp[..., :3]),
                            self.fgrad)
        gtn = torch.einsum("fjg,fj->fg", g_um, self.normal)      # (nf, 3)
        p_f = torch.einsum("fbq,fb->fq", self.fphi, fx[..., 3])
        term = (p_f[..., None] * self.normal[:, None, :]
                - mu * gtn[:, None, :])                          # (nf,q,3)
        ru_f = torch.einsum("fq,fbq,fqi->fbi", self.fdS, self.fphi, term)
        ru = torch.index_add(ru, 0, self.fcells, ru_f)
        return torch.cat([ru, rp[..., None]], dim=-1)

    def residual(self, x, x_prev):
        """Assembled residual (4 n,) in the flat layout, Dirichlet rows
        replaced by x - g."""
        X = x.reshape(self.n, 4)
        re = self.element_residual(X[self.cells], x_prev.reshape(
            self.n, 4)[self.cells])
        r = torch.zeros(self.n, 4, dtype=re.dtype, device=re.device)
        r = r.index_add(0, self.cells.reshape(-1), re.reshape(-1, 4))
        r = r.reshape(-1)
        return torch.where(self.bc, x - self.gvals.to(r.dtype), r)

    def jacobian_blocks(self, x, x_prev, solve_dtype):
        """The exact Jacobian of `residual` at x as (nb, 4, 4) node
        blocks in solve_dtype: the element Jacobians from forward-mode
        derivatives, summed over the cells, with identity rows at the
        Dirichlet dofs."""
        X = x.reshape(self.n, 4)[self.cells]
        Xp = x_prev.reshape(self.n, 4)[self.cells]
        cols = []
        with fwAD.dual_level():
            for k in range(16):
                tan = torch.zeros_like(X)
                tan.view(self.nc, 16)[:, k] = 1
                out = self.element_residual(fwAD.make_dual(X, tan), Xp)
                cols.append(fwAD.unpack_dual(out).tangent.reshape(
                    self.nc, 16).to(solve_dtype))
        # Ae[c, 4 a + i, 4 b + j] -> the block of node pair (a, b)
        Ae = torch.stack(cols, dim=-1).reshape(self.nc, 4, 4, 4, 4)
        Ae = Ae.permute(0, 1, 3, 2, 4).reshape(-1, 4, 4)
        del cols
        blocks = torch.zeros((self.nb, 4, 4), dtype=solve_dtype,
                             device=self.device)
        blocks.index_add_(0, self.pair_of, Ae)
        blocks = torch.where(self.block_bc, 0.0, blocks)
        eye = torch.eye(4, dtype=solve_dtype, device=self.device)
        diag = blocks[self.diag_block]
        blocks[self.diag_block] = torch.where(self.diag_bc[:, :, None],
                                              eye, diag)
        return blocks

    def csr(self, blocks):
        """The torch sparse CSR matrix of the node blocks."""
        vals = torch.empty(self.nb * 16, dtype=blocks.dtype,
                           device=blocks.device)
        vals[self.csr_dst] = blocks.reshape(-1)
        N = 4 * self.n
        with warnings.catch_warnings():  # "beta state", "checks disabled"
            warnings.simplefilter("ignore", UserWarning)
            return torch.sparse_csr_tensor(self.csr_crow, self.csr_col,
                                           vals, size=(N, N))

    def _solver(self, x, xp, solve_dtype):
        """fn(r) -> dx solving J dx = r with the Jacobian at x."""
        blocks = self.jacobian_blocks(x, xp, solve_dtype)
        A = self.csr(blocks)
        if self.solver == "lu":
            import scipy.sparse as sp
            import scipy.sparse.linalg as spla

            N = 4 * self.n
            lu = spla.splu(sp.csr_matrix(
                (A.values().cpu().numpy(), A.col_indices().cpu().numpy(),
                 A.crow_indices().cpu().numpy()), shape=(N, N)).tocsc())

            def solve_lu(r):
                out = lu.solve(r.cpu().numpy())
                return torch.as_tensor(out, device=r.device), 0

            return solve_lu
        inv = torch.linalg.inv(blocks[self.diag_block])       # (n, 4, 4)

        def prec(v):
            return torch.einsum("nij,nj->ni", inv,
                                v.reshape(self.n, 4)).reshape(-1)

        def solve_gmres(r):
            return gmres(lambda v: torch.mv(A, v), prec, r,
                         RTOL[solve_dtype], MAX_IT)

        return solve_gmres

    # ------------------------------------------------------------------
    def flat(self, u, p):
        """The flat state (torch, this problem's dtype) of u (n, 3), p (n,)
        given as NumPy arrays."""
        x = np.concatenate([np.asarray(u, np.float64).reshape(self.n, 3),
                            np.asarray(p, np.float64).reshape(self.n, 1)],
                           axis=1).reshape(-1)
        return torch.as_tensor(x, device=self.device).to(self.dtype)

    @staticmethod
    def split(x):
        a = x.to(torch.float64).cpu().numpy().reshape(-1, 4)
        return a[:, :3].copy(), a[:, 3].copy()

    def step(self, u_prev, p_prev, max_it=20, rtol=1e-13):
        """One time step from (u_prev, p_prev): Newton's method started at
        the previous state, as the program starts it, with the exact
        Jacobian built at the start and again whenever an update shrinks
        by less than a factor 10 (a chord iteration that slows down),
        until the update falls under rtol of the state or stops
        shrinking (ns.py's rule). Returns (u, p, Jacobians built)."""
        xp = self.flat(u_prev, p_prev)
        x = xp.clone()
        solve_dtype = (torch.float64 if self.dtype == torch.float64
                       else torch.float32)
        solve, built, last = None, 0, np.inf
        for _ in range(max_it):
            if solve is None:
                t0 = time.perf_counter()
                solve = self._solver(x, xp, solve_dtype)
                self.seconds["jacobian"] += time.perf_counter() - t0
                built += 1
            t0 = time.perf_counter()
            r = self.residual(x, xp).to(solve_dtype)
            self.seconds["residual"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            dx, its = solve(-r)
            dx = dx.to(torch.float64)
            self.seconds["solve"] += time.perf_counter() - t0
            self.seconds["iterations"].append(int(its))
            x = (x.to(torch.float64) + dx).to(self.dtype)
            size = float(dx.abs().max())
            if not np.isfinite(size):
                x = torch.full_like(x, float("nan"))
                break
            if size <= rtol * float(x.abs().max()) or size >= last:
                break
            if size > 0.1 * last:
                solve = None
            last = size
        u, p = self.split(x)
        return u, p, built
