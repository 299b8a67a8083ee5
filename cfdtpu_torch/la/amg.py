"""Aggregation multigrid: scalar (the SELFP Schur stage) and node-block
(BlockAMG, the velocity block A_uu).

The counterpart of cfdtpu/la/amg.py: plain (unsmoothed) aggregation
with piecewise-constant transfer, Galerkin coarse operators, l1-Jacobi
smoothing (or, on BlockAMG's finest level, an optional RAS smoother)
and a dense coarsest inverse. The aggregates and every index map are
built once in numpy, exactly as in cfdtpu.

Kernels: level matvecs are K1 (sup_spmv) at supernode width g=8 (g*d
for the node-block levels), with its epilogues fusing the l1-Jacobi
update and the pre-restriction residual; restriction and Galerkin value
coarsening are K2 (ell_sum) over SortedScatter maps of the aggregates
and of the coarse entry map (width d and d*d for the block variants);
the RAS smoother is K6 (ras_apply) with its x + RAS(r) epilogue.
Prolongation is an index gather; the coarsest solve a dense inverse.

Not ported yet: the K-cycle (_gcr2), Chebyshev smoothing, the W-cycle
and the weighted p-multigrid level (PLevel). Their flags raise
NotImplementedError when set.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.sup_spmv import sup_spmv
from ..utils.geometry import SortedScatter
from .superell import SuperMaps, place, sup_rows


def build_aggregates(row, col, n: int, pairwise: bool = False
                     ) -> np.ndarray:
    """Aggregation over the graph (row, col) -> agg id per node.

    Default (root-based): roots swallow their whole neighbourhood
    (aggregates of ~valence+1, aggressive ~7x coarsening). pairwise:
    greedy graph matching into aggregates of <= 2 (plus a second pass
    merging leftover singletons) — slower coarsening (~2x/level, more
    levels) but much better piecewise-constant interpolation quality,
    the AGMG-style trade."""
    order = np.argsort(row, kind="stable")
    row_s, col_s = row[order], col[order]
    ptr = np.searchsorted(row_s, np.arange(n + 1))
    agg = -np.ones(n, dtype=np.int64)
    n_agg = 0
    if pairwise:
        for i in range(n):
            if agg[i] >= 0:
                continue
            nbrs = col_s[ptr[i]:ptr[i + 1]]
            free = nbrs[(agg[nbrs] < 0) & (nbrs != i)]
            agg[i] = n_agg
            if len(free):
                agg[free[0]] = n_agg
            n_agg += 1
        # merge leftover singletons (matched nothing) into a neighbour
        sizes = np.bincount(agg, minlength=n_agg)
        for i in range(n):
            if sizes[agg[i]] > 1:
                continue
            nbrs = col_s[ptr[i]:ptr[i + 1]]
            others = nbrs[nbrs != i]
            if len(others):
                agg[i] = agg[others[0]]
        _, agg = np.unique(agg, return_inverse=True)
        return agg
    for i in range(n):
        if agg[i] >= 0:
            continue
        nbrs = col_s[ptr[i]:ptr[i + 1]]
        if (agg[nbrs] >= 0).any() and len(nbrs) > 1:
            continue  # near an aggregate: leave for phase 2
        agg[i] = n_agg
        agg[nbrs] = n_agg
        n_agg += 1
    for i in range(n):  # phase 2: attach leftovers to a neighbour's agg
        if agg[i] >= 0:
            continue
        nbrs = col_s[ptr[i]:ptr[i + 1]]
        owned = nbrs[agg[nbrs] >= 0]
        if len(owned):
            agg[i] = agg[owned[0]]
        else:
            agg[i] = n_agg
            n_agg += 1
    return agg


class AMGLevel:
    """One aggregation level: transfer maps and the Galerkin entry map.

    restrict and coarsen_vals (and their node-block variants) are K2
    reductions (SortedScatter over the aggregate ids and over the coarse
    entry ids); prolong is a gather."""

    __slots__ = ("agg", "n_coarse", "_restrict", "_coarsen",
                 "row", "col", "n", "_coarse_coo")

    def __init__(self, row, col, n, agg_row=None, agg_col=None,
                 pairwise=False, device="cpu"):
        self.row, self.col, self.n = row, col, n
        if agg_row is None:
            agg_row, agg_col = row, col
        agg = build_aggregates(agg_row, agg_col, n, pairwise=pairwise)
        self.n_coarse = int(agg.max()) + 1
        self.agg = torch.as_tensor(agg, device=device)
        # Galerkin P0^T A P0: fine entry (i, j) accumulates into coarse
        # entry (agg i, agg j)
        ckeys = agg[row].astype(np.int64) * self.n_coarse + agg[col]
        cuniq, cinv = np.unique(ckeys, return_inverse=True)
        crow = (cuniq // self.n_coarse).astype(np.int32)
        ccol = (cuniq % self.n_coarse).astype(np.int32)
        self._coarse_coo = (crow, ccol)
        self._restrict = SortedScatter(agg, self.n_coarse, device=device)
        self._coarsen = SortedScatter(cinv, len(cuniq), device=device)

    @property
    def coarse_coo(self):
        return self._coarse_coo

    def coarsen_vals(self, vals):
        return self._coarsen(vals)

    def restrict(self, r):
        return self._restrict(r)

    def prolong(self, xc):
        return xc[self.agg]

    # node-block variants: (nnz, d, d) blocks sum wholesale, (n*d,)
    # vectors are component-major per node
    def coarsen_block_vals(self, vals):
        return self._coarsen(vals)

    def restrict_block(self, r, d):
        return self._restrict(r.reshape(-1, d)).reshape(-1)

    def prolong_block(self, xc, d):
        return xc.reshape(-1, d)[self.agg].reshape(-1)


class AMG:
    """Multilevel hierarchy on a scalar COO operator (sorted by row).

    build(vals) -> per-level values; v_cycle(built, r) -> z."""

    def __init__(self, row: np.ndarray, col: np.ndarray, n: int,
                 coarse_size: int = 800, max_levels: int = 6,
                 omega: float = 0.67, n_smooth: int = 1,
                 agg_row: np.ndarray | None = None,
                 agg_col: np.ndarray | None = None,
                 pairwise: bool = False, kcycle: bool = False,
                 cheby_degree: int = 0, wcycle: bool = False,
                 linear_parents=None, device="cpu"):
        """row/col: COO graph of the operator. agg_row/agg_col: optional
        sparser graph to aggregate on (the distance-1 node graph for the
        distance-2 SELFP matrix keeps aggregates at ~7 nodes)."""
        if linear_parents is not None:
            raise NotImplementedError(
                "the weighted p-multigrid level (PLevel) is not ported")
        self.set_cycle(kcycle=kcycle, cheby=cheby_degree, wcycle=wcycle)
        self.device = torch.device(device)
        self.omega = omega
        self.n_smooth = int(n_smooth)
        if self.n_smooth < 1:
            raise ValueError("n_smooth must be >= 1")
        self.levels: list[AMGLevel] = []
        self.coo = []  # (row, col, n) per level, numpy row/col
        self.sup = []  # (SuperMaps, positions) per level — matvec layout
        self.g = 8  # scalar supernode width: gathered rows of 8
        r, c, m = row, col, n
        ar, ac = (agg_row, agg_col) if agg_row is not None else (r, c)
        for _ in range(max_levels):
            self.coo.append((np.asarray(r), np.asarray(c), m))
            self.sup.append(self._build_sup(r, c, m))
            if m <= coarse_size:
                break
            lvl = AMGLevel(r, c, m, agg_row=ar, agg_col=ac,
                           pairwise=pairwise, device=self.device)
            if lvl.n_coarse >= m:  # no coarsening progress
                break
            self.levels.append(lvl)
            r, c = lvl.coarse_coo
            r, c = np.asarray(r), np.asarray(c)
            m = lvl.n_coarse
            ar, ac = r, c  # coarser levels aggregate on their own graph
        self.n_coarsest = self.coo[len(self.levels)][2]
        r, c, m = self.coo[len(self.levels)]
        self._coarse_rc = torch.as_tensor(
            r.astype(np.int64) * m + c.astype(np.int64), device=self.device)

    def set_cycle(self, kcycle=None, cheby=None, wcycle=None):
        """Cycle options; only the plain V-cycle with l1-Jacobi is
        ported, so setting any of these raises."""
        if kcycle:
            raise NotImplementedError("AMG K-cycle is not ported")
        if cheby:
            raise NotImplementedError("AMG Chebyshev smoothing is not "
                                      "ported")
        if wcycle:
            raise NotImplementedError("AMG W-cycle is not ported")

    # -- per-PC-build value pass ----------------------------------------
    def _build_sup(self, r, c, m):
        """Supernode maps + scalar placement positions for one level."""
        maps = SuperMaps(r.astype(np.int64), c.astype(np.int64), m, self.g,
                         device=self.device)
        pos = torch.as_tensor(
            maps.scalar_positions(r.astype(np.int64), c.astype(np.int64)),
            device=self.device,
        )
        return maps, pos

    def _place(self, k, vals):
        """COO values -> (ns, Kg, g, g) supernode values of level k."""
        maps, pos = self.sup[k]
        g = maps.g
        return place(pos, vals, maps.ns * maps.Kg * g * g,
                     (maps.ns, maps.Kg, g, g))

    def build(self, vals):
        """Galerkin-coarsen the values, precompute the l1 smoothing
        diagonals and the dense inverse of the coarsest level; returns
        (per-level (sup values, l1 diagonal), coarsest inverse)."""
        out = []
        for k, lvl in enumerate(self.levels):
            ev = self._place(k, vals)
            out.append((ev, self._l1_diag_sup(k, ev)))
            vals = lvl.coarsen_vals(vals)
        m = self.n_coarsest
        A = torch.zeros((m * m,), dtype=vals.dtype, device=vals.device)
        A[self._coarse_rc] = vals
        A = A.reshape(m, m)
        A = A + 1e-12 * torch.max(torch.abs(vals)) * torch.eye(
            m, dtype=vals.dtype, device=vals.device)
        # dense inverse: the coarsest solve is then one matvec per cycle
        return out, torch.linalg.inv(A)

    def _matvec(self, k, sup_vals, x, mode="y", b=None, d=None):
        """Level-k y = A x (K1), or with its epilogue: mode "residual"
        gives b - A x, mode "jacobi" gives x + omega (b - A x) / d."""
        maps, _ = self.sup[k]
        return sup_spmv(sup_vals, maps.sup_cols,
                        sup_rows(x, maps.ns, maps.g), n_out=maps.n,
                        mode=mode, b=b, x=x if mode == "jacobi" else None,
                        d=d, omega=self.omega)

    def _l1_diag_sup(self, k, sup_vals):
        """l1-Jacobi smoothing diagonal d_i = sum_j |A_ij| (a plain
        reduction over the supernode values)."""
        maps, _ = self.sup[k]
        d = torch.sum(torch.abs(sup_vals), dim=(1, 3)).reshape(-1)
        return torch.clamp(d[: maps.n], min=1e-30)

    def v_cycle(self, built, b, kcycle=None):
        """One V(n_smooth, n_smooth) cycle for A x = b, x0 = 0. Only the
        plain cycle is ported: kcycle=True raises (la/schur.py passes
        kcycle=False where the cycle must stay linear)."""
        if kcycle:
            raise NotImplementedError("AMG K-cycle is not ported")
        level_vals, coarse_inv = built
        nl = len(self.levels)

        def smooth(k, vals, d, x, b, iters):
            for _ in range(iters):
                x = self._matvec(k, vals, x, mode="jacobi", b=b, d=d)
            return x

        def descend(k, b):
            if k == nl:
                return coarse_inv @ b
            vals, d = level_vals[k]
            # first pre-smooth from x0 = 0 needs no matvec: x = w b/d
            x = self.omega * b / d
            x = smooth(k, vals, d, x, b, self.n_smooth - 1)
            r = self._matvec(k, vals, x, mode="residual", b=b)
            xc = descend(k + 1, self.levels[k].restrict(r))
            x = x + self.levels[k].prolong(xc)
            return smooth(k, vals, d, x, b, self.n_smooth)

        return descend(0, b)


class BlockAMG(AMG):
    """Node-block (d x d) aggregation AMG for the velocity block A_uu.

    The same plain-aggregation hierarchy as the scalar AMG (aggregates
    and Galerkin entry maps from the node graph, built once) with
    (d x d) block values: block Galerkin coarsening, block l1-Jacobi
    smoothing (row sums of |A_ij| per component row), and a dense
    coarsest inverse over node blocks. fine_smoother: an optional
    la/ras.RASPrecond used as the finest-level smoother (coarser levels
    keep l1-Jacobi).

    Vectors are (n*d,) flat, component-major per node (the solver's u
    layout).
    """

    def __init__(self, row, col, n, d: int, coarse_size: int = 400,
                 fine_smoother=None, **kw):
        self.d = int(d)
        self.fine_smoother = fine_smoother
        super().__init__(row, col, n, coarse_size=coarse_size, **kw)
        # per-level block placement positions into (ns, Kg, g*d, g*d)
        self._bpos = []
        for k in range(len(self.levels)):
            maps, _ = self.sup[k]
            r, c, _ = self.coo[k]
            self._bpos.append(torch.as_tensor(
                maps.block_positions_uniform(
                    r.astype(np.int64), c.astype(np.int64), self.d
                ).reshape(-1), device=self.device))

    def _place_block(self, k, vals):
        maps, _ = self.sup[k]
        gd = maps.g * self.d
        return place(self._bpos[k], vals, maps.ns * maps.Kg * gd * gd,
                     (maps.ns, maps.Kg, gd, gd))

    def build(self, vals):
        """vals: (nnz, d, d) block values on the finest graph. Returns
        (per-level (sup values, l1 diagonal), coarsest inverse, RAS
        window inverses or None)."""
        d = self.d
        ras_inv = (self.fine_smoother.build(vals)
                   if self.fine_smoother is not None else None)
        out = []
        for k, lvl in enumerate(self.levels):
            ev = self._place_block(k, vals)
            out.append((ev, self._l1_diag_block(k, ev)))
            vals = lvl.coarsen_block_vals(vals)
        m = self.n_coarsest
        A = torch.zeros((m * m, d, d), dtype=vals.dtype, device=vals.device)
        A[self._coarse_rc] = vals
        # (row node, col node, i, j) -> rows (node, i), cols (node, j)
        A = A.reshape(m, m, d, d).permute(0, 2, 1, 3).reshape(m * d, m * d)
        A = A + 1e-12 * torch.max(torch.abs(vals)) * torch.eye(
            m * d, dtype=vals.dtype, device=vals.device)
        return out, torch.linalg.inv(A), ras_inv

    def _matvec_block(self, k, sup_vals, x, mode="y", b=None, dg=None):
        """Level-k (m*d,) block matvec (K1 at width g*d), with K1's
        residual / l1-Jacobi epilogues as in AMG._matvec."""
        maps, _ = self.sup[k]
        gd = maps.g * self.d
        return sup_spmv(sup_vals, maps.sup_cols,
                        sup_rows(x, maps.ns, gd), n_out=maps.n * self.d,
                        mode=mode, b=b, x=x if mode == "jacobi" else None,
                        d=dg, omega=self.omega)

    def _l1_diag_block(self, k, sup_vals):
        maps, _ = self.sup[k]
        dsum = torch.sum(torch.abs(sup_vals), dim=(1, 3)).reshape(-1)
        return torch.clamp(dsum[: maps.n * self.d], min=1e-30)

    def v_cycle(self, built, b, kcycle=None):
        if kcycle:
            raise NotImplementedError("AMG K-cycle is not ported")
        level_vals, coarse_inv, ras_inv = built
        nl = len(self.levels)
        d = self.d
        ras = self.fine_smoother

        def smooth(k, vals, dg, x, b, iters):
            if k == 0 and ras_inv is not None:
                for _ in range(iters):
                    r = self._matvec_block(k, vals, x, mode="residual", b=b)
                    x = ras.apply(ras_inv, r, base=x)  # x + RAS(r)
                return x
            for _ in range(iters):
                x = self._matvec_block(k, vals, x, mode="jacobi", b=b,
                                       dg=dg)
            return x

        def descend(k, b):
            if k == nl:
                return coarse_inv @ b
            vals, dg = level_vals[k]
            if k == 0 and ras_inv is not None:
                x = ras.apply(ras_inv, b)  # pre-smooth from x0 = 0
            else:
                x = self.omega * b / dg  # first pre-smooth from x0 = 0
            x = smooth(k, vals, dg, x, b, self.n_smooth - 1)
            r = self._matvec_block(k, vals, x, mode="residual", b=b)
            xc = descend(k + 1, self.levels[k].restrict_block(r, d))
            x = x + self.levels[k].prolong_block(xc, d)
            return smooth(k, vals, dg, x, b, self.n_smooth)

        return descend(0, b)
