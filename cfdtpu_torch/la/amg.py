"""Aggregation multigrid: scalar (the SELFP Schur stage) and node-block
(BlockAMG, the velocity block A_uu).

The counterpart of cfdtpu/la/amg.py: plain (unsmoothed) aggregation
with piecewise-constant transfer, Galerkin coarse operators, l1-Jacobi
or Chebyshev smoothing (or, on BlockAMG's finest level, an optional RAS
smoother), a dense coarsest inverse, and the V-, W- and K-cycle. The
aggregates and every index map are built once in numpy, exactly as in
cfdtpu.

Kernels: level matvecs are K1 (sup_spmv) at supernode width g=8 (g*d
for the node-block levels), with its epilogues fusing the l1-Jacobi
update and the pre-restriction residual; restriction and Galerkin value
coarsening are K2 (ell_sum) over SortedScatter maps of the aggregates
and of the coarse entry map (width d and d*d for the block variants);
the RAS smoother is K6 (ras_apply) with its x + RAS(r) epilogue. The
coarse-grid correction x + P xc is never stored: the first post-smooth's
K1 launch reads it in its gather (K1's prolong option, K8's expression),
and on BlockAMG's finest level with the RAS smoother that launch also
writes it, for K6 to add to. The first l1-Jacobi pre-smooth from x0 = 0,
x = omega b / d, is never stored at n_smooth = 1 either: the level's
residual is K1 on b with the input scale s = omega / d (kept per level
in the built state) and the correction's base is s b. The coarsest
solve is a dense inverse. On the CPU the plain versions run K8's and
K1's in that order, as the cycle did before the fusion.

Chebyshev smoothing (cheby_degree > 0) replaces l1-Jacobi on every level
but a RAS one, on [0.25, 1.05] lambda_max(D_l1^-1 A) per level, lambda
power-iterated at build (la/chebyshev.py; n_smooth then has no say, as
in cfdtpu): each step is one K1 launch in its cheby mode, the first
pre-smoothing step x = w b K1's input scale (never stored), the first
post-smoothing step the launch that reads x + P xc in its gather.

The W-cycle (gamma = 2) visits a coarse level twice, x1 + descend(rc -
A x1); its sum is no launch of its own: K1's `add` option adds x1 in
the epilogue of the second visit's last launch, one rounding of x2 + x1
after x2's own, which is the reference's x1 + x2 bit for bit in float64
(the addition commutes exactly), and the parent's gather reads one
coarse vector as in the V-cycle. The K-cycle (kcycle, on coarse levels
k >= 1, nonlinear in b) is cfdtpu's _gcr2 with the level's cycle as
preconditioner: two K1 products and K11's two launches. Not ported:
the weighted p-multigrid level (PLevel); linear_parents raises
NotImplementedError.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.amg_gcr2 import gcr2_first, gcr2_second
from ..kernels.amg_prolong import amg_prolong
from ..kernels.sup_spmv import sup_spmv
from ..utils.geometry import SortedScatter
from .chebyshev import cheby_coeffs, cheby_scale, estimate_lambda_max
from .superell import SuperMaps, place

# the Chebyshev smoothers' interval [CHEB_FRAC, 1] * lambda_max
CHEB_FRAC = 0.25


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
    entry ids); x + P xc alone is K8 (prolong_add), which the V-cycles
    leave to K1's prolong option. `agg` is int32 on the device."""

    __slots__ = ("agg", "n_coarse", "_restrict", "_coarsen",
                 "row", "col", "n", "_coarse_coo")

    def __init__(self, row, col, n, agg_row=None, agg_col=None,
                 pairwise=False, *, device):
        self.row, self.col, self.n = row, col, n
        if agg_row is None:
            agg_row, agg_col = row, col
        agg = build_aggregates(agg_row, agg_col, n, pairwise=pairwise)
        self.n_coarse = int(agg.max()) + 1
        self.agg = torch.as_tensor(agg.astype(np.int32), device=device)
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

    def prolong_add(self, xc, x, width: int = 1, scale=None):
        """x + P xc (scale * x + P xc with scale), one K8 launch: cfdtpu's
        x + prolong(xc), or x + prolong_block(xc, d) at width d for
        node-block vectors."""
        return amg_prolong(xc, self.agg, width, x, scale)

    # node-block variants: (nnz, d, d) blocks sum wholesale, (n*d,)
    # vectors are component-major per node
    def coarsen_block_vals(self, vals):
        return self._coarsen(vals)

    def restrict_block(self, r, d):
        return self._restrict(r.reshape(-1, d)).reshape(-1)


class AMG:
    """Multilevel hierarchy on a scalar COO operator (sorted by row).

    build(vals) -> per-level values; v_cycle(built, r) -> z."""

    width = 1  # values a node carries (BlockAMG: d)

    def __init__(self, row: np.ndarray, col: np.ndarray, n: int,
                 coarse_size: int = 800, max_levels: int = 6,
                 omega: float = 0.67, n_smooth: int = 1,
                 agg_row: np.ndarray | None = None,
                 agg_col: np.ndarray | None = None,
                 pairwise: bool = False, kcycle: bool = False,
                 cheby_degree: int = 0, wcycle: bool = False,
                 linear_parents=None, *, device):
        """row/col: COO graph of the operator. agg_row/agg_col: optional
        sparser graph to aggregate on (the distance-1 node graph for the
        distance-2 SELFP matrix keeps aggregates at ~7 nodes)."""
        if linear_parents is not None:
            raise NotImplementedError(
                "the weighted p-multigrid level (PLevel) is not ported")
        self.kcycle, self.cheby_degree, self.wcycle = False, 0, False
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
        """The cycle's options, mutable on a cached hierarchy (as cfdtpu's
        factories flip them); None leaves a setting as it is. kcycle: the
        K-cycle's GCR(2) coarse corrections (nonlinear in b; v_cycle's
        kcycle=False forces a linear cycle per call); wcycle: gamma = 2;
        cheby: the Chebyshev smoothers' degree, 0 for l1-Jacobi (a
        change needs a new build: lambda is computed there)."""
        if kcycle is not None:
            self.kcycle = bool(kcycle)
        if cheby is not None:
            self.cheby_degree = int(cheby)
        if wcycle is not None:
            self.wcycle = bool(wcycle)

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

    def _level(self, k, ev, cheby: bool):
        """(sup values, l1 diagonal, omega / diagonal, Chebyshev data):
        with cheby, (lambda_max of D_l1^-1 A, a (1,) tensor, and the
        sweep's scale w = cheby_scale(1 / d, lambda, CHEB_FRAC)), else
        None."""
        d = self._l1_diag(k, ev)
        cheb = None
        if cheby:
            inv = 1.0 / d
            lam = estimate_lambda_max(
                lambda v, _k=k, _ev=ev: self._matvec(_k, _ev, v), inv)
            cheb = (lam, cheby_scale(inv, lam, CHEB_FRAC))
        return ev, d, self.omega / d, cheb

    def build(self, vals):
        """Galerkin-coarsen the values, precompute the l1 smoothing
        diagonals (and the Chebyshev scales) and the dense inverse of the
        coarsest level; returns (per-level _level tuples, coarsest
        inverse)."""
        out = []
        for k, lvl in enumerate(self.levels):
            out.append(self._level(k, self._place(k, vals),
                                   self.cheby_degree > 0))
            vals = lvl.coarsen_vals(vals)
        m = self.n_coarsest
        A = torch.zeros((m * m,), dtype=vals.dtype, device=vals.device)
        A[self._coarse_rc] = vals
        A = A.reshape(m, m)
        A = A + 1e-12 * torch.max(torch.abs(vals)) * torch.eye(
            m, dtype=vals.dtype, device=vals.device)
        # dense inverse: the coarsest solve is then one matvec per cycle
        return out, torch.linalg.inv(A)

    def _matvec(self, k, sup_vals, x, mode="y", b=None, d=None, **kw):
        """Level-k y = A x (K1, width g * self.width), or with K1's
        epilogues: mode "residual" gives b - A x, mode "jacobi" x +
        omega (b - A x) / d, mode "cheby" a Chebyshev step (cheb, d_out);
        scale reads x as scale * x, prolong = (xc, agg, width) as that
        plus P xc (xhat_out receives it), add is added to the result."""
        maps, _ = self.sup[k]
        return sup_spmv(sup_vals, maps.sup_cols, x,
                        n_out=maps.n * self.width, mode=mode, b=b, d=d,
                        omega=self.omega, **kw)

    def _l1_diag(self, k, sup_vals):
        """l1-Jacobi smoothing diagonal d_i = sum_j |A_ij| (a plain
        reduction over the supernode values)."""
        maps, _ = self.sup[k]
        d = torch.sum(torch.abs(sup_vals), dim=(1, 3)).reshape(-1)
        return torch.clamp(d[: maps.n * self.width], min=1e-30)

    def _restrict(self, k, r):
        return self.levels[k].restrict(r)

    def v_cycle(self, built, b, kcycle=None):
        """One cycle for A x = b, x0 = 0: V(n_smooth, n_smooth), or W
        (wcycle), or K (the hierarchy's kcycle, or this call's; pass
        kcycle=False wherever the result must be linear in b), with
        l1-Jacobi or Chebyshev smoothing."""
        return self._cycle(built[0], built[1], None, b, kcycle)

    def _cycle(self, level_vals, coarse_inv, ras_inv, b, kcycle):
        nl = len(self.levels)
        kc = self.kcycle if kcycle is None else kcycle
        w = self.width
        mv = self._matvec
        ras = self.fine_smoother if ras_inv is not None else None
        coeffs = cheby_coeffs(self.cheby_degree, CHEB_FRAC)

        def jacobi_sweeps(k, x, b, n, add=None, **first):
            """n l1-Jacobi (or, with RAS, RAS) sweeps; `first` goes to
            the first launch (scale, prolong), add to the last's output."""
            vals, d = level_vals[k][:2]
            for i in range(n):
                a = add if i == n - 1 else None
                kw = first if i == 0 else {}
                if k == 0 and ras is not None:
                    r = mv(k, vals, x, mode="residual", b=b, **kw)
                    x = ras.apply(ras_inv, r, base=x)
                else:
                    x = mv(k, vals, x, mode="jacobi", b=b, d=d, add=a, **kw)
            return x

        def cheb_steps(k, x, b, steps, add=None, **first):
            """K1 launches in cheby mode with the (a, c) of `steps`, each
            on the previous one's x and d; `first` goes to the first
            launch (scale: x read as scale * x and d taken as that;
            prolong), add to the last's output."""
            vals, _, _, (_, ws) = level_vals[k]
            d = None
            for i, (a, c) in enumerate(steps):
                last = i == len(steps) - 1
                d_out = None if last else torch.empty_like(b)
                kw = first if i == 0 else {}
                x = mv(k, vals, x, mode="cheby", b=b,
                       cheb=(ws, d, a, c), d_out=d_out,
                       add=add if last else None, **kw)
                d = d_out
            return x

        def csolve(k, rc):
            """The coarse-level correction at level k."""
            if k == nl:
                return descend(k, rc)
            vals = level_vals[k][0]
            if kc:
                # the K-cycle: GCR(2) preconditioned by this level's cycle
                z1 = descend(k, rc)
                q1 = mv(k, vals, z1)
                r, coef = gcr2_first(q1, rc)
                z2 = descend(k, r)
                return gcr2_second(q1, mv(k, vals, z2), z1, z2, r, coef)
            if self.wcycle:
                # gamma = 2, linear in b; x1 + x2 in the second visit's
                # last launch
                x1 = descend(k, rc)
                return descend(k, mv(k, vals, x1, mode="residual", b=rc),
                               add=x1)
            return descend(k, rc)

        def descend(k, b, add=None):
            """x ~ A_k^-1 b from x0 = 0; with add, x + add (k >= 1)."""
            if k == nl:
                return coarse_inv @ b
            vals, d, s, cheb = level_vals[k]
            lvl = self.levels[k]
            # pre-smooth: the iterate is `base`, read as scale * base
            scale = None
            if k == 0 and ras is not None:
                base = ras.apply(ras_inv, b)  # pre-smooth from x0 = 0
                base = jacobi_sweeps(k, base, b, self.n_smooth - 1)
            elif cheb is not None:
                # x0 = w b, never stored: read through K1's input scale
                base, scale = b, cheb[1]
                if coeffs:
                    base = cheb_steps(k, b, b, coeffs, scale=scale)
                    scale = None
            elif self.n_smooth == 1:
                # x = s b (s = omega / d), read through K1's scale, never
                # stored
                base, scale = b, s
            else:
                base = jacobi_sweeps(k, b, b, self.n_smooth - 1, scale=s)
            r = mv(k, vals, base, mode="residual", b=b, scale=scale)
            xc = csolve(k + 1, self._restrict(k, r))
            # the first post-smooth reads x + P xc in its gather
            pro = dict(prolong=(xc, lvl.agg, w), scale=scale)
            if k == 0 and ras is not None:
                # its residual launch also stores x + P xc, to which K6
                # adds RAS(r)
                xhat = torch.empty_like(base)
                r = mv(k, vals, base, mode="residual", b=b, xhat_out=xhat,
                       **pro)
                x = ras.apply(ras_inv, r, base=xhat)
                return jacobi_sweeps(k, x, b, self.n_smooth - 1)
            if cheb is not None:
                # x + cheb(b - A x): its first step x + w (b - A x) (a = 0,
                # c = 1) reads x + P xc
                return cheb_steps(k, base, b, [(0.0, 1.0), *coeffs],
                                  add=add, **pro)
            return jacobi_sweeps(k, base, b, self.n_smooth, add=add, **pro)

        return descend(0, b)


class BlockAMG(AMG):
    """Node-block (d x d) aggregation AMG for the velocity block A_uu.

    The same plain-aggregation hierarchy as the scalar AMG (aggregates
    and Galerkin entry maps from the node graph, built once) with
    (d x d) block values: block Galerkin coarsening, block l1-Jacobi
    smoothing (row sums of |A_ij| per component row), and a dense
    coarsest inverse over node blocks. fine_smoother: an optional
    la/ras.RASPrecond used as the finest-level smoother (coarser levels
    keep l1-Jacobi or Chebyshev).

    Vectors are (n*d,) flat, component-major per node (the solver's u
    layout).
    """

    def __init__(self, row, col, n, d: int, coarse_size: int = 400,
                 fine_smoother=None, **kw):
        self.d = self.width = int(d)
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
        (per-level _level tuples, coarsest inverse, RAS window inverses
        or None); no Chebyshev data on a RAS level."""
        d = self.d
        ras_inv = (self.fine_smoother.build(vals)
                   if self.fine_smoother is not None else None)
        out = []
        for k, lvl in enumerate(self.levels):
            cheby = self.cheby_degree > 0 and not (k == 0
                                                   and ras_inv is not None)
            out.append(self._level(k, self._place_block(k, vals), cheby))
            vals = lvl.coarsen_block_vals(vals)
        m = self.n_coarsest
        A = torch.zeros((m * m, d, d), dtype=vals.dtype, device=vals.device)
        A[self._coarse_rc] = vals
        # (row node, col node, i, j) -> rows (node, i), cols (node, j)
        A = A.reshape(m, m, d, d).permute(0, 2, 1, 3).reshape(m * d, m * d)
        A = A + 1e-12 * torch.max(torch.abs(vals)) * torch.eye(
            m * d, dtype=vals.dtype, device=vals.device)
        return out, torch.linalg.inv(A), ras_inv

    def _restrict(self, k, r):
        return self.levels[k].restrict_block(r, self.d)

    def v_cycle(self, built, b, kcycle=None):
        return self._cycle(built[0], built[1], built[2], b, kcycle)
