"""Assembled node-blocked sparse operator (BSR) for equal-order forms.

The counterpart of cfdtpu/la/nodebsr.py: each coupled node pair (r, c)
owns one dense (dim+1)x(dim+1) block [[A_uu, A_up], [A_pu, A_pp]].
The layout of the applies follows the block (supernode_g, cfdtpu's two
branches; None picks by the block):
- g = 1, the default on 4 x 4 blocks (P1 tetrahedra, d = 3): the
  assembled blocks themselves in block-CSR order (a row pointer beside
  the block columns), cfdtpu's per-node branch without its padding to
  the widest row. A 16 x 16 supernode slot of g = 4 would hold 2.7 of
  its 16 node blocks on the DFG 3D mesh.
- g > 1, the default g = 4 on 3 x 3 blocks (triangles): the blocks
  placed into the (ns, Kg, g*bs, g*bs) supernode-ELL layout of
  la/superell.py. g = 1 there raises: a 3 x 3 float32 block row is 12
  bytes, off the 16-byte chunks the node-block kernel reads.
Static structure is numpy, built once from the mesh.

Kernels on this path: assembly reduces element blocks with K2
(ell_sum); every operator apply — the full matrix, the fieldsplit
sub-blocks and the fused SELFP p-column — is one launch of K1: its
node-block mode (bsr_spmv) on the block values at g = 1, sup_spmv on a
strided view of the supernode array at g > 1; the SELFP values are K4
(selfp_triple) reduced by K2. The velocity-block hooks (uu_vals,
uu_amg, uu_ras) serve the *_up / *_sup methods of la/schur.py; the
node-block Jacobi preconditioner (uu_block_jacobi) is K10, its inverses
and its applies.

Not ported yet: pp_amg, bbt_vals and the PCD p-scatter.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.block_jacobi import block_jacobi, block_jacobi_inv
from ..kernels.bsr_spmv import bsr_spmv
from ..kernels.selfp_triple import selfp_triple
from ..kernels.sup_spmv import sup_spmv
from ..utils.geometry import SortedScatter
from .superell import SuperMaps, place


def resolve_supernode_g(dim: int, supernode_g=None) -> int:
    """The layout's g: by the node block where None is given (1 on the
    4 x 4 blocks of d = 3, 4 on the 3 x 3 of d = 2), else the value
    given (0 reads as 1). g = 1 below d = 3 raises NotImplementedError."""
    if supernode_g is None:
        return 1 if dim == 3 else 4
    g = int(supernode_g) if supernode_g else 1
    if g == 1 and dim != 3:
        raise NotImplementedError(
            f"the node-block layout (supernode_g=1) is built for 4 x 4 "
            f"blocks (d = 3); at d = {dim} a float32 block row of "
            f"{(dim + 1) * 4} bytes is off the kernel's 16-byte chunks: "
            f"use supernode_g > 1"
        )
    return g


class NodeBSR:
    def __init__(self, form, supernode_g: int | None = None):
        V, Q = form.V, form.Q
        if not np.array_equal(np.asarray(V.dofmap), np.asarray(Q.dofmap)):
            raise ValueError(
                "NodeBSR requires equal-order V/Q sharing node ids "
                "(P1-P1 / Pk-Pk stabilized forms)"
            )
        self.g = resolve_supernode_g(form.dim, supernode_g)
        self.form = form
        self.device = form.device
        self.dtype = form.dtype
        self.dim = d = form.dim
        self.bs = d + 1
        cells = np.asarray(V.dofmap)
        self.n_nodes = n_nodes = V.num_dofs
        nbn = cells.shape[1]
        nud_loc = nbn * d

        # local row index of (node a, sub s): u comps first (a*d+i),
        # then the p dof at nud_loc + a — matches form._dmf_np layout
        self._ridx = torch.as_tensor(np.concatenate(
            [
                (np.arange(nbn)[:, None] * d + np.arange(d)[None, :]),
                (nud_loc + np.arange(nbn))[:, None],
            ],
            axis=1,
        ).astype(np.int64), device=self.device)  # (nbn, bs)

        # global block keys per element entry, plus facet-term entries
        def pair_keys(nodes):  # nodes (m, nbn) -> (m*nbn*nbn,)
            r = np.repeat(nodes, nbn, axis=1).reshape(-1).astype(np.int64)
            c = np.tile(nodes, (1, nbn)).reshape(-1).astype(np.int64)
            return r * n_nodes + c

        keys = [pair_keys(cells)]
        nud_flat = form.n_u_flat
        for block in form._facet_blocks:
            dmf = block["dofmap_flat_np"]
            nodes_f = dmf[:, nbn * d:] - nud_flat  # p dofs are node ids
            keys.append(pair_keys(nodes_f))
        all_keys = np.concatenate(keys)

        uniq, inv = np.unique(all_keys, return_inverse=True)
        self.n_blocks = len(uniq)
        self.block_row_np = (uniq // n_nodes).astype(np.int32)
        self.block_col_np = (uniq % n_nodes).astype(np.int32)
        self._block_row = torch.as_tensor(
            self.block_row_np.astype(np.int64), device=self.device)
        self._block_col = torch.as_tensor(
            self.block_col_np.astype(np.int64), device=self.device)
        self._assemble_scatter = SortedScatter(inv, self.n_blocks,
                                               device=self.device)

        # positions of the diagonal blocks (every node couples to itself)
        diag_pos = np.searchsorted(uniq, np.arange(n_nodes, dtype=np.int64)
                                   * n_nodes + np.arange(n_nodes))
        self._diag_pos = torch.as_tensor(diag_pos, device=self.device)

        row_np = (uniq // n_nodes).astype(np.int64)
        col_np = (uniq % n_nodes).astype(np.int64)
        if self.g == 1:
            # block-CSR: the blocks are sorted by (row, col) already
            self._bsr_rowptr = torch.as_tensor(
                np.searchsorted(row_np, np.arange(n_nodes + 1))
                .astype(np.int32), device=self.device)
            self._bsr_cols = torch.as_tensor(self.block_col_np,
                                             device=self.device)
            self._sup = None
        else:
            self._sup = SuperMaps(row_np, col_np, n_nodes, self.g,
                                  device=self.device)
            gbs = self.g * self.bs
            if self._sup.ns * self._sup.Kg * gbs * gbs >= 2 ** 31:
                raise ValueError("supernode layout exceeds int32 range")
            self._sup_pos = torch.as_tensor(
                self._sup.block_positions(row_np, col_np, d).reshape(-1),
                device=self.device,
            )
        self._sp = None
        self._sp_amg_h = None
        self._uu_amg_h = None
        self._uu_ras_key = None
        self._uu_ras_obj = None

    # -- assembly (once per operator build) -------------------------------
    def assemble(self, A_cells, A_blocks):
        """Element blocks -> {"coo": (n_blocks, bs, bs) assembled values}
        and, at g > 1, "sup": (ns, Kg, g*bs, g*bs) supernode layout (at
        g = 1 the applies read "coo" itself)."""
        r = self._ridx
        bs = self.bs
        ent = [
            A_cells[:, r[:, None, :, None], r[None, :, None, :]]
            .reshape(-1, bs * bs)
        ]
        for (_, A_f) in A_blocks:
            ent.append(
                A_f[:, r[:, None, :, None], r[None, :, None, :]]
                .reshape(-1, bs * bs)
            )
        entries = torch.cat(ent, dim=0)
        vals = self._assemble_scatter(entries).reshape(-1, bs, bs)
        if self._sup is None:
            return {"coo": vals}
        gbs = self.g * bs
        sup = self._sup
        vals_sup = place(self._sup_pos, vals, sup.ns * sup.Kg * gbs * gbs,
                         (sup.ns, sup.Kg, gbs, gbs))
        return {"coo": vals, "sup": vals_sup}

    def uu_block_jacobi_inv(self, vals, bc_mask_u):
        """Exact inverses of the (dim x dim) diagonal velocity blocks,
        (n_nodes, dim, dim), BC rows identity: one K10 launch."""
        return block_jacobi_inv(vals["coo"], self._diag_pos, bc_mask_u,
                                self.dim)

    def uu_block_jacobi(self, vals, bc_mask_u):
        """A node-block Jacobi PC for the A_uu inner sweeps from the
        inverses of uu_block_jacobi_inv; each apply is one more K10
        launch."""
        inv = self.uu_block_jacobi_inv(vals, bc_mask_u)
        return lambda v: block_jacobi(inv, v)

    # -- form-operator API (vals passed where the form takes A_cells) -----
    @property
    def n_u_flat(self):
        return self.form.n_u_flat

    def _from_nodes(self, yn):
        d = self.dim
        return torch.cat([yn[:, :d].reshape(-1), yn[:, d]])

    # -- operator applies: one K1 launch each, on the flat vectors ---------
    # `epi` passes K1's epilogue options through (mode, b, scale, mask,
    # mask_value, cheb, d_out: kernels/sup_spmv.py, kernels/bsr_spmv.py),
    # so the elementwise work around an apply in cfdtpu is part of its
    # one launch
    def _bsr(self, vals, x, rows, xcols, **epi):
        return bsr_spmv(vals["coo"], self._bsr_rowptr, self._bsr_cols, x,
                        rows, xcols, **epi)

    def apply_element_matrices(self, vals, _A_blocks, v_flat, **epi):
        if self._sup is None:
            return self._bsr(vals, v_flat, "all", "all", **epi)
        gd, n_u = self.g * self.dim, self.n_u_flat
        return sup_spmv(vals["sup"], self._sup.sup_cols, v_flat,
                        n_out=v_flat.shape[0], x_split=(n_u, gd),
                        y_split=(n_u, gd), **epi)

    def apply_sub_block(self, vals, _A_blocks, v, which: str, **epi):
        if self._sup is None:
            return self._bsr(vals, v, which[0], which[1], **epi)
        gd = self.g * self.dim
        rs = slice(0, gd) if which[0] == "u" else slice(gd, None)
        cs = slice(0, gd) if which[1] == "u" else slice(gd, None)
        n_out = (self.n_nodes * self.dim if which[0] == "u"
                 else self.n_nodes)
        # strided view of the sub-block: no copy of the values
        return sup_spmv(vals["sup"][:, :, rs, cs], self._sup.sup_cols, v,
                        n_out=n_out, **epi)

    # -- explicit SELFP Schur matrix ---------------------------------------
    def sp_structure(self):
        """Static structure of Sp = App - Apu diag(Auu)^-1 Aup (the
        matrix PETSc's SchurPreType.SELFP assembles). The product term
        couples node pairs sharing a middle node (distance-2 graph); all
        index maps are built here once, in numpy, as in cfdtpu.

        Returns (sp_row, sp_col, n_sp) with numpy rows/cols; caches
        everything sp_vals() needs."""
        if self._sp is not None:
            return self._sp
        row = self.block_row_np.astype(np.int64)
        col = self.block_col_np.astype(np.int64)
        n = self.n_nodes
        ne = len(row)

        def _build():
            # group entry ids by middle node: e1 by col (I--K), e2 by
            # row (K--J); segmented cartesian product, vectorized
            by_col = np.argsort(col, kind="stable")
            col_s = col[by_col]
            rptr = np.searchsorted(row, np.arange(n + 1))  # row sorted
            cb = np.diff(rptr)              # entries with row == K
            blk_len = cb[col_s]             # block length per sorted entry
            tot = int(blk_len.sum())
            block_id = np.repeat(np.arange(ne, dtype=np.int64), blk_len)
            starts = np.concatenate(([0], np.cumsum(blk_len)[:-1]))
            within = np.arange(tot, dtype=np.int64) - starts[block_id]
            e1 = by_col[block_id]
            e2 = rptr[col_s][block_id] + within
            prod_keys = row[e1] * n + col[e2]
            app_keys = row * n + col
            uniq = np.unique(np.concatenate([prod_keys, app_keys]))
            pk = np.searchsorted(uniq, prod_keys)
            return {
                "e1": e1.astype(np.int32),
                "e2": e2.astype(np.int32),
                "kcol": col[e1].astype(np.int32),
                "pk": pk,
                "app_pos": np.searchsorted(uniq, app_keys).astype(
                    np.int32
                ),
                "uniq": uniq,
                "diag_pos": np.searchsorted(
                    uniq,
                    np.arange(n, dtype=np.int64) * n + np.arange(n),
                ).astype(np.int32),
            }

        # a pure function of the node graph: disk-cached for large graphs
        # (same cache family and key as cfdtpu)
        if ne >= (1 << 20):
            from ..utils.symcache import cached_arrays

            got = cached_arrays("sp_struct", (row, col, n), _build)
        else:
            got = _build()
        uniq = got["uniq"]
        n_sp = len(uniq)
        dev = self.device
        self._sp_e1 = torch.as_tensor(got["e1"], device=dev)
        self._sp_e2 = torch.as_tensor(got["e2"], device=dev)
        self._sp_K = torch.as_tensor(got["kcol"], device=dev)
        self._sp_scatter = SortedScatter(got["pk"], n_sp, device=dev)
        self._sp_app_pos = torch.as_tensor(got["app_pos"].astype(np.int64),
                                           device=dev)
        self._sp_diag_pos = torch.as_tensor(
            got["diag_pos"].astype(np.int64), device=dev)
        self.sp_row_np = (uniq // n).astype(np.int32)
        self.sp_col_np = (uniq % n).astype(np.int32)
        self._sp_row = torch.as_tensor(self.sp_row_np.astype(np.int64),
                                       device=dev)
        self._sp = (self.sp_row_np, self.sp_col_np, n_sp)
        return self._sp

    def sp_vals(self, vals, inv_duu_flat=None):
        """Assemble the explicit SELFP values on sp_structure() (once per
        preconditioner build): K4 triple products, K2 reduction, then the
        App entries added at their unique positions.

        inv_duu_flat: optional (n_u_flat,) inverse velocity diagonal,
        ZERO at Dirichlet rows — this makes Sp match the matrix-free S of
        the Schur preconditioner exactly. Without it the raw diagonal is
        used.
        """
        if isinstance(vals, dict):
            vals = vals["coo"]
        self.sp_structure()
        d = self.dim
        if inv_duu_flat is None:
            diag_uu = vals[self._diag_pos][:, :d, :d]
            inv_duu = 1.0 / torch.diagonal(diag_uu, dim1=1, dim2=2)
        else:
            inv_duu = inv_duu_flat.reshape(self.n_nodes, d)
        contrib = selfp_triple(vals, self._sp_e1, self._sp_e2, self._sp_K,
                               inv_duu.contiguous())
        sp = self._sp_scatter(contrib)
        return sp.index_add_(0, self._sp_app_pos, vals[:, d, d])

    def sp_amg(self, pairwise=False, n_smooth=1, kcycle=None, cheby=None,
               wcycle=None):
        """Aggregation-MG hierarchy on the explicit SELFP graph
        (aggregates formed on the distance-1 node graph, see la/amg.py).
        No p-level: the SELFP matrix is indefinite (see cfdtpu).
        kcycle / cheby / wcycle: None leaves the cached hierarchy's
        setting; a value sets it."""
        if self._sp_amg_h is None:
            from .amg import AMG

            sp_row, sp_col, _ = self.sp_structure()
            self._sp_amg_h = AMG(
                sp_row, sp_col, self.n_nodes,
                agg_row=self.block_row_np, agg_col=self.block_col_np,
                pairwise=pairwise, n_smooth=int(n_smooth),
                device=self.device,
            )
        self._sp_amg_h.set_cycle(kcycle=kcycle, cheby=cheby, wcycle=wcycle)
        return self._sp_amg_h

    # -- velocity-block AMG / RAS hooks (la/amg.py BlockAMG, la/ras.py) ---
    def uu_vals(self, vals, bc_mask_u):
        """BC-consistent (n_blocks, d, d) velocity coupling blocks:
        Dirichlet component rows/columns zeroed, identity on the masked
        diagonal (the assembled twin of the PC-side Auu operator)."""
        if isinstance(vals, dict):
            vals = vals["coo"]
        d = self.dim
        v = vals[:, :d, :d]
        mask = bc_mask_u.reshape(self.n_nodes, d)
        v = torch.where(mask[self._block_row][:, :, None], 0.0, v)
        v = torch.where(mask[self._block_col][:, None, :], 0.0, v)
        eye = torch.eye(d, dtype=v.dtype, device=v.device)
        add = mask.to(v.dtype)[:, :, None] * eye[None]
        v[self._diag_pos] = v[self._diag_pos] + add
        return v

    def linear_parents(self):
        """Vertex-embedding transfer data for a weighted p-level (P2+);
        None for P1, where nodes are the vertices."""
        V = self.form.V
        return None if V.degree <= 1 else V.linear_parents()

    def uu_amg(self, fine_smoother=None, kcycle=None, cheby=None,
               wcycle=None):
        """Block-aggregation-MG hierarchy on the velocity node graph,
        built once and cached; rebuilt only when `fine_smoother` (an
        optional RASPrecond for the finest level) is another object.
        kcycle / cheby / wcycle as in sp_amg (la/schur.py forces a linear
        cycle inside the *_sup near-true S)."""
        if (self._uu_amg_h is None
                or self._uu_amg_h.fine_smoother is not fine_smoother):
            from .amg import BlockAMG

            self._uu_amg_h = BlockAMG(
                self.block_row_np, self.block_col_np, self.n_nodes,
                d=self.dim, fine_smoother=fine_smoother,
                linear_parents=self.linear_parents(), device=self.device,
            )
        self._uu_amg_h.set_cycle(kcycle=kcycle, cheby=cheby, wcycle=wcycle)
        return self._uu_amg_h

    def uu_ras(self, s: int = 16, overlap: int = 4):
        """RAS preconditioner over contiguous Hilbert node windows for
        the velocity block; the same object per (s, overlap)."""
        key = (int(s), int(overlap))
        if self._uu_ras_key != key:
            from .ras import RASPrecond

            self._uu_ras_obj = RASPrecond(
                self.block_row_np, self.block_col_np, self.n_nodes,
                d=self.dim, s=key[0], overlap=key[1], device=self.device,
            )
            self._uu_ras_key = key
        return self._uu_ras_obj

    def apply_p_coupled(self, vals, v_p):
        """One fused pass for the SELFP Schur action: returns
        (Aup v_p, App v_p) from a single gather over the whole p block
        column (one K1 launch on the (.., g*bs, g) column view; at g = 1
        its node-block mode on the p column)."""
        n_u = self.n_u_flat
        if self._sup is None:
            y = self._bsr(vals, v_p, "all", "p")
            return y[:n_u], y[n_u:]
        gd = self.g * self.dim
        y = sup_spmv(vals["sup"][:, :, :, gd:], self._sup.sup_cols, v_p,
                     n_out=n_u + self.n_nodes, y_split=(n_u, gd))
        return y[:n_u], y[n_u:]

    def jacobian_diagonal(self, vals, _A_blocks):
        if isinstance(vals, dict):
            vals = vals["coo"]
        db = vals[self._diag_pos]  # (n_nodes, bs, bs)
        dn = torch.diagonal(db, dim1=1, dim2=2)  # (n_nodes, bs)
        return self._from_nodes(dn)
