"""Restricted additive Schwarz (RAS) with batched dense subdomain solves.

The counterpart of cfdtpu/la/ras.py: the Hilbert-ordered node axis is
tiled into contiguous windows of `s` nodes extended by `overlap` nodes
on each side; each window's velocity submatrix is inverted once per
preconditioner build, and the apply multiplies each window's gathered
x by its inverse and writes back only the owned centre rows (Cai and
Sarkis' restricted variant).

The window maps are built in numpy exactly as in cfdtpu. The placement
of the blocks into the windows and the batched inverse are plain torch
(torch.linalg.inv; cfdtpu calls jnp.linalg.inv). Only the owned rows of
each inverse are kept, (n_sub, s*d, m) contiguous: the apply reads no
other row. The apply is kernel K6 (kernels/ras_apply.py); the windows
are contiguous node ranges, so it needs no gather map.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.ras_apply import ras_apply
from .superell import place


class RASPrecond:
    """Static maps for RAS over contiguous node windows.

    Args:
        row, col: node-pair COO graph of the (masked) velocity block,
            row-sorted (NodeBSR.block_row_np/block_col_np).
        n: number of nodes.
        d: velocity components per node (block size).
        s: owned nodes per window.
        overlap: extra nodes on each side of the window.
    """

    def __init__(self, row: np.ndarray, col: np.ndarray, n: int, d: int,
                 s: int = 16, overlap: int = 4, *, device):
        self.n = int(n)
        self.d = int(d)
        self.s = s = int(s)
        self.o = o = int(overlap)
        self.w = w = s + 2 * o
        self.m = m = w * d
        n_sub = -(-n // s)
        self.n_sub = n_sub

        row = np.asarray(row, dtype=np.int64)
        col = np.asarray(col, dtype=np.int64)
        total = n_sub * m * m

        def _build():
            # window k holds nodes [k*s - o, k*s + s + o); node x is in
            # window k iff floor((x - s - o)/s) < k <= floor((x + o)/s)
            lo = np.maximum(
                np.maximum((row - s - o) // s + 1,
                           (col - s - o) // s + 1), 0
            )
            up = np.minimum(
                np.minimum((row + o) // s, (col + o) // s), n_sub - 1
            )
            n_cand = (
                int(np.maximum(up - lo + 1, 0).max()) if len(row) else 1
            )
            # scatter positions: entry (r, c) lands in window k at local
            # block (r - (k*s - o), c - (k*s - o)); each (k, r, c) triple
            # is unique; out-of-range candidates get the sentinel `total`
            pos_slots = []
            ij = np.arange(d)
            for t in range(max(n_cand, 1)):
                k = lo + t
                ok = k <= up
                base = k * s - o
                lr = (row - base) * d
                lc = (col - base) * d
                p = (
                    (k[:, None] * m + lr[:, None] + ij[None, :])[:, :, None]
                    * m + (lc[:, None] + ij[None, :])[:, None, :]
                )
                p = np.where(ok[:, None, None], p, total)
                pos_slots.append(p)
            pos = np.concatenate(pos_slots, axis=0)
            return {
                "n_cand": np.int64(max(n_cand, 1)),
                "pos": pos.astype(
                    np.int64 if total >= 2**31 else np.int32
                ),
            }

        # a pure function of the graph + (n, d, s, o): disk-cached for
        # large graphs (same cache family and key as cfdtpu)
        if len(row) >= (1 << 20):
            from ..utils.symcache import cached_arrays

            got = cached_arrays(
                "ras_pos", (row, col, n, d, s, o), _build
            )
        else:
            got = _build()
        self._n_cand = int(got["n_cand"])
        self._pos = got["pos"]  # (n_cand * nnz, d, d), sentinel `total`
        self._total = total
        # cfdtpu drops the sentinel positions in its scatter (mode="drop");
        # an index write has no drop mode, so the kept positions and the
        # uu-value entries they take are selected here, once
        flat = self._pos.reshape(-1)
        kept = np.nonzero(flat != total)[0]
        self._dst = torch.as_tensor(flat[kept].astype(np.int64),
                                    device=device)
        self._src = torch.as_tensor(kept % (len(row) * d * d),
                                    device=device)

        # per-row validity of the window nodes (padding rows become
        # identity)
        win = (np.arange(n_sub)[:, None] * s - o + np.arange(w)[None, :])
        invalid = (win < 0) | (win >= n)
        inv_rows = np.repeat(invalid, d, axis=1)  # (n_sub, m)
        self._eye_add = torch.as_tensor(inv_rows.astype(np.float32),
                                        device=device)

    # -- per-PC-build -----------------------------------------------------
    def build(self, uu_vals):
        """uu_vals: (nnz, d, d) masked velocity blocks aligned with the
        (row, col) graph (NodeBSR.uu_vals: Dirichlet rows/cols zeroed,
        identity diagonal). Returns the owned rows of the window inverses,
        (n_sub, s*d, m): rows o*d .. (o+s)*d of cfdtpu's (n_sub, m, m)."""
        m = self.m
        A = place(self._dst, uu_vals.reshape(-1)[self._src], self._total,
                  (self.n_sub, m, m))
        # identity rows for window padding (nodes outside [0, n))
        eye = self._eye_add.to(A.dtype)
        A = A + eye[:, :, None] * torch.eye(m, dtype=A.dtype,
                                            device=A.device)[None]
        # the owned rows, row-major for K6 (the batched inverse may come
        # back with each matrix stored column-major)
        o, sd = self.o * self.d, self.s * self.d
        return torch.linalg.inv(A)[:, o:o + sd, :].contiguous()

    # -- apply ------------------------------------------------------------
    def apply(self, inv, x, base=None):
        """x: (n*d,) flat velocity vector -> RAS-preconditioned vector
        (plus `base` when given: the smoother's x + RAS(r))."""
        return ras_apply(inv, x, self.s, self.o, self.d, base=base)
