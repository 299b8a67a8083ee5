"""Small-matrix geometry helpers and the sorted scatter.

det_and_inv: explicit cofactor formulas for the 1x1/2x2/3x3 element
Jacobians (as cfdtpu/utils/geometry.py), written with torch.stack so
torch.func can vmap and differentiate through them.

SortedScatter: cfdtpu's sorted scatter, kept in CSR form (destination
offsets and source positions in sorted order); the reduction is kernel
K2 (kernels/ell_sum.py).
"""

from __future__ import annotations

import numpy as np
import torch


def det_and_inv(J):
    """Determinant and inverse of batched small square matrices.

    J has shape (..., d, d) with d in {1, 2, 3}. Returns (det (...,),
    inv (..., d, d)).
    """
    d = J.shape[-1]
    if d == 1:
        det = J[..., 0, 0]
        inv = (1.0 / det)[..., None, None]
        return det, inv
    if d == 2:
        a, b = J[..., 0, 0], J[..., 0, 1]
        c, e = J[..., 1, 0], J[..., 1, 1]
        det = a * e - b * c
        idet = 1.0 / det
        inv = torch.stack(
            [
                torch.stack([e * idet, -b * idet], dim=-1),
                torch.stack([-c * idet, a * idet], dim=-1),
            ],
            dim=-2,
        )
        return det, inv
    if d == 3:
        a = J
        c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
        c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
        c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
        c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
        c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
        c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
        c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
        c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
        c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
        det = (
            a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
        )
        idet = 1.0 / det
        inv = torch.stack(
            [
                torch.stack([c00, c10, c20], dim=-1),
                torch.stack([c01, c11, c21], dim=-1),
                torch.stack([c02, c12, c22], dim=-1),
            ],
            dim=-2,
        ) * idet[..., None, None]
        return det, inv
    raise ValueError(f"det_and_inv supports d <= 3, got {d}")


class SortedScatter:
    """Scatter-add of contributions into n_out destinations, reduced by
    kernel K2 — deterministic, no atomics.

    The layout is CSR: `row_ptr` (n_out + 1) offsets into `pos`, the
    source positions sorted by destination (cfdtpu's stable argsort in
    utils/geometry.py SortedScatter), so no slot is padded. cfdtpu pads
    each destination to K slots (an ELL gather, `ell_idx`) and switches
    to a sorted segment_sum above K = 32; both sum the same
    contributions, and K2 takes any K (the AMG coarse entries gather up
    to ~250).
    """

    def __init__(self, index_array, n_out: int, device):
        from .symcache import cached_arrays

        flat = np.asarray(index_array).reshape(-1)
        self.n_in = len(flat)
        self.n_out = int(n_out)

        def _build():
            perm = np.argsort(flat, kind="stable")
            cnt = np.bincount(flat, minlength=n_out)
            return {
                "K": np.int64(cnt.max() if len(cnt) else 1),
                "row_ptr": np.concatenate([[0], np.cumsum(cnt)])
                .astype(np.int32),
                "pos": perm.astype(np.int32),
            }

        # the sort is a pure function of (flat, n_out): disk-cached for
        # large maps (small ones rebuild faster than they hash), in a
        # cache family of its own (cfdtpu caches other layouts under
        # "scatter")
        if flat.size >= (1 << 20):
            got = cached_arrays("scatter_csr", (flat, n_out), _build)
        else:
            got = _build()
        self.K = int(got["K"])
        self.row_ptr = torch.as_tensor(got["row_ptr"], device=device)
        self.pos = torch.as_tensor(got["pos"], device=device)

    @property
    def ell_idx(self):
        """cfdtpu's padded (n_out, K) ELL index of this scatter (n_in
        marks a padded slot), built from the CSR layout on demand."""
        from ..kernels.ell_sum import ell_index

        return ell_index(self.row_ptr, self.pos, self.n_in, self.K)

    def __call__(self, vals_flat):
        """vals_flat: (N, ...) contributions in the index array's
        flattened order; returns (n_out, ...) sums."""
        from ..kernels.ell_sum import ell_sum

        return ell_sum(vals_flat, self.row_ptr, self.pos, self.K)
