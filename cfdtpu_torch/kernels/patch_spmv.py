"""K5 patch_spmv: in-patch scalar ELL SpMV (csrc/patch_spmv.cu).

    y[p, j] = sum_{k<K} vals[p, j, k] * x[p, idx[p, j, k]]

x (P, L), vals (P, L, K), idx (P, L, K) int32 with every index in
[0, L): each row's columns lie in its own patch of L slots. The
counterpart of scripts/gather_micro.py pallas_patch_spmv.
"""

from __future__ import annotations

import torch

from . import COUNTERS
from ._common import (check_float, check_index, check_same_device, is_f64,
                      on_cuda, require, stream_handle)

_COUNT = COUNTERS["patch_spmv"]
MAX_L = 4096  # the patch row is staged in shared memory


def patch_spmv_plain(x, vals, idx):
    """The plain PyTorch version: gather along the patch, multiply, sum
    over k (the numpy reference of gather_micro.py, in torch)."""
    xg = torch.gather(x[:, :, None].expand(-1, -1, idx.shape[2]), 1,
                      idx.long())
    return (vals * xg).sum(dim=2)


def patch_spmv(x, vals, idx):
    check_float("x", x)
    check_float("vals", vals, x.dtype)
    check_index("idx", idx)
    require(x.dim() == 2, "patch_spmv: x must be (P, L)")
    P, L = x.shape
    require(vals.dim() == 3 and tuple(vals.shape[:2]) == (P, L),
            f"patch_spmv: vals {tuple(vals.shape)} != ({P}, {L}, K)")
    require(tuple(idx.shape) == tuple(vals.shape),
            f"patch_spmv: idx {tuple(idx.shape)} != {tuple(vals.shape)}")
    check_same_device(("x", x), ("vals", vals), ("idx", idx))
    if not on_cuda(x):
        return patch_spmv_plain(x, vals, idx)
    from ._build import check, library

    require(x.is_contiguous() and vals.is_contiguous(),
            "patch_spmv: x and vals must be contiguous")
    require(L <= MAX_L, f"patch_spmv: L {L} > {MAX_L}")
    K = vals.shape[2]
    y = torch.empty((P, L), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = library().cfd_patch_spmv(
            x.data_ptr(), vals.data_ptr(), idx.data_ptr(), y.data_ptr(),
            P, L, K, is_f64(x), stream_handle(x),
        )
    _COUNT.n += 1
    check(rc, "patch_spmv")
    return y
