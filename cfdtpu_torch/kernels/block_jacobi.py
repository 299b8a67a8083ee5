"""K10 block_jacobi: node-block Jacobi (csrc/block_jacobi.cu).

block_jacobi(inv, v): z[i*d + a] = sum_b inv[i, a, b] * v[i*d + b]

inv is (n, d, d) with d in 1..3 (d = 1: a diagonal scale, z = inv * v,
the first step of a Chebyshev sweep from x0 = 0), v and z are (n*d,)
flat, component-major per node (the solver's u layout). With divide
(d = 1 only), z = v / inv: the S stage's v / d_p of the gmres inner
method, divided as cfdtpu divides (a product by 1 / d_p differs by an
ulp, which 30 GMRES steps grow to ~1e-11).

block_jacobi_inv(vals, diag_pos, mask, d): the inverses of the diagonal
velocity blocks for the preconditioner above (cfdtpu's
NodeBSR.uu_block_jacobi), from the assembled node blocks `vals`
(n_blocks, bs, bs): block diag_pos[i]'s leading (d x d) part, its rows
and columns at the Dirichlet components of node i (mask (n*d,) bool)
replaced by the identity's, inverted by the cofactor formulas of
utils/geometry.det_and_inv.
"""

from __future__ import annotations

import torch

from . import COUNTERS
from ._common import (check_float, check_same_device, is_f64, on_cuda,
                      require, stream_handle)
from ..utils.geometry import det_and_inv

_COUNT = COUNTERS["block_jacobi"]
_COUNT_INV = COUNTERS["block_jacobi_inv"]


def block_jacobi_plain(inv, v, divide: bool = False):
    """The plain PyTorch version: cfdtpu's einsum (la/nodebsr.py:185-187),
    or its v / d."""
    n, d, _ = inv.shape
    if divide:
        return v / inv.reshape(-1)
    return torch.einsum("nab,nb->na", inv, v.reshape(n, d)).reshape(-1)


def block_jacobi(inv, v, divide: bool = False):
    check_float("inv", inv)
    check_float("v", v, inv.dtype)
    require(inv.dim() == 3 and inv.shape[1] == inv.shape[2]
            and 1 <= inv.shape[1] <= 3 and inv.is_contiguous(),
            "block_jacobi: inv must be contiguous (n, d, d), d in 1..3")
    n, d, _ = inv.shape
    require(tuple(v.shape) == (n * d,) and v.is_contiguous(),
            f"block_jacobi: v must be contiguous ({n * d},)")
    require(not divide or d == 1, "block_jacobi: divide needs d = 1")
    check_same_device(("inv", inv), ("v", v))
    if not on_cuda(v):
        return block_jacobi_plain(inv, v, divide)
    from ._build import check, library

    out = torch.empty_like(v)
    with torch.cuda.device(v.device):
        rc = library().cfd_block_jacobi(inv.data_ptr(), v.data_ptr(),
                                        out.data_ptr(), n, d, int(divide),
                                        is_f64(v), stream_handle(v))
    _COUNT.n += 1
    check(rc, "block_jacobi")
    return out


def block_jacobi_inv_plain(vals, diag_pos, mask, d: int):
    """The plain PyTorch version: cfdtpu's masked diagonal blocks and
    det_and_inv (la/nodebsr.py:176-183)."""
    db = vals[diag_pos.long()][:, :d, :d]
    m = mask.reshape(-1, d)
    eye = torch.eye(d, dtype=db.dtype, device=db.device)
    db = torch.where(m[:, :, None], eye[None], db)
    db = torch.where(m[:, None, :], eye[None], db)
    return det_and_inv(db)[1]


def block_jacobi_inv(vals, diag_pos, mask, d: int):
    check_float("vals", vals)
    require(vals.dim() == 3 and vals.shape[1] == vals.shape[2] >= d
            and 1 <= d <= 3 and vals.is_contiguous(),
            "block_jacobi_inv: vals must be contiguous (n_blocks, bs, bs) "
            "with bs >= d, d in 1..3")
    n = diag_pos.shape[0]
    require(diag_pos.dim() == 1 and diag_pos.dtype == torch.int64
            and diag_pos.is_contiguous(),
            "block_jacobi_inv: diag_pos must be contiguous int64 (n,)")
    require(mask.dtype == torch.bool and tuple(mask.shape) == (n * d,)
            and mask.is_contiguous(),
            f"block_jacobi_inv: mask must be contiguous bool ({n * d},)")
    check_same_device(("vals", vals), ("diag_pos", diag_pos),
                      ("mask", mask))
    if not on_cuda(vals):
        return block_jacobi_inv_plain(vals, diag_pos, mask, d)
    from ._build import check, library

    out = torch.empty((n, d, d), dtype=vals.dtype, device=vals.device)
    with torch.cuda.device(vals.device):
        rc = library().cfd_block_jacobi_inv(
            vals.data_ptr(), vals.shape[1], diag_pos.data_ptr(),
            mask.data_ptr(), out.data_ptr(), n, d, is_f64(vals),
            stream_handle(vals))
    _COUNT_INV.n += 1
    check(rc, "block_jacobi_inv")
    return out
