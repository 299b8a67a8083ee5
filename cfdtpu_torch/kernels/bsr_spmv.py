"""K1's node-block mode, bsr_spmv: node-block BSR SpMV with K1's
epilogues (csrc/bsr_spmv.cu).

The operator is the assembled node blocks of P1 tetrahedra themselves:
`vals` (n_blocks, 4, 4) in row-major (row, col) order, `rowptr`
(n + 1,) int32 and `cols` (n_blocks,) int32, node row i owning blocks
rowptr[i] .. rowptr[i + 1] - 1. A view picks the rows and the columns
of each block, each one of

    "all": the 4 values of a node, "u": its 3 velocity values,
    "p": its pressure,

and the vectors are in the solver's flat layouts: x of the columns'
view, out of the rows' view, each [u (3n); p (n)] for "all", u (3n)
for "u" and p (n) for "p". So

    Y[i, r] = sum_{k in row i} sum_{c in cols} vals[k, r, c] X[cols[k], c]
    (r in rows)

with X and Y the flat vectors read node by node. The result is
    mode "y":        Y
    mode "residual": b - Y
    mode "cheby":    one Chebyshev step on a square view (rows ==
                     xcols), cheb = (w, dprev, a, c): dn = a * (dprev or
                     x) + c * w * (b - Y), returned x + dn; d_out, if
                     given, receives dn
and the options around the modes are K1's (kernels/sup_spmv.py):
    scale (x's shape): x is read as scale * x, in the gather and in mode
        "cheby"'s x alike;
    mask (bool, out's shape): the masked rows return mask_value or 0,
        whatever the mode gave; in mode "cheby" they are identity rows
        of the product (Y = x there) and mask_value is refused;
    add (mode "cheby", no mask): returned + add.
The order is K1's: the row sum, the mode, the add, the mask.

Both take 4 x 4 blocks alone: a block row is then 16 bytes in float32,
the kernel's chunk.
"""

from __future__ import annotations

import torch

from . import COUNTERS
from ._common import (check_float, check_index, check_same_device, is_f64,
                      on_cuda, require, stream_handle)
from .sup_spmv import _check_vec, cheby_update_plain

MODES = {"y": 0, "residual": 1, "cheby": 3}
VIEWS = {"all": 0, "u": 1, "p": 2}
_COUNT = COUNTERS["bsr_spmv"]

# lanes a node row, log2: 16 where four lanes share a block (one row of
# it each), 8 where one lane takes a block's one row (views "p" of rows)
LG_ROWS = {"all": 4, "u": 4, "p": 3}


WIDTH = {"all": 4, "u": 3, "p": 1}  # values a node
_SEL = {"all": slice(0, 4), "u": slice(0, 3), "p": slice(3, 4)}


def _nodes(v, n: int, view: str):
    """A flat vector of `view` -> (n, width) node rows."""
    if view == "all":
        return torch.cat([v[: 3 * n].reshape(n, 3), v[3 * n:, None]], dim=1)
    return v.reshape(n, WIDTH[view])


def _flat(yn, view: str):
    """(n, width) node rows -> the flat vector of `view`."""
    if view == "all":
        return torch.cat([yn[:, :3].reshape(-1), yn[:, 3]])
    return yn.reshape(-1)


def bsr_spmv_plain(vals, rowptr, cols, x, rows="all", xcols="all",
                   mode="y", b=None, scale=None, mask=None, mask_value=None,
                   cheb=None, d_out=None, add=None):
    """The plain PyTorch version: each block's product with the gathered
    x, summed into its node row (index_add), then the elementwise ops
    around it in the kernel's order."""
    n = rowptr.shape[0] - 1
    if scale is not None:
        x = scale * x
    X = _nodes(x, n, xcols)
    rowptr = rowptr.long()
    brow = torch.repeat_interleave(torch.arange(n, device=vals.device),
                                   rowptr[1:] - rowptr[:-1])
    A = vals[:, _SEL[rows], _SEL[xcols]]
    prod = torch.einsum("krc,kc->kr", A, X[cols.long()])
    yn = torch.zeros((n, A.shape[1]), dtype=vals.dtype, device=vals.device)
    y = _flat(yn.index_add_(0, brow, prod), rows)
    if mode == "cheby":
        if mask is not None:  # identity rows
            y = torch.where(mask, x, y)
        return cheby_update_plain(x, y, b, *cheb, d_out, add)
    if mode == "residual":
        y = b - y
    if mask is not None:
        y = torch.where(mask, 0.0 if mask_value is None else mask_value, y)
    return y


def _check(vals, rowptr, cols, x, rows, xcols, mode, b, scale, mask,
           mask_value, cheb, d_out, add):
    require(mode in MODES, f"bsr_spmv: mode {mode!r} is not built; "
                           f"built: {tuple(MODES)}")
    require(rows in VIEWS and xcols in VIEWS,
            f"bsr_spmv: views ({rows!r}, {xcols!r}) not in {tuple(VIEWS)}")
    require(vals.dim() == 3 and tuple(vals.shape[1:]) == (4, 4)
            and vals.is_contiguous(),
            f"bsr_spmv: vals must be contiguous (n_blocks, 4, 4), the node "
            f"blocks of P1 tetrahedra, not {tuple(vals.shape)}")
    check_float("vals", vals)
    check_index("rowptr", rowptr)
    check_index("cols", cols)
    nb = vals.shape[0]
    require(rowptr.dim() == 1 and rowptr.shape[0] >= 1
            and tuple(cols.shape) == (nb,),
            f"bsr_spmv: rowptr ({tuple(rowptr.shape)}) and cols "
            f"({tuple(cols.shape)}) do not fit {nb} blocks")
    n = rowptr.shape[0] - 1
    m, n_out = n * WIDTH[xcols], n * WIDTH[rows]
    _check_vec("bsr_spmv: x", x, m, vals.dtype)
    if mode in ("residual", "cheby"):
        require(b is not None, f"bsr_spmv: mode {mode} needs b")
        _check_vec("bsr_spmv: b", b, n_out, vals.dtype)
    if scale is not None:
        _check_vec("bsr_spmv: scale", scale, m, vals.dtype)
    if mask is not None:
        require(mask.dtype == torch.bool and tuple(mask.shape) == (n_out,)
                and mask.is_contiguous(),
                f"bsr_spmv: mask must be contiguous bool ({n_out},)")
    if mask_value is not None:
        require(mask is not None, "bsr_spmv: mask_value needs a mask")
        _check_vec("bsr_spmv: mask_value", mask_value, n_out, vals.dtype)
    cw = dprev = None
    if mode == "cheby":
        require(rows == xcols, "bsr_spmv: mode cheby needs a square view")
        require(cheb is not None and len(cheb) == 4 and mask_value is None,
                "bsr_spmv: mode cheby needs cheb = (w, dprev, a, c), and "
                "its mask takes no mask_value")
        cw, dprev = cheb[:2]
        _check_vec("bsr_spmv: w", cw, n_out, vals.dtype)
        if dprev is not None:
            _check_vec("bsr_spmv: dprev", dprev, n_out, vals.dtype)
    else:
        require(cheb is None and d_out is None and add is None,
                "bsr_spmv: cheb, d_out and add need mode cheby")
    if d_out is not None:
        _check_vec("bsr_spmv: d_out", d_out, n_out, vals.dtype)
    if add is not None:
        require(mask is None, "bsr_spmv: add is built without a mask")
        _check_vec("bsr_spmv: add", add, n_out, vals.dtype)
    check_same_device(("vals", vals), ("rowptr", rowptr), ("cols", cols),
                      ("x", x), ("b", b), ("scale", scale), ("mask", mask),
                      ("mask_value", mask_value), ("w", cw),
                      ("dprev", dprev), ("d_out", d_out), ("add", add))
    return n, n_out


def bsr_spmv(vals, rowptr, cols, x, rows="all", xcols="all", mode="y",
             b=None, scale=None, mask=None, mask_value=None, cheb=None,
             d_out=None, add=None):
    opts = (mode, b, scale, mask, mask_value, cheb, d_out, add)
    n, n_out = _check(vals, rowptr, cols, x, rows, xcols, *opts)
    if not on_cuda(vals):
        return bsr_spmv_plain(vals, rowptr, cols, x, rows, xcols, *opts)
    require(n << LG_ROWS[rows] < 2 ** 31,
            f"bsr_spmv: {n} node rows are too many")
    return _launch(vals, rowptr, cols, x, n, n_out, rows, xcols,
                   LG_ROWS[rows], *opts)


def _launch(vals, rowptr, cols, x, n, n_out, rows, xcols, lg, mode="y",
            b=None, scale=None, mask=None, mask_value=None, cheb=None,
            d_out=None, add=None):
    """One kernel launch into one torch.empty, node rows of 2**lg
    lanes."""
    from ._build import check, library

    out = torch.empty((n_out,), dtype=vals.dtype, device=vals.device)
    cw, dprev, ca, cc = (None, None, 0.0, 0.0) if cheb is None else cheb
    with torch.cuda.device(vals.device):
        rc = library().cfd_bsr_spmv(
            vals.data_ptr(), rowptr.data_ptr(), cols.data_ptr(), n,
            x.data_ptr(), VIEWS[rows], VIEWS[xcols], out.data_ptr(),
            MODES[mode],
            *(None if t is None else t.data_ptr()
              for t in (b, scale, mask, mask_value, cw, dprev, d_out, add)),
            float(ca), float(cc), lg, is_f64(vals), stream_handle(vals))
    _COUNT.n += 1
    check(rc, "bsr_spmv")
    return out
