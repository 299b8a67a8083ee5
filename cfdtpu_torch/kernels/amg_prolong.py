"""K8 amg_prolong: the coarse-grid correction of an aggregation V-cycle
(csrc/amg_prolong.cu).

    y[i*w + c] = base[i*w + c] + xc[agg[i]*w + c]
    base = x, or scale * x

`agg` is the level's aggregate of each fine node (int32, on the
device), `w` the values a node carries (1 for the SELFP AMG, d for
BlockAMG). With `scale` = omega / d and x = b the base is the first
l1-Jacobi pre-smooth from x0 = 0, which is then never stored.
"""

from __future__ import annotations

import torch

from . import COUNTERS
from ._common import (check_float, check_index, check_same_device, is_f64,
                      on_cuda, require, stream_handle)

_COUNT = COUNTERS["amg_prolong"]


def amg_prolong_plain(xc, agg, width: int, x, scale=None):
    """The plain PyTorch version: cfdtpu's `xc[agg]` (AMGLevel.prolong,
    prolong_block) added to the base."""
    base = x if scale is None else scale * x
    return base + xc.reshape(-1, width)[agg.long()].reshape(-1)


def amg_prolong(xc, agg, width: int, x, scale=None):
    check_float("xc", xc)
    check_float("x", x, xc.dtype)
    check_index("agg", agg)
    n = agg.shape[0]
    require(agg.dim() == 1, "amg_prolong: agg must be flat (n,)")
    require(width in (1, 2, 3), f"amg_prolong: width {width} not in 1..3")
    require(xc.dim() == 1 and xc.is_contiguous()
            and xc.shape[0] % width == 0,
            "amg_prolong: xc must be contiguous (n_coarse*width,)")
    require(tuple(x.shape) == (n * width,) and x.is_contiguous(),
            f"amg_prolong: x must be contiguous ({n * width},)")
    if scale is not None:
        check_float("scale", scale, xc.dtype)
        require(scale.shape == x.shape and scale.is_contiguous(),
                "amg_prolong: scale must be contiguous, of x's shape")
    check_same_device(("xc", xc), ("agg", agg), ("x", x), ("scale", scale))
    if not on_cuda(x):
        return amg_prolong_plain(xc, agg, width, x, scale)
    from ._build import check, library

    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = library().cfd_amg_prolong(
            xc.data_ptr(), agg.data_ptr(), x.data_ptr(),
            None if scale is None else scale.data_ptr(), out.data_ptr(), n,
            width, is_f64(x), stream_handle(x))
    _COUNT.n += 1
    check(rc, "amg_prolong")
    return out
