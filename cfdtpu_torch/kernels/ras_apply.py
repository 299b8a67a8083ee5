"""K6 ras_apply: the restricted additive Schwarz apply (csrc/ras_apply.cu).

    xw[k, b]       = x[win[k, b // d] * d + b % d]   (win == n reads 0)
    z[k*s*d + a]   = sum_{b<m} inv[k, o*d + a, b] * xw[k, b],  a < s*d
    out            = z[: n*d]            (base None)
                   = base + z[: n*d]     (base given)

inv (n_sub, m, m) holds the window inverses (m = (s + 2o) d), x the flat
(n*d,) vector, win (n_sub, s + 2o) int32 the window node ids with the
sentinel n for padding. The counterpart of cfdtpu/la/ras.py
RASPrecond.apply; `base` is the smoother's x + RAS(r).
"""

from __future__ import annotations

import torch

from . import COUNTERS
from ._common import (check_float, check_index, check_same_device, is_f64,
                      on_cuda, require, stream_handle)

_COUNT = COUNTERS["ras_apply"]
MAX_SMEM = 48 * 1024  # the window's gathered x is staged in shared memory


def ras_apply_plain(inv, x, win, s, o, d, base=None):
    """The plain PyTorch version, as cfdtpu computes it: gather the
    windows, multiply all m rows, keep the owned centre rows."""
    n_sub, m, _ = inv.shape
    n = x.shape[0] // d
    xn = torch.cat([x.reshape(n, d),
                    torch.zeros((1, d), dtype=x.dtype, device=x.device)])
    xw = xn[win.long()].reshape(n_sub, m)
    z = torch.einsum("kab,kb->ka", inv, xw)
    zc = z.reshape(n_sub, m // d, d)[:, o:o + s, :].reshape(-1)[: n * d]
    return zc if base is None else base + zc


def ras_apply(inv, x, win, s, o, d, base=None):
    check_float("inv", inv)
    check_float("x", x, inv.dtype)
    check_index("win", win)
    require(inv.dim() == 3 and inv.shape[1] == inv.shape[2],
            "ras_apply: inv must be (n_sub, m, m)")
    n_sub, m, _ = inv.shape
    w = s + 2 * o
    require(m == w * d, f"ras_apply: m {m} != (s + 2o) d = {w * d}")
    require(tuple(win.shape) == (n_sub, w),
            f"ras_apply: win {tuple(win.shape)} != {(n_sub, w)}")
    require(x.dim() == 1 and x.shape[0] % d == 0,
            "ras_apply: x must be flat (n*d,)")
    n = x.shape[0] // d
    require(n_sub * s >= n, f"ras_apply: {n_sub} windows of {s} < {n} nodes")
    if base is not None:
        check_float("base", base, inv.dtype)
        require(tuple(base.shape) == tuple(x.shape),
                "ras_apply: base must have x's shape")
    check_same_device(("inv", inv), ("x", x), ("win", win), ("base", base))
    if not on_cuda(x):
        return ras_apply_plain(inv, x, win, s, o, d, base)
    from ._build import check, library

    require(inv.is_contiguous() and x.is_contiguous()
            and (base is None or base.is_contiguous()),
            "ras_apply: inv, x and base must be contiguous")
    require(m * inv.element_size() <= MAX_SMEM,
            f"ras_apply: window of {m} rows exceeds shared memory")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = library().cfd_ras_apply(
            inv.data_ptr(), x.data_ptr(), win.data_ptr(),
            None if base is None else base.data_ptr(), out.data_ptr(),
            n, d, s, o, w, n_sub, is_f64(x), stream_handle(x),
        )
    _COUNT.n += 1
    check(rc, "ras_apply")
    return out
