"""K6 ras_apply: the restricted additive Schwarz apply (csrc/ras_apply.cu).

    xw[k, b]       = x[(k*s - o)*d + b]   (zero outside [0, n*d))
    z[k*s*d + a]   = sum_{b<m} inv[k, a, b] * xw[k, b],   a < s*d
    out            = z[: n*d]            (base None)
                   = base + z[: n*d]     (base given)

inv (n_sub, s*d, m) holds the owned rows of the window inverses (m =
(s + 2o) d; RASPrecond.build keeps rows o*d .. (o+s)*d of each), x the
flat (n*d,) vector. Window k covers the contiguous nodes [k*s - o,
k*s + s + o), so no index map is read. The counterpart of
cfdtpu/la/ras.py RASPrecond.apply; `base` is the smoother's x + RAS(r).
"""

from __future__ import annotations

import torch

from . import COUNTERS
from ._common import (check_float, check_same_device, is_f64, on_cuda,
                      require, sm_count, stream_handle)

_COUNT = COUNTERS["ras_apply"]
MAX_SMEM = 232448  # shared memory a block may opt in to on an H100
CHUNK = 8  # rows per bulk copy (kChunk in the .cu)


def ras_windows(x, n_sub, s, o, d):
    """(n_sub, (s + 2o) d) window values of the flat x: window k reads
    nodes [k*s - o, k*s + s + o), zero outside [0, n) — cfdtpu's gather
    through its `_win` map, written as a padded unfold."""
    m, sd = (s + 2 * o) * d, s * d
    total = (n_sub - 1) * sd + m
    lead = o * d
    xp = torch.cat([x.new_zeros(lead), x,
                    x.new_zeros(total - lead - x.shape[0])])
    return xp.unfold(0, m, sd)


def ras_apply_plain(inv, x, s, o, d, base=None):
    """The plain PyTorch version, as cfdtpu computes it on the owned rows:
    gather the windows, one batched matvec, drop the padded tail."""
    n_sub = inv.shape[0]
    xw = ras_windows(x, n_sub, s, o, d)
    z = torch.einsum("kab,kb->ka", inv, xw).reshape(-1)[: x.shape[0]]
    return z if base is None else base + z


def ras_smem(per_block, sd, m, elem_size):
    """Shared-memory bytes of a block that sums `per_block` rows: its
    chunk barriers, x of its windows and its rows (as csrc/ras_apply.cu
    lays them out)."""
    pad = (lambda b: -(-b // 128) * 128)
    n_chunks = -(-per_block // CHUNK)
    xs_len = ((per_block - 1) // sd + 1) * sd + m
    return (pad(8 * n_chunks) + pad(xs_len * elem_size)
            + per_block * m * elem_size)


def ras_plan(nd, sd, m, elem_size, ptr, n_sm):
    """(per_block, blocks, bulk): the nd output rows in equal runs, one
    block each, over the card's n_sm SMs (one wave), or over the fewest
    blocks beyond that whose runs fit the shared memory; bulk 1 when the
    rows go by bulk copy and 16-byte reads (rows, windows and the array
    16-byte aligned), else 0 (the threads copy them)."""
    bulk = int((m * elem_size) % 16 == 0 and (sd * elem_size) % 16 == 0
               and ptr % 16 == 0)
    require(ras_smem(1, sd, m, elem_size) <= MAX_SMEM,
            f"ras_apply: a window of {sd} x {m} exceeds shared memory")
    blocks = max(min(n_sm, nd), 1)
    while ras_smem(-(-nd // blocks), sd, m, elem_size) > MAX_SMEM:
        blocks += 1
    per_block = -(-nd // blocks)
    return per_block, -(-nd // per_block), bulk


def ras_apply(inv, x, s, o, d, base=None):
    check_float("inv", inv)
    check_float("x", x, inv.dtype)
    require(inv.dim() == 3, "ras_apply: inv must be (n_sub, s*d, m)")
    n_sub, sd, m = inv.shape
    want = (s * d, (s + 2 * o) * d)
    require((sd, m) == want, f"ras_apply: inv rows/cols {(sd, m)} != {want}")
    require(x.dim() == 1 and x.shape[0] % d == 0,
            "ras_apply: x must be flat (n*d,)")
    n = x.shape[0] // d
    require(n_sub * s >= n, f"ras_apply: {n_sub} windows of {s} < {n} nodes")
    if base is not None:
        check_float("base", base, inv.dtype)
        require(tuple(base.shape) == tuple(x.shape),
                "ras_apply: base must have x's shape")
    check_same_device(("inv", inv), ("x", x), ("base", base))
    if not on_cuda(x):
        return ras_apply_plain(inv, x, s, o, d, base)
    from ._build import check, library

    require(inv.is_contiguous() and x.is_contiguous()
            and (base is None or base.is_contiguous()),
            "ras_apply: inv, x and base must be contiguous")
    per_block, blocks, bulk = ras_plan(n * d, sd, m, inv.element_size(),
                                       inv.data_ptr(),
                                       sm_count(x.device.index))
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = library().cfd_ras_apply(
            inv.data_ptr(), x.data_ptr(),
            None if base is None else base.data_ptr(), out.data_ptr(),
            n, d, s, o, per_block, blocks, bulk, is_f64(x), stream_handle(x),
        )
    _COUNT.n += 1
    check(rc, "ras_apply")
    return out
