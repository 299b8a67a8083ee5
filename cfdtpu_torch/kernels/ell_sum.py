"""K2 ell_sum: deterministic sorted-segment gather-reduce (csrc/ell_sum.cu).

    out[i, ...] = sum_{row_ptr[i] <= j < row_ptr[i+1]} src[pos[j], ...]

(row_ptr, pos) is a scatter in CSR form: row_ptr (n_out + 1,) int32
offsets, pos (nnz,) int32 source rows sorted by destination, in the
order of cfdtpu's stable argsort. K is the largest row count. The
counterpart of cfdtpu's SortedScatter.__call__ (an ELL gather padded
to K) and of the AMG segment sums.
"""

from __future__ import annotations

import torch

from . import COUNTERS
from ._common import (check_float, check_index, check_same_device, is_f64,
                      on_cuda, require, stream_handle)

_COUNT = COUNTERS["ell_sum"]
LOADS = (4, 16)  # contributions a lane loads per round (kU in the .cu)
SMALL_LAUNCH = 1 << 17  # a launch of fewer threads leaves the card idle
MAX_THREADS = 1 << 19  # a lane split stops here (~2 waves of an H100)


def ell_index(row_ptr, pos, n_in, K):
    """cfdtpu's padded ELL index (n_out, K) of the CSR scatter: slot k of
    row i holds pos[row_ptr[i] + k], and n_in past the row's end."""
    start = row_ptr[:-1].long()
    cnt = row_ptr[1:].long() - start
    slot = torch.arange(K, device=pos.device)
    j = start[:, None] + slot[None, :]
    ok = slot[None, :] < cnt[:, None]
    fill = torch.full((), n_in, dtype=pos.dtype, device=pos.device)
    return torch.where(ok, pos[j.clamp(max=max(pos.shape[0] - 1, 0))],
                       fill)


def ell_sum_plain(src, row_ptr, pos, K):
    """The plain PyTorch version: cfdtpu's SortedScatter.__call__ on the
    ELL index of the CSR scatter (pad one zero row, gather, sum over K)."""
    idx = ell_index(row_ptr, pos, src.shape[0], K)
    pad = torch.zeros((1,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    return torch.cat([src, pad], dim=0)[idx.long()].sum(dim=1)


def ell_plan(n_out, F, nnz, K):
    """(G, loads): G lanes per output, a power of two with G*F <= 32 (so
    F a power of two), and the contributions a lane loads per round.

    A small launch (under SMALL_LAUNCH threads with the doubled G) is
    latency bound: G doubles until the longest row takes one round of
    4 loads. A large one doubles G only while that row takes more than
    two rounds, the mean row fills the lanes and the launch stays under
    MAX_THREADS. A lane then loads 4 a round, or 16 where rows still
    take more than two rounds in a small launch (the coarse levels'
    coarsen maps)."""
    def rounds(G):
        return -(-K // (G * LOADS[0]))

    mean = nnz / max(n_out, 1)
    G = 1
    while not F & (F - 1) and 2 * G * F <= 32:
        threads = n_out * F * 2 * G
        if threads <= SMALL_LAUNCH:
            more = rounds(G) > 1
        else:
            more = rounds(G) > 2 and G < mean and threads <= MAX_THREADS
        if not more:
            break
        G *= 2
    small = n_out * F * G < SMALL_LAUNCH
    return G, LOADS[1] if rounds(G) > 2 and small else LOADS[0]


def ell_sum(src, row_ptr, pos, K):
    check_float("src", src)
    check_index("row_ptr", row_ptr)
    check_index("pos", pos)
    require(row_ptr.dim() == 1 and pos.dim() == 1,
            "ell_sum: row_ptr and pos must be 1-d")
    check_same_device(("src", src), ("row_ptr", row_ptr), ("pos", pos))
    if not on_cuda(src):
        return ell_sum_plain(src, row_ptr, pos, K)
    from ._build import check, library

    require(src.is_contiguous(), "ell_sum: src must be contiguous")
    n_out = row_ptr.shape[0] - 1
    F = 1
    for s in src.shape[1:]:
        F *= int(s)
    G, loads = ell_plan(n_out, F, pos.shape[0], K)
    require(n_out * F * G < 2**31, "ell_sum: launch exceeds 2^31 threads")
    out = torch.empty((n_out,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    with torch.cuda.device(src.device):
        rc = library().cfd_ell_sum(
            src.data_ptr(), row_ptr.data_ptr(), pos.data_ptr(),
            out.data_ptr(), n_out, F, G, loads, is_f64(src),
            stream_handle(src),
        )
    _COUNT.n += 1
    check(rc, "ell_sum")
    return out
