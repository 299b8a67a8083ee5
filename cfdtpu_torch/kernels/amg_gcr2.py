"""K11 amg_gcr2: the K-cycle's GCR(2) step (csrc/amg_gcr2.cu).

cfdtpu's _gcr2 (la/amg.py:27-55), two minimal-residual steps on A x = b
from x0 = 0 with the recursive cycle M as preconditioner, is

    z1 = M b;  q1 = A z1                        (the caller: cycle, K1)
    gcr2_first(q1, b):   q1q1 = max(<q1, q1>, tiny), a1 = <q1, b> / q1q1
                         r = b - a1 q1;  returns (r, coef)
    z2 = M r;  q2 = A z2                        (the caller)
    gcr2_second(q1, q2, z1, z2, r, coef):
                         beta = <q1, q2> / q1q1
                         z2' = z2 - beta z1;  q2' = q2 - beta q1
                         a2 = <q2', r> / max(<q2', q2'>, tiny)
                         returns x = a1 z1 + a2 z2'

in the reference's order of operations, tiny = sqrt(finfo(dtype).tiny).
coef = (q1q1, a1) stays in device memory between the two launches; the
host reads nothing. Each sum is taken in one fixed order (one block:
strided per-thread sums, then a fixed tree), so two calls are bitwise
equal.
"""

from __future__ import annotations

import torch

from . import COUNTERS
from ._common import (check_float, check_same_device, is_f64, on_cuda,
                      require, stream_handle)

_COUNT = COUNTERS["amg_gcr2"]


def _tiny(dtype) -> float:
    return float(torch.finfo(dtype).tiny) ** 0.5


def gcr2_first_plain(q1, b):
    """The plain PyTorch version of the first launch (cfdtpu's
    vdot/maximum order)."""
    q1q1 = torch.clamp(torch.dot(q1, q1), min=_tiny(q1.dtype))
    a1 = torch.dot(q1, b) / q1q1
    return b - a1 * q1, torch.stack([q1q1, a1])


def gcr2_second_plain(q1, q2, z1, z2, r, coef):
    """The plain PyTorch version of the second launch."""
    q1q1, a1 = coef[0], coef[1]
    beta = torch.dot(q1, q2) / q1q1
    z2 = z2 - beta * z1
    q2 = q2 - beta * q1
    a2 = torch.dot(q2, r) / torch.clamp(torch.dot(q2, q2),
                                        min=_tiny(q2.dtype))
    return a1 * z1 + a2 * z2


def _check(*named):
    n = named[0][1].shape[0]
    for name, t in named:
        check_float(name, t, named[0][1].dtype)
        require(tuple(t.shape) == (n,) and t.is_contiguous(),
                f"amg_gcr2: {name} must be contiguous ({n},)")
    check_same_device(*named)
    return n


def _launch(second, q1, b_or_q2, z1, z2, r, coef, out):
    from ._build import check, library

    with torch.cuda.device(q1.device):
        rc = library().cfd_amg_gcr2(
            int(second), q1.data_ptr(), b_or_q2.data_ptr(),
            *(None if t is None else t.data_ptr() for t in (z1, z2, r)),
            coef.data_ptr(), out.data_ptr(), q1.shape[0], _tiny(q1.dtype),
            is_f64(q1), stream_handle(q1))
    _COUNT.n += 1
    check(rc, "amg_gcr2")


def gcr2_first(q1, b):
    _check(("q1", q1), ("b", b))
    if not on_cuda(q1):
        return gcr2_first_plain(q1, b)
    r = torch.empty_like(b)
    coef = torch.empty((2,), dtype=b.dtype, device=b.device)
    _launch(False, q1, b, None, None, None, coef, r)
    return r, coef


def gcr2_second(q1, q2, z1, z2, r, coef):
    _check(("q1", q1), ("q2", q2), ("z1", z1), ("z2", z2), ("r", r))
    check_float("coef", coef, q1.dtype)
    require(tuple(coef.shape) == (2,) and coef.is_contiguous(),
            "amg_gcr2: coef must be contiguous (2,)")
    check_same_device(("q1", q1), ("coef", coef))
    if not on_cuda(q1):
        return gcr2_second_plain(q1, q2, z1, z2, r, coef)
    x = torch.empty_like(z1)
    _launch(True, q1, q2, z1, z2, r, coef, x)
    return x
