"""K1 sup_spmv: supernode-ELL SpMV with fused epilogues (csrc/sup_spmv.cu).

    y[s, r] = sum_{k<Kg} sum_{c<C} A[s, k, r, c] * X[cols[s, k], c]

A is any (ns, Kg, R, C) view — sub-blocks of one value array are passed
as strided views, not copies. X is never built on the card: the kernel
reads it from the solver's flat vector `x`,

    X[s, c] = x[s*C + c]                       (x_split None)
    X[s, c] = x[s*w0 + c]          for c < w0  (x_split (m0, w0): x[:m0]
            = x[m0 + s*(C-w0) + c-w0]  else     at width w0, x[m0:] at C-w0)

where an index past a segment's length, and the padded slot cols == ns,
read zero. The result is one flat vector of n_out entries,

    out[s*R + r]                   (y_split None, s*R + r < n_out)
    out[s*R0 + r]        for r < R0 (y_split (n0, R0): the first n0
    out[n0 + s*(R-R0) + r-R0] else   entries, then the rest)

returned as
    mode "y":        y
    mode "residual": b - y
    mode "jacobi":   x + omega * (b - y) / d   (x is the gathered vector)
    mode "cheby":    one Chebyshev step, cheb = (w, dprev, a, c):
                     dn = a * (dprev or x) + c * w * (b - y),
                     returned x + dn; d_out, if given, receives dn

and options around the modes:
    scale (x's shape; x_split None): x is read as scale * x, in the
        gather and in mode "jacobi"'s x alike;
    mask (bool, n_out): the masked rows return mask_value (n_out) or 0,
        whatever the mode gave;
    prolong = (xc, agg, w): the coarse-grid correction of an aggregation
        V-cycle (K8's, kernels/amg_prolong.py) read in place: x is read
        as xhat = (scale * x or x) + xc[agg[i // w] * w + i % w], in the
        gather and in mode "jacobi"'s x alike; xhat_out (n_out), if
        given, receives xhat. Modes "residual" and "jacobi" on a square
        level (x and the output of one length, one flat x) of 8 nodes a
        supernode at w = 1, 2 or 3, with scale or without, never with mask:
        the combinations the V-cycles use, the ones the kernel is built
        for; the rest raise ValueError.
    add (n_out; modes jacobi and cheby, no mask): returned + add, one
        more rounding after the mode's (the W-cycle's x1 + x2).
In mode "cheby" a mask makes its rows identity rows of the product
(y = x there, as where(mask, v, A v) does), and mask_value is refused.

cheby_update(x, y, b, w, dprev, a, c, d_out=None): mode "cheby"'s update
alone, for an operator that is not one K1 launch (y = its product of x):
elementwise, x + dn with dn as above.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import COUNTERS
from ._common import (check_float, check_index, check_same_device, is_f64,
                      on_cuda, require, stream_handle)
from .amg_prolong import amg_prolong_plain

MODES = {"y": 0, "residual": 1, "jacobi": 2, "cheby": 3}
_COUNT = COUNTERS["sup_spmv"]
_COUNT_PROLONG = COUNTERS["sup_spmv_prolong"]
_COUNT_CHEBY = COUNTERS["sup_spmv_cheby"]
_COUNT_UPDATE = COUNTERS["cheby_update"]

UNROLL_SCALAR = 8  # kUnroll<1> of the kernel: blocks a lane loads at once
LANES_WANTED = 3 * 2 ** 14  # lanes that keep an H100's 132 SMs busy


def _pad_rows(v, ns: int, width: int):
    """v (m,) -> (ns+1, width) supernode rows: zero-padded to ns*width,
    plus the zero sentinel row ns that padded slots point at."""
    xp = torch.zeros(((ns + 1) * width,), dtype=v.dtype, device=v.device)
    xp[: v.shape[0]] = v
    return xp.reshape(ns + 1, width)


def sup_spmv_plain(A, cols, x, n_out, mode="y", b=None, d=None, omega=0.0,
                   x_split=None, y_split=None, scale=None, mask=None,
                   mask_value=None, prolong=None, xhat_out=None, cheb=None,
                   d_out=None, add=None):
    """The plain PyTorch version: the padded supernode rows, the gather
    and the batched einsum, as cfdtpu's jnp operator applies do, then the
    elementwise ops around them in cfdtpu, in the kernel's order. With
    prolong, K8's plain version forms xhat first."""
    ns, _, R, C = A.shape
    if prolong is not None:
        x = amg_prolong_plain(*prolong, x, scale)
        if xhat_out is not None:
            xhat_out.copy_(x)
    elif scale is not None:
        x = scale * x
    if x_split is None:
        X = _pad_rows(x, ns, C)
    else:
        m0, w0 = x_split
        X = torch.cat([_pad_rows(x[:m0], ns, w0),
                       _pad_rows(x[m0:], ns, C - w0)], dim=1)
    y = torch.einsum("skrc,skc->sr", A, X[cols.long()])
    if y_split is None:
        y = y.reshape(-1)[:n_out]
    else:
        n0, R0 = y_split
        y = torch.cat([y[:, :R0].reshape(-1)[:n0],
                       y[:, R0:].reshape(-1)[: n_out - n0]])
    if mode == "cheby":
        if mask is not None:  # identity rows
            y = torch.where(mask, x, y)
        return cheby_update_plain(x, y, b, *cheb, d_out, add)
    if mode == "residual":
        y = b - y
    elif mode == "jacobi":
        y = x + omega * (b - y) / d
    if add is not None:
        y = y + add
    if mask is not None:
        y = torch.where(mask, 0.0 if mask_value is None else mask_value, y)
    return y


def cheby_update_plain(x, y, b, w, dprev, a, c, d_out=None, add=None):
    """One Chebyshev step after y = A x, in the kernels' order."""
    dn = a * (x if dprev is None else dprev) + c * (w * (b - y))
    if d_out is not None:
        d_out.copy_(dn)
    out = x + dn
    return out if add is None else out + add


def _check_vec(name, t, n, dtype):
    check_float(name, t, dtype)
    require(tuple(t.shape) == (n,) and t.is_contiguous(),
            f"{name} must be contiguous ({n},)")


def cheby_update(x, y, b, w, dprev, a, c, d_out=None):
    n = x.shape[0]
    for name, t in (("x", x), ("y", y), ("b", b), ("w", w),
                    ("dprev", dprev), ("d_out", d_out)):
        if t is not None:
            _check_vec(f"cheby_update: {name}", t, n, x.dtype)
    check_same_device(("x", x), ("y", y), ("b", b), ("w", w),
                      ("dprev", dprev), ("d_out", d_out))
    if not on_cuda(x):
        return cheby_update_plain(x, y, b, w, dprev, a, c, d_out)
    from ._build import check, library

    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = library().cfd_cheby_update(
            x.data_ptr(), y.data_ptr(), b.data_ptr(), w.data_ptr(),
            None if dprev is None else dprev.data_ptr(), out.data_ptr(),
            None if d_out is None else d_out.data_ptr(), n, float(a),
            float(c), is_f64(x), stream_handle(x))
    _COUNT_UPDATE.n += 1
    check(rc, "cheby_update")
    return out


class Plan(NamedTuple):
    """How the kernel covers one call. A lane sums `rpl` (1 or 2) rows of
    one supernode (r0 + j*R/rpl), so each x chunk it gathers serves them;
    each such row set is owned by `lanes` lanes (a power of 2, at most a
    warp): `cv` of them cover the C columns in chunks of `vec` values (16
    bytes, or 1 value), times `ks` that split the Kg blocks (the j-th
    takes k = j, j + ks, ...). Lanes beyond cv * ks add zero."""

    vec: int
    cv: int
    ks: int
    lanes: int
    rpl: int


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def launch_plan(A, x_split=None) -> Plan:
    """The kernel's launch plan for the value array (view) A; a plain
    function of A's shape, strides, dtype and address and of x's split
    width. Raises ValueError for a strided view that is not 16-byte
    aligned (a view is read in 16-byte pieces, its own rows only)."""
    ns, Kg, R, C = A.shape
    sz = A.element_size()
    st = A.stride()
    aligned = ((C * sz) % 16 == 0 and st[3] == 1
               and all((s * sz) % 16 == 0 for s in st[:3])
               and A.data_ptr() % 16 == 0)
    require(aligned or A.is_contiguous(),
            f"sup_spmv: the strided view (shape {tuple(A.shape)}, strides "
            f"{st}, offset {A.storage_offset()}) is not 16-byte aligned")
    vec = 16 // sz
    if not aligned or (x_split is not None and x_split[1] % vec):
        vec = 1
    cv = C // vec
    require(cv <= 32, f"sup_spmv: rows of {C} values are wider than a warp")
    rows = ns * R
    if vec == 1:  # one value a lane: each lane's blocks in one round
        lanes = min(32, _pow2_at_least(cv * -(-Kg // UNROLL_SCALAR)))
        rpl = 1
    else:  # two lanes per column chunk, and each x chunk over two rows
        lanes = min(32, _pow2_at_least(cv * min(2, Kg)))
        rpl = 2 if R % 2 == 0 and rows // 2 * lanes >= LANES_WANTED else 1
    # the small levels: split the blocks until the card has enough lanes
    while (lanes < 32 and lanes // cv < Kg
           and rows // rpl * lanes < LANES_WANTED):
        lanes *= 2
    require(rows // rpl * lanes < 2 ** 30,
            f"sup_spmv: {rows} rows are too many")
    return Plan(vec, cv, min(lanes // cv, Kg), lanes, rpl)


def _check(A, cols, x, n_out, mode, b, d, x_split, y_split, scale, mask,
           mask_value, prolong=None, xhat_out=None, cheb=None, d_out=None,
           add=None):
    require(mode in MODES, f"sup_spmv: unknown mode {mode!r}")
    require(A.dim() == 4, "sup_spmv: A must be (ns, Kg, R, C)")
    ns, Kg, R, C = A.shape
    check_float("A", A)
    check_float("x", x, A.dtype)
    check_index("cols", cols)
    require(tuple(cols.shape) == (ns, Kg),
            f"sup_spmv: cols {tuple(cols.shape)} != {(ns, Kg)}")
    require(x.dim() == 1 and x.is_contiguous(),
            "sup_spmv: x must be a contiguous flat vector")
    if x_split is None:
        require(x.shape[0] <= ns * C, f"sup_spmv: x longer than {ns * C}")
    else:
        m0, w0 = x_split
        require(0 < w0 < C and 0 <= m0 <= min(x.shape[0], ns * w0)
                and x.shape[0] - m0 <= ns * (C - w0),
                f"sup_spmv: x_split {x_split} does not fit x "
                f"({x.shape[0]},) and C={C}")
    if y_split is None:
        require(0 <= n_out <= ns * R, f"sup_spmv: n_out {n_out} > {ns * R}")
    else:
        n0, R0 = y_split
        require(0 < R0 < R and 0 <= n0 <= ns * R0
                and 0 <= n_out - n0 <= ns * (R - R0),
                f"sup_spmv: y_split {y_split} does not fit n_out {n_out} "
                f"and R={R}")
    if mode in ("jacobi", "cheby"):
        require(x_split is None and y_split is None and R == C
                and x.shape[0] == n_out,
                f"sup_spmv: mode {mode} needs a square A and x of n_out")
    need = {"y": (), "residual": ("b",), "jacobi": ("b", "d"),
            "cheby": ("b",)}[mode]
    for name, t in (("b", b), ("d", d)):
        if name in need:
            require(t is not None, f"sup_spmv: mode {mode} needs {name}")
            check_float(name, t, A.dtype)
            require(tuple(t.shape) == (n_out,) and t.is_contiguous(),
                    f"sup_spmv: {name} must be contiguous ({n_out},)")
    if scale is not None:
        require(x_split is None, "sup_spmv: scale needs one flat x")
        check_float("scale", scale, A.dtype)
        require(scale.shape == x.shape and scale.is_contiguous(),
                "sup_spmv: scale must be contiguous, of x's shape")
    if mask is not None:
        require(mask.dtype == torch.bool and tuple(mask.shape) == (n_out,)
                and mask.is_contiguous(),
                f"sup_spmv: mask must be contiguous bool ({n_out},)")
    if mask_value is not None:
        require(mask is not None, "sup_spmv: mask_value needs a mask")
        check_float("mask_value", mask_value, A.dtype)
        require(tuple(mask_value.shape) == (n_out,)
                and mask_value.is_contiguous(),
                f"sup_spmv: mask_value must be contiguous ({n_out},)")
    cw = dprev = None
    if mode == "cheby":
        require(cheb is not None and len(cheb) == 4 and mask_value is None,
                "sup_spmv: mode cheby needs cheb = (w, dprev, a, c), and "
                "its mask takes no mask_value")
        cw, dprev = cheb[:2]
        _check_vec("sup_spmv: w", cw, n_out, A.dtype)
        if dprev is not None:
            _check_vec("sup_spmv: dprev", dprev, n_out, A.dtype)
    else:
        require(cheb is None and d_out is None,
                "sup_spmv: cheb and d_out need mode cheby")
    if d_out is not None:
        _check_vec("sup_spmv: d_out", d_out, n_out, A.dtype)
    if add is not None:
        require(mode in ("jacobi", "cheby") and mask is None,
                "sup_spmv: add is built for modes jacobi and cheby, no mask")
        _check_vec("sup_spmv: add", add, n_out, A.dtype)
    xc = agg = None
    if prolong is not None:
        xc, agg, w = prolong
        require(mode in ("residual", "jacobi", "cheby") and mask is None
                and x_split is None and y_split is None and R == C
                and x.shape[0] == n_out,
                "sup_spmv: prolong is built for modes residual, jacobi and "
                "cheby on a square level (one flat x of n_out), with scale or "
                "without, and no mask")
        check_float("xc", xc, A.dtype)
        check_index("agg", agg)
        require(w in (1, 2, 3) and C == 8 * w and agg.dim() == 1
                and agg.shape[0] * w == x.shape[0],
                f"sup_spmv: prolong is built for widths 1 to 3 with 8 "
                f"nodes a supernode; width {w} does not fit C={C} and x "
                f"({x.shape[0]},) with agg ({agg.shape[0]},)")
        require(xc.dim() == 1 and xc.is_contiguous()
                and xc.shape[0] % w == 0,
                "sup_spmv: xc must be contiguous (n_coarse*w,)")
    if xhat_out is not None:
        require(prolong is not None, "sup_spmv: xhat_out needs prolong")
        check_float("xhat_out", xhat_out, A.dtype)
        require(tuple(xhat_out.shape) == (n_out,)
                and xhat_out.is_contiguous(),
                f"sup_spmv: xhat_out must be contiguous ({n_out},)")
    check_same_device(("A", A), ("cols", cols), ("x", x), ("b", b),
                      ("d", d), ("scale", scale), ("mask", mask),
                      ("mask_value", mask_value), ("xc", xc), ("agg", agg),
                      ("xhat_out", xhat_out), ("w", cw), ("dprev", dprev),
                      ("d_out", d_out), ("add", add))


def sup_spmv(A, cols, x, n_out=None, mode="y", b=None, d=None, omega=0.0,
             x_split=None, y_split=None, scale=None, mask=None,
             mask_value=None, prolong=None, xhat_out=None, cheb=None,
             d_out=None, add=None):
    if n_out is None:
        n_out = A.shape[0] * A.shape[2]
    opts = (scale, mask, mask_value, prolong, xhat_out, cheb, d_out, add)
    _check(A, cols, x, n_out, mode, b, d, x_split, y_split, *opts)
    if not on_cuda(A):
        return sup_spmv_plain(A, cols, x, n_out, mode, b, d, omega, x_split,
                              y_split, *opts)
    return _launch(A, cols, x, n_out, mode, b, d, omega, x_split, y_split,
                   launch_plan(A, x_split), *opts)


def _align(p: int) -> int:
    """A segment's alignment class: read in 16-byte pieces at 16, in pairs
    of 8-byte pieces at 8."""
    return 16 if p % 16 == 0 else 8 if p % 8 == 0 else 0


def _launch(A, cols, x, n_out, mode, b, d, omega, x_split, y_split,
            plan: Plan, scale=None, mask=None, mask_value=None, prolong=None,
            xhat_out=None, cheb=None, d_out=None, add=None):
    """One kernel launch into one torch.empty, with the given plan."""
    from ._build import check, library

    xc, agg, w = (None, None, 0) if prolong is None else prolong
    if prolong is not None:
        require(plan.vec == 16 // A.element_size(),
                "sup_spmv: prolong is built for rows read in 16-byte "
                f"chunks; this plan reads {plan.vec} value(s) a lane")
        require(agg.data_ptr() % 16 == 0
                and (w != 2 or xc.data_ptr() % (2 * xc.element_size()) == 0),
                "sup_spmv: prolong's agg must be 16-byte aligned, and xc "
                "aligned to a node's two values at width 2")

    ns, Kg, R, C = A.shape
    m0, w0 = (x.shape[0], C) if x_split is None else x_split
    n0, R0 = (n_out, R) if y_split is None else y_split
    out = torch.empty((n_out,), dtype=A.dtype, device=A.device)
    m = MODES[mode]
    cw, dprev, ca, cc = (None, None, 0.0, 0.0) if cheb is None else cheb
    x0 = x.data_ptr()
    x1 = x0 + m0 * x.element_size()
    xa0, xa1 = (_align(p) if plan.vec > 1 else 0 for p in (x0, x1))
    if scale is not None:  # read beside x in the same pieces
        xa0 = min(xa0, _align(scale.data_ptr()))
        xa0 = xa0 if xa0 == 16 else 0
    with torch.cuda.device(A.device):
        rc = library().cfd_sup_spmv(
            A.data_ptr(), *A.stride()[:3], cols.data_ptr(), ns, Kg, R, C,
            x0, m0, w0, xa0, x1, x.shape[0] - m0, xa1, out.data_ptr(), n0,
            R0, n_out - n0, m, b.data_ptr() if m >= 1 else None,
            d.data_ptr() if m == 2 else None, float(omega),
            *(None if t is None else t.data_ptr()
              for t in (scale, mask, mask_value, xc, agg)), w,
            None if xhat_out is None else xhat_out.data_ptr(),
            *(None if t is None else t.data_ptr()
              for t in (cw, dprev, d_out, add)), float(ca), float(cc),
            plan.vec,
            plan.rpl, plan.cv, plan.ks, plan.lanes.bit_length() - 1,
            is_f64(A), stream_handle(A),
        )
    _COUNT.n += 1
    if prolong is not None:
        _COUNT_PROLONG.n += 1
    if m == 3:
        _COUNT_CHEBY.n += 1
    check(rc, "sup_spmv")
    return out
