"""K1 sup_spmv on the CPU: the plain version, with the flat-layout
arguments the operator applies pass, against a jnp einsum written as
cfdtpu writes it (cfdtpu/la/amg.py AMG._matvec, cfdtpu/la/superell.py
sup_matvec, and for two segments cfdtpu/la/nodebsr.py's concatenated
u and p supernode rows and its split output), and the kernel's launch
plan.

The prolong option (K8's coarse-grid correction read in the gather) is
held against K8's plain version followed by K1's (bit for bit) and
against the einsum on base + xc[agg] (1e-12), at widths 1 and 2, both
modes it serves, with and without the input scale.

Every (R, C) class K1 serves is one case: the full 12x12 operator (one
and two segments), its uu / up / pu / pp / p-coupled views, the 8x8 AMG
and 16x16 BlockAMG levels and width 1. Inputs are made with numpy from
a seed; ELL slots padded with cols == ns, vectors shorter than ns*C and
outputs shorter than ns*R are in every case. Tolerance: 1e-12 relative
in float64 and 1e-5 in float32 (the same products, summed in another
order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfdtpu  # noqa: F401  (JAX in float64 at highest precision)
from cfdtpu_torch import kernels
from cfdtpu_torch.kernels.amg_prolong import amg_prolong_plain
from cfdtpu_torch.kernels.sup_spmv import (LANES_WANTED, UNROLL_SCALAR,
                                           launch_plan, sup_spmv,
                                           sup_spmv_plain)

torch.set_num_threads(1)

NS, KG = 7, 5
RTOL = {np.float64: 1e-12, np.float32: 1e-5}

# name: (parent (R, C), row slice, column slice, x split width,
#        output split row)
CASES = {
    "full 12x12 two segments": (12, slice(None), slice(None), 8, 8),
    "12x12 one segment": (12, slice(None), slice(None), None, None),
    "uu 8x8 view of 12": (12, slice(0, 8), slice(0, 8), None, None),
    "up 8x4 view": (12, slice(0, 8), slice(8, None), None, None),
    "pu 4x8 view": (12, slice(8, None), slice(0, 8), None, None),
    "pp 4x4 view": (12, slice(8, None), slice(8, None), None, None),
    "p-coupled 12x4 view": (12, slice(None), slice(8, None), None, 8),
    "amg 8x8": (8, slice(None), slice(None), None, None),
    "block-amg 16x16": (16, slice(None), slice(None), None, None),
    "width 1": (1, slice(None), slice(None), None, None),
    # P1 tetrahedra: 4 x 4 node blocks, g = 4, and BlockAMG at width 3
    "full 16x16 two segments": (16, slice(None), slice(None), 12, 12),
    "uu 12x12 view of 16": (16, slice(0, 12), slice(0, 12), None, None),
    "up 12x4 view of 16": (16, slice(0, 12), slice(12, None), None, None),
    "pu 4x12 view of 16": (16, slice(12, None), slice(0, 12), None, None),
    "block-amg 24x24": (24, slice(None), slice(None), None, None),
}


def _params():
    out = []
    for name, (_, rs, cs, xs, ys) in CASES.items():
        square = rs == cs and xs is None and ys is None
        for mode in ("y", "residual", "jacobi") if square else ("y",):
            for dt in (np.float64, np.float32):
                out.append(pytest.param(name, mode, dt,
                                        id=f"{name}-{mode}-{dt.__name__}"))
    return out


def _case(name, dt, seed=0):
    g, rs, cs, xs, ys = CASES[name]
    rng = np.random.default_rng(seed)
    parent = rng.standard_normal((NS, KG, g, g)).astype(dt)
    cols = rng.integers(0, NS, (NS, KG)).astype(np.int32)
    cols[:, -2:] = NS  # padded slots
    cols[0, :] = NS
    A = torch.as_tensor(parent)[:, :, rs, cs]
    R, C = A.shape[2], A.shape[3]
    if xs is None:
        xsplit, m = None, NS * C - 3
    else:
        xsplit, m = (NS * xs - 2, xs), NS * xs - 2 + NS * (C - xs) - 1
    if ys is None:
        ysplit, n_out = None, NS * R - 2
    else:
        ysplit, n_out = (NS * ys - 2, ys), NS * ys - 2 + NS * (R - ys) - 1
    if xsplit is None and ysplit is None and R == C:
        m = n_out  # a square level: x and y have one length
    vec = {k: rng.standard_normal(n).astype(dt) for k, n in
           (("x", m), ("b", n_out))}
    vec["d"] = (1.0 + rng.random(n_out)).astype(dt)
    return A, cols, vec, xsplit, ysplit, n_out


def _jnp_rows(x, ns, w):
    """cfdtpu's supernode rows: zero-padded, plus the zero sentinel."""
    xp = jnp.zeros((ns * w,), x.dtype).at[: x.shape[0]].set(x)
    return jnp.concatenate([xp.reshape(ns, w), jnp.zeros((1, w), x.dtype)])


def _jnp_reference(A, cols, x, xsplit, ysplit, n_out):
    ns, _, R, C = A.shape
    vals = jnp.asarray(A)
    if xsplit is None:
        x_sup = _jnp_rows(x, ns, C)
    else:
        m0, w0 = xsplit
        x_sup = jnp.concatenate([_jnp_rows(x[:m0], ns, w0),
                                 _jnp_rows(x[m0:], ns, C - w0)], axis=1)
    xg = x_sup[jnp.asarray(cols)]  # (ns, Kg, C)
    y = jnp.einsum("skab,skb->sa", vals, xg, preferred_element_type=x.dtype)
    if ysplit is None:
        return y.reshape(-1)[:n_out]
    n0, R0 = ysplit
    return jnp.concatenate([y[:, :R0].reshape(-1)[:n0],
                            y[:, R0:].reshape(-1)[: n_out - n0]])


@pytest.mark.parametrize("name,mode,dt", _params())
def test_plain_matches_cfdtpu_einsum(name, mode, dt):
    A, cols, vec, xsplit, ysplit, n_out = _case(name, dt)
    omega = 0.67
    t = {k: torch.as_tensor(v) for k, v in vec.items()}
    kernels.reset_counts()
    got = sup_spmv(A, torch.as_tensor(cols), t["x"], n_out, mode=mode,
                   b=t["b"], d=t["d"], omega=omega, x_split=xsplit,
                   y_split=ysplit)
    plain = sup_spmv_plain(A, torch.as_tensor(cols), t["x"], n_out, mode,
                           t["b"], t["d"], omega, xsplit, ysplit)
    assert kernels.counts()["sup_spmv"] == 0  # CPU tensors: no launch
    assert torch.equal(got, plain)
    x = jnp.asarray(vec["x"])
    y = _jnp_reference(A.numpy(), cols, x, xsplit, ysplit, n_out)
    if mode == "residual":
        ref = jnp.asarray(vec["b"]) - y
    elif mode == "jacobi":
        ref = x + omega * (jnp.asarray(vec["b"]) - y) / jnp.asarray(vec["d"])
    else:
        ref = y
    ref = np.asarray(ref)
    assert got.dtype == A.dtype and got.shape == ref.shape
    err = np.abs(got.numpy() - ref).max()
    assert err <= RTOL[dt] * np.abs(ref).max(), err


# the K1 sites of the two slices at 106,275 DOF (DFG 2D-1, res_scale 0.3)
# and of gather_micro: (ns, Kg, R, C), the view of a 12x12 parent, and
# the width of x's first segment
SITES = {
    "full operator": ((8857, 15, 12, 12), None, 8),
    "uu": ((8857, 15, 12, 12), (slice(0, 8), slice(0, 8)), None),
    "up": ((8857, 15, 12, 12), (slice(0, 8), slice(8, None)), None),
    "pu": ((8857, 15, 12, 12), (slice(8, None), slice(0, 8)), None),
    "pp": ((8857, 15, 12, 12), (slice(8, None), slice(8, None)), None),
    "p-coupled": ((8857, 15, 12, 12), (slice(None), slice(8, None)), None),
    "selfp amg L0": ((4429, 22, 8, 8), None, None),
    "selfp amg L1": ((484, 14, 8, 8), None, None),
    "block-amg L0": ((4429, 13, 16, 16), None, None),
    "block-amg L1": ((484, 12, 16, 16), None, None),
    "block-amg L2": ((54, 11, 16, 16), None, None),
    "width 1 P=8192 K=8": ((8192 * 128, 8, 1, 1), None, None),
    "width 1 P=2048 K=16": ((2048 * 128, 16, 1, 1), None, None),
    # DFG 3D-1Z (243,018 nodes): 4 x 4 node blocks in supernodes of 4,
    # BlockAMG's levels at width 3
    "3d full": ((60755, 30, 16, 16), None, 12),
    "3d uu": ((60755, 30, 16, 16), (slice(0, 12), slice(0, 12)), None),
    "3d up": ((60755, 30, 16, 16), (slice(0, 12), slice(12, None)), None),
    "3d pu": ((60755, 30, 16, 16), (slice(12, None), slice(0, 12)), None),
    "3d block-amg L0": ((30378, 20, 24, 24), None, None),
    "3d block-amg L1": ((3100, 16, 24, 24), None, None),
    "3d block-amg L2": ((320, 12, 24, 24), None, None),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("site", list(SITES))
def test_every_site_gets_a_plan(site, dtype):
    """The plan is a plain function of the shape: every site of the two
    slices gets one that reads 16-byte chunks where rows allow it and
    keeps enough lanes busy: the large sites share each gathered x chunk
    over several rows, the small levels split each row's blocks."""
    shape, view, w0 = SITES[site]
    A = torch.empty(shape, dtype=dtype)  # never touched: no pages used
    if view is not None:
        A = A[:, :, view[0], view[1]]
    x_split = None if w0 is None else (0, w0)
    p = launch_plan(A, x_split)
    ns, Kg, R, C = A.shape
    sz = A.element_size()
    assert p.vec == (16 // sz if C * sz % 16 == 0 else 1)
    assert p.cv * p.vec == C
    assert 1 <= p.lanes <= 32 and p.lanes & (p.lanes - 1) == 0
    assert 1 <= p.ks <= Kg and p.cv * p.ks <= p.lanes
    assert p.rpl in (1, 2) and R % p.rpl == 0
    lanes = ns * R // p.rpl * p.lanes
    if p.vec == 1:  # one value a lane: a lane's blocks in one round
        assert p.rpl == 1 and p.ks * UNROLL_SCALAR >= Kg
    if ns < 1000:  # the small levels: blocks split over lanes
        assert p.ks > 1
    assert lanes >= LANES_WANTED or p.lanes == 32 or p.ks == Kg
    assert launch_plan(A, x_split) == p  # the same plan every call


def test_split_off_the_chunk_grid_reads_values():
    """An x split whose first width is not a whole number of 16-byte
    chunks takes one value per lane, so no chunk straddles the split."""
    A = torch.empty((4, 3, 12, 12))
    assert launch_plan(A, (0, 8)).vec == 4
    assert launch_plan(A, (0, 6)).vec == 1


@pytest.mark.parametrize("cut", ["offset 1", "width 6", "last stride 2"])
def test_unaligned_view_raises(cut):
    A = torch.empty((4, 3, 12, 12))
    view = {"offset 1": A[:, :, :, 1:5], "width 6": A[:, :, :, :6],
            "last stride 2": A[:, :, :, ::2]}[cut]
    with pytest.raises(ValueError, match="sup_spmv"):
        launch_plan(view)
    launch_plan(A[:, :, :, 8:])  # the p column (+32 bytes) is aligned


@pytest.mark.parametrize("bad", ["x 2-d", "x too long", "jacobi split",
                                 "y split"])
def test_wrapper_rejects_bad_input(bad):
    A, cols, vec, *_ = _case("full 12x12 two segments", np.float64)
    cols = torch.as_tensor(cols)
    x = torch.as_tensor(vec["x"])
    kw = {}
    if bad == "x 2-d":
        x = torch.zeros((NS, 12), dtype=A.dtype)
    elif bad == "x too long":
        x = torch.zeros(NS * 12 + 1, dtype=A.dtype)
    elif bad == "jacobi split":
        kw = dict(mode="jacobi", b=x[:NS * 12], d=x[:NS * 12],
                  x_split=(NS * 8, 8))
        x = x[:NS * 12]
    else:
        kw = dict(y_split=(NS * 12, 12))
    with pytest.raises(ValueError, match="sup_spmv"):
        sup_spmv(A, cols, x, NS * 12, **kw)


# K1's prolong option: the coarse-grid correction of a V-cycle read in
# the gather (K8 folded into the post-smooth launch), at the SELFP AMG's
# width (w = 1, 8x8 blocks) and BlockAMG's (w = 2, 16x16; in 3D w = 3,
# 24x24)
PROLONG = {1: "amg 8x8", 2: "block-amg 16x16", 3: "block-amg 24x24"}
N_COARSE = 5


def _prolong_case(w, seed=0):
    """A square level whose x ends inside a supernode, 3 nodes short of
    ns*g (not a whole number of 16-byte chunks), with padded slots; its
    aggregates and a coarse vector."""
    A, cols, _, _, _, _ = _case(PROLONG[w], np.float64, seed)
    rng = np.random.default_rng(seed + 50)
    m = NS * A.shape[3] - 3 * w
    vec = {k: torch.as_tensor(rng.standard_normal(m)) for k in ("x", "b")}
    vec["d"] = torch.as_tensor(1.0 + rng.random(m))
    vec["s"] = torch.as_tensor(0.5 + rng.random(m))
    agg = torch.as_tensor(rng.integers(0, N_COARSE, m // w).astype(np.int32))
    xc = torch.as_tensor(rng.standard_normal(N_COARSE * w))
    return A, torch.as_tensor(cols), vec, (xc, agg, w), m


@pytest.mark.parametrize("scaled", [False, True], ids=["x", "s*x"])
@pytest.mark.parametrize("mode", ["residual", "jacobi"])
@pytest.mark.parametrize("w", [1, 2, 3])
def test_prolong_is_k8_then_k1(w, mode, scaled):
    """sup_spmv(prolong=(xc, agg, w)) is K8's plain version followed by
    K1's on its output, bit for bit, and within 1e-12 of cfdtpu's einsum
    on xhat = base + xc[agg] (numpy)."""
    A, cols, v, pro, m = _prolong_case(w)
    scale = v["s"] if scaled else None
    kw = dict(mode=mode, b=v["b"], d=v["d"], omega=0.67)
    kernels.reset_counts()
    got = sup_spmv(A, cols, v["x"], m, scale=scale, prolong=pro, **kw)
    assert kernels.counts()["sup_spmv"] == 0  # CPU tensors: no launch
    xhat = amg_prolong_plain(*pro, v["x"], scale)
    assert torch.equal(got, sup_spmv_plain(A, cols, xhat, m, **kw))
    xc, agg, _ = (t.numpy() if torch.is_tensor(t) else t for t in pro)
    base = v["x"].numpy() * (1.0 if scale is None else scale.numpy())
    xh = base + xc.reshape(-1, w)[agg].reshape(-1)
    y = np.asarray(_jnp_reference(A.numpy(), cols.numpy(), jnp.asarray(xh),
                                  None, None, m))
    b, d = v["b"].numpy(), v["d"].numpy()
    ref = b - y if mode == "residual" else xh + 0.67 * (b - y) / d
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("w", [1, 2, 3])
def test_prolong_xhat_out_is_k8(w):
    """xhat_out receives K8's plain output, the vector the launch read
    (BlockAMG's finest level with the RAS smoother)."""
    A, cols, v, pro, m = _prolong_case(w, seed=1)
    xhat = torch.full((m,), float("nan"), dtype=A.dtype)
    r = sup_spmv(A, cols, v["x"], m, mode="residual", b=v["b"], prolong=pro,
                 xhat_out=xhat)
    ref = amg_prolong_plain(*pro, v["x"])
    assert torch.equal(xhat, ref)
    assert torch.equal(r, sup_spmv_plain(A, cols, ref, m, mode="residual",
                                         b=v["b"]))


@pytest.mark.parametrize("bad", ["mode y", "mask", "x split", "y split",
                                 "width", "xhat without prolong"])
def test_prolong_refuses_what_is_not_built(bad):
    """The kernel is built for prolong in modes residual and jacobi on a
    square level of one flat x, with scale or without, never with a
    mask: the wrapper refuses every other combination, on any device."""
    A, cols, v, pro, m = _prolong_case(2, seed=2)
    kw = dict(mode="jacobi", b=v["b"], d=v["d"], prolong=pro)
    if bad == "mode y":
        kw = dict(prolong=pro)
    elif bad == "mask":
        kw["mask"] = torch.zeros(m, dtype=torch.bool)
    elif bad == "x split":
        kw.update(mode="residual", d=None, x_split=(m - 16, 8))
    elif bad == "y split":
        kw.update(mode="residual", d=None, y_split=(m - 16, 8))
    elif bad == "width":
        kw["prolong"] = (pro[0], pro[1], 3)
    else:
        kw = dict(mode="residual", b=v["b"],
                  xhat_out=torch.empty(m, dtype=A.dtype))
    with pytest.raises(ValueError, match="sup_spmv"):
        sup_spmv(A, cols, v["x"], m, **kw)
