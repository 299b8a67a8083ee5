"""The DFG channel-and-cylinder mesh: a frozen copy of the program's
generator.

The benchmark makes its own input mesh, so that a change to the
program's generator cannot change what a cell measures, and hands the
same arrays to the program and to the reference. It follows the
program's generator step for step (graded candidate points, Delaunay,
six Lloyd passes, the Hilbert renumbering of the nodes, outward boundary
facets sorted by their vertices, the boundary markers), so that at equal
settings it gives the same mesh bit for bit (checked on the CPU in
benchmark/tests).

Everything it reads comes from the configuration: the channel's
`channel_length` and `channel_height`, the `cylinder_center` and
`cylinder_diameter`, and in its `mesh` group `res_scale` (sizes r/6 at
the cylinder and H/13 far off, times res_scale) and `markers` (the facet
tags of inlet, outlet, wall and obstacle). `make(config, cache_dir)`
returns a dict of numpy arrays: points (n, 2) in the configuration's
dtype, cells (nc, 3), facets (nf, 2) outward-oriented, facet_cells,
facet_local_index, facet_tags. Meshes are cached as .npz files under
`cache_dir`, keyed by every setting they depend on.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
from scipy.spatial import Delaunay, cKDTree

# local facets of a triangle, facet i opposite vertex i
TRI_FACETS = ((1, 2), (0, 2), (0, 1))
CACHE_VERSION = 2


def _polyline_loop(vertices, size_fn):
    vertices = np.asarray(vertices, dtype=float)
    pts = []
    nv = len(vertices)
    for i in range(nv):
        a, b = vertices[i], vertices[(i + 1) % nv]
        n = max(1, int(round(np.linalg.norm(b - a)
                             / float(size_fn(0.5 * (a + b))))))
        for k in range(n):
            pts.append(a + (b - a) * (k / n))
    return np.array(pts)


def _triangulate(outer, holes, size_fn, inside_fn, hole_fns,
                 smooth_iters=6, seed=0):
    """Points and triangles of the region inside `outer` minus the holes
    (float64)."""
    boundary = np.concatenate([outer] + holes, axis=0)
    n_bnd = len(boundary)
    spacings = np.linalg.norm(outer - np.roll(outer, -1, axis=0), axis=1)
    default_size = float(np.median(spacings))
    lo, hi = boundary.min(axis=0), boundary.max(axis=0)

    def region_mask(P):
        ok = np.asarray(inside_fn(P), dtype=bool)
        for hf in hole_fns:
            ok &= ~np.asarray(hf(P), dtype=bool)
        return ok

    smin = np.asarray(size_fn(boundary), dtype=float).min()
    smax = max(default_size, float(size_fn(0.5 * (lo + hi))))
    levels = max(1, int(np.ceil(np.log2(max(smax / smin, 1.0)))) + 1)
    rng = np.random.RandomState(seed)
    interior = []
    for k in range(levels):
        s = smax / (2 ** k)
        nx = int(np.ceil((hi[0] - lo[0]) / s)) + 1
        ny = int(np.ceil((hi[1] - lo[1]) / s)) + 1
        gx, gy = np.meshgrid(
            lo[0] + s * (np.arange(nx) + 0.5 * (k % 2)),
            lo[1] + s * (np.arange(ny) + 0.5 * (k % 2)),
            indexing="ij",
        )
        P = np.stack([gx.ravel(), gy.ravel()], axis=-1)
        P = P + rng.uniform(-0.12 * s, 0.12 * s, P.shape)
        sz = np.asarray(size_fn(P), dtype=float)
        band = (sz <= s * 1.42) & (sz > s * 0.71) if k < levels - 1 else (
            sz <= s * 1.42)
        interior.append(P[band])
    interior = np.concatenate(interior, axis=0)
    interior = interior[region_mask(interior)]
    d, _ = cKDTree(boundary).query(interior)
    interior = interior[d > 0.6 * np.asarray(size_fn(interior), dtype=float)]
    pts = np.concatenate([boundary, interior], axis=0)

    def triangulate(pts):
        cells = Delaunay(pts).simplices
        return cells[region_mask(pts[cells].mean(axis=1))]

    cells = triangulate(pts)
    retri_every = 2 if len(pts) > 100_000 else 1
    npts = len(pts)
    for it in range(smooth_iters):
        nbr_sum = np.zeros_like(pts)
        nbr_cnt = np.zeros(npts)
        for (a, b) in ((0, 1), (1, 2), (2, 0)):
            e0, e1 = cells[:, a], cells[:, b]
            for dd in range(2):
                nbr_sum[:, dd] += np.bincount(e0, weights=pts[e1, dd],
                                              minlength=npts)
                nbr_sum[:, dd] += np.bincount(e1, weights=pts[e0, dd],
                                              minlength=npts)
            nbr_cnt += (np.bincount(e0, minlength=npts)
                        + np.bincount(e1, minlength=npts))
        avg = nbr_sum / np.maximum(nbr_cnt, 1)[:, None]
        pts[n_bnd:] = avg[n_bnd:]
        if (it + 1) % retri_every == 0 or it == smooth_iters - 1:
            cells = triangulate(pts)
    used = np.unique(cells)
    remap = -np.ones(len(pts), dtype=np.int64)
    remap[used] = np.arange(len(used))
    return pts[used], remap[cells]


def hilbert_key(points: np.ndarray) -> np.ndarray:
    """2D Hilbert index of each point on a 2^14 grid over the bounding
    box, computed in the points' own dtype."""
    n = points.shape[0]
    bits = 14
    q = np.empty((2, n), dtype=np.int64)
    for d in range(2):
        x = points[:, d]
        r = np.ptp(x)
        r = r if r > 0 else 1.0
        q[d] = np.clip(((x - x.min()) / r * (2 ** bits - 1)).astype(np.int64),
                       0, 2 ** bits - 1)
    X, Y = q[0].copy(), q[1].copy()
    key = np.zeros(n, dtype=np.int64)
    s = 2 ** (bits - 1)
    while s > 0:
        rx = ((X & s) > 0).astype(np.int64)
        ry = ((Y & s) > 0).astype(np.int64)
        key += s * s * ((3 * rx) ^ ry)
        swap = ry == 0
        flip = swap & (rx == 1)
        X2 = np.where(flip, s - 1 - X, X)
        Y2 = np.where(flip, s - 1 - Y, Y)
        X, Y = np.where(swap, Y2, X2), np.where(swap, X2, Y2)
        s //= 2
    return key


def boundary_facets(points, cells):
    """Boundary edges (outward-oriented, sorted by vertex pair), the cell
    each belongs to and its local index there."""
    nc = len(cells)
    all_f = np.concatenate([cells[:, list(f)] for f in TRI_FACETS], axis=0)
    keys = np.sort(all_f, axis=1)
    _, first, counts = np.unique(keys, axis=0, return_index=True,
                                 return_counts=True)
    rows = first[counts == 1]
    fcells = (rows % nc).astype(np.int32)
    flocal = (rows // nc).astype(np.int32)
    fv = all_f[rows].astype(np.int32)
    outward = (points[fv].mean(axis=1)
               - points[cells[fcells]].mean(axis=1))
    t = points[fv[:, 1]] - points[fv[:, 0]]
    nrm = np.stack([t[:, 1], -t[:, 0]], axis=-1)
    flip = (nrm * outward).sum(axis=1) < 0
    fv[flip] = fv[flip][:, ::-1]
    order = np.lexsort(fv.T[::-1])
    return fv[order], fcells[order], flocal[order]


def _generate(geo, res_scale, markers, dtype):
    L, H = geo["L"], geo["H"]
    CX, CY = geo["center"]
    R = geo["R"]
    res_min = R / 6 * res_scale
    res_max = H / 13 * res_scale

    def size_fn(x):
        x = np.asarray(x)
        d = np.hypot(x[..., 0] - CX, x[..., 1] - CY) - R
        t = np.clip((d - R) / (2 * H - R), 0.0, 1.0)
        return res_min + (res_max - res_min) * t

    outer = _polyline_loop([(0, 0), (L, 0), (L, H), (0, H)], size_fn)
    nth = max(12, int(round(2 * np.pi * R / res_min)))
    th = np.linspace(0, 2 * np.pi, nth, endpoint=False)
    hole = np.stack([CX + R * np.cos(th), CY + R * np.sin(th)], axis=-1)
    pts, cells = _triangulate(
        outer, [hole], size_fn,
        inside_fn=lambda P: ((P[:, 0] > 0) & (P[:, 0] < L)
                             & (P[:, 1] > 0) & (P[:, 1] < H)),
        hole_fns=[lambda P: np.hypot(P[:, 0] - CX, P[:, 1] - CY) < R],
    )
    points = np.ascontiguousarray(pts.astype(dtype))
    cells = cells.astype(np.int32)
    # the nodes renumbered along the Hilbert curve
    perm = np.argsort(hilbert_key(points), kind="stable")
    inv = np.empty(len(perm), dtype=np.int64)
    inv[perm] = np.arange(len(perm))
    points = np.ascontiguousarray(points[perm])
    cells = np.ascontiguousarray(inv[cells].astype(np.int32))
    facets, fcells, flocal = boundary_facets(points, cells)
    on = {
        "inlet": lambda x: np.isclose(x[0], 0.0),
        "outlet": lambda x: np.isclose(x[0], L),
        "wall": lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], H),
        "obstacle": lambda x: np.hypot(x[0] - CX, x[1] - CY) < R + res_min,
    }
    tags = np.zeros(len(facets), dtype=np.int32)
    for name in ("inlet", "outlet", "wall", "obstacle"):
        mark = np.asarray(on[name](points.T))
        tags[mark[facets].all(axis=1)] = markers[name]
    return {"points": points, "cells": cells, "facets": facets,
            "facet_cells": fcells, "facet_local_index": flocal,
            "facet_tags": tags}


def geometry(config: dict) -> dict:
    """The channel and cylinder of a configuration: L, H, center, R."""
    cx, cy = (float(c) for c in config["cylinder_center"])
    return {"L": float(config["channel_length"]),
            "H": float(config["channel_height"]),
            "center": (cx, cy), "R": float(config["cylinder_diameter"]) / 2}


def make(config: dict, cache_dir: str | None = None) -> dict:
    """The configuration's mesh, from the cache when it holds it."""
    geo = geometry(config)
    res_scale = float(config["mesh"]["res_scale"])
    markers = {k: int(v) for k, v in config["mesh"]["markers"].items()}
    dtype = np.dtype(config["dtype"])
    path = None
    if cache_dir:
        key = hashlib.sha1(repr((CACHE_VERSION, geo, res_scale,
                                 sorted(markers.items()), dtype.name)
                                ).encode()).hexdigest()[:16]
        path = os.path.join(cache_dir, f"dfg_{key}.npz")
        if os.path.exists(path):
            with np.load(path) as z:
                return {k: z[k] for k in z.files}
    mesh = _generate(geo, res_scale, markers, dtype)
    if path:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{path}.partial"
        with open(tmp, "wb") as f:
            np.savez(f, **mesh)
        os.replace(tmp, path)
    return mesh
