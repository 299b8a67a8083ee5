"""The DFG 3D channel-and-cylinder mesh: the frozen 2D generator's
cross-section extruded into P1 tetrahedra.

The cross-section is benchmark/meshes/dfg.py's mesh of the
configuration's channel (`channel_length` L, `channel_height` H,
`cylinder_center`, `cylinder_diameter`) at `mesh.res_scale`; the channel
is H deep in z (Schafer and Turek 1996, 3D-1Z: a square section, the
cylinder's axis along z). It is extruded into `mesh.layers` uniform
layers of depth H / layers, and each prism is cut into three tetrahedra
by the global vertex-number rule: with its triangle's vertices a < b < c
(bottom A, B, C, top A', B', C') the tetrahedra are (A, B, C, A'), (B,
C, A', B') and (C, A', B', C'), so each quadrilateral face is cut along
the diagonal from the bottom of its larger vertex to the top of its
smaller one, the same cut from both prisms that share it. Tetrahedra
are positively oriented.

Boundary facets: the triangles that one tetrahedron alone has, ordered
so that (v1 - v0) x (v2 - v0) points out of the domain, with their cell
and local index there (facet i opposite vertex i), sorted by their
vertices, and tagged with the configuration's `mesh.markers`: inlet (x
= 0), outlet (x = L), wall (y = 0, y = H, z = 0, z = H) and obstacle
(within R + the cylinder's mesh size of the axis); every boundary facet
gets one of them (the walls win over the obstacle where the planes z = 0
and z = H meet the cylinder).

The nodes come in the program's order, the 3D Morton order of
cfdtpu_torch/mesh/mesh.py (10 bits an axis over the bounding box,
computed on the points in the configuration's dtype), frozen here so
that a change to the program's numbering cannot change what the cell
measures (benchmark.cell.build_scenario refuses a mesh the program
renumbers). `make(config, cache_dir)` returns the arrays that
benchmark/meshes/__init__.py describes and caches them as .npz files
keyed by every setting they depend on.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from benchmark.meshes import dfg

# local facets of a tetrahedron, facet i opposite vertex i
TET_FACETS = ((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2))
CACHE_VERSION = 3
MORTON_BITS = 10


def morton_key(points: np.ndarray) -> np.ndarray:
    """3D Morton index of each point on a 2^10 grid a side over the
    bounding box, computed in the points' own dtype."""
    n = points.shape[0]
    q = np.empty((3, n), dtype=np.int64)
    for d in range(3):
        x = points[:, d]
        r = np.ptp(x)
        r = r if r > 0 else 1.0
        q[d] = np.clip(((x - x.min()) / r
                        * (2 ** MORTON_BITS - 1)).astype(np.int64),
                       0, 2 ** MORTON_BITS - 1)
    z = np.zeros(n, dtype=np.int64)
    for b in range(MORTON_BITS):
        for d in range(3):
            z |= ((q[d] >> b) & 1) << (3 * b + d)
    return z


def extrude(points2, tris, depth, layers):
    """Points (n2 (layers + 1), 3) and positively oriented tetrahedra (3
    nt layers, 4) of the prisms over the triangles, node k n2 + i the 2D
    node i at z = k depth / layers."""
    n2 = len(points2)
    z = np.arange(layers + 1) * (depth / layers)
    points = np.concatenate([np.column_stack([points2,
                                              np.full(n2, zk)])
                             for zk in z])
    a, b, c = np.sort(tris, axis=1).T.astype(np.int64)
    cells = []
    for k in range(layers):
        lo, hi = k * n2, (k + 1) * n2
        A, B, C = a + lo, b + lo, c + lo
        At, Bt, Ct = a + hi, b + hi, c + hi
        cells.append(np.stack([
            np.stack([A, B, C, At], 1),
            np.stack([B, C, At, Bt], 1),
            np.stack([C, At, Bt, Ct], 1)], 1).reshape(-1, 4))
    cells = np.concatenate(cells)
    x = points[cells]
    vol = np.einsum("ci,ci->c", np.cross(x[:, 1] - x[:, 0],
                                         x[:, 2] - x[:, 0]),
                    x[:, 3] - x[:, 0])
    neg = vol < 0
    cells[neg] = cells[neg][:, [0, 2, 1, 3]]
    return points, cells


def boundary_facets(points, cells):
    """Boundary triangles (outward, sorted by their vertices), the cell
    of each and its local index there."""
    nc, n = len(cells), len(points)
    faces = cells[:, np.array(TET_FACETS)].reshape(-1, 3)  # cell-major
    s = np.sort(faces, axis=1).astype(np.int64)
    key = (s[:, 0] * n + s[:, 1]) * n + s[:, 2]
    _, first, counts = np.unique(key, return_index=True, return_counts=True)
    rows = first[counts == 1]
    fcells, flocal = rows // 4, rows % 4
    fv = faces[rows].copy()
    v = points[fv]
    nrm = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    out = v.mean(axis=1) - points[cells[fcells]].mean(axis=1)
    flip = (nrm * out).sum(axis=1) < 0
    fv[flip] = fv[flip][:, [0, 2, 1]]
    order = np.lexsort(fv.T[::-1])
    return (fv[order].astype(np.int32), fcells[order].astype(np.int32),
            flocal[order].astype(np.int32))


def _generate(geo, res_scale, layers, markers, dtype):
    L, H = geo["L"], geo["H"]
    CX, CY = geo["center"]
    R = geo["R"]
    sec = dfg._generate(geo, res_scale, markers, np.float64)
    points, cells = extrude(sec["points"].astype(np.float64),
                            sec["cells"], H, layers)
    # the program's node order, from the points as it holds them
    points = np.ascontiguousarray(points.astype(dtype))
    perm = np.argsort(morton_key(points), kind="stable")
    inv = np.empty(len(perm), dtype=np.int64)
    inv[perm] = np.arange(len(perm))
    points = np.ascontiguousarray(points[perm])
    cells = np.ascontiguousarray(inv[cells].astype(np.int32))
    facets, fcells, flocal = boundary_facets(points.astype(np.float64),
                                             cells)
    x = points.astype(np.float64).T
    tol = 1e-6 * max(L, H)
    res_min = R / 6 * res_scale
    # a facet is on a part when its three vertices are: each wall plane
    # apart, so that a triangle in a corner of the inlet, its vertices on
    # different walls, stays inlet
    on = {
        "inlet": [np.abs(x[0]) < tol],
        "outlet": [np.abs(x[0] - L) < tol],
        "obstacle": [np.hypot(x[0] - CX, x[1] - CY) < R + res_min],
        "wall": [np.abs(x[1]) < tol, np.abs(x[1] - H) < tol,
                 np.abs(x[2]) < tol, np.abs(x[2] - H) < tol],
    }
    tags = np.zeros(len(facets), dtype=np.int32)
    # the walls last: the planes z = 0 and z = H meet the cylinder, and
    # their facets near it are wall, not obstacle
    for name in ("inlet", "outlet", "obstacle", "wall"):
        for plane in on[name]:
            tags[plane[facets].all(axis=1)] = markers[name]
    return {"points": points, "cells": cells, "facets": facets,
            "facet_cells": fcells, "facet_local_index": flocal,
            "facet_tags": tags}


def make(config: dict, cache_dir: str | None = None) -> dict:
    """The configuration's mesh, from the cache when it holds it."""
    geo = dfg.geometry(config)
    res_scale = float(config["mesh"]["res_scale"])
    layers = int(config["mesh"]["layers"])
    markers = {k: int(v) for k, v in config["mesh"]["markers"].items()}
    dtype = np.dtype(config["dtype"])
    path = None
    if cache_dir:
        key = hashlib.sha1(repr((CACHE_VERSION, dfg.CACHE_VERSION, geo,
                                 res_scale, layers, sorted(markers.items()),
                                 dtype.name)).encode()).hexdigest()[:16]
        path = os.path.join(cache_dir, f"dfg3d_{key}.npz")
        if os.path.exists(path):
            with np.load(path) as z:
                return {k: z[k] for k in z.files}
    mesh = _generate(geo, res_scale, layers, markers, dtype)
    if path:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{path}.partial"
        with open(tmp, "wb") as f:
            np.savez(f, **mesh)
        os.replace(tmp, path)
    return mesh
