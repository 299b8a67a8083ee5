"""Stenosis + 2D vascular tree union meshing (native).

Rebuild of the mesh pipeline of
the reference's src/scenarios/stenosis_with_tree_2d.py:335-721, which
builds Bezier-walled channel polygons per branch and fuses them with OCC
boolean unions (fillets at bifurcations, :615-721). Without OCC, the
union domain is meshed implicitly:

- the domain indicator is `inside stenosis channel OR within radius r of
  any tree edge` (capsule test),
- boundary points are sampled analytically on the stenosis walls, branch
  side walls and terminal caps, dropping samples swallowed by another
  branch/channel (this removes interior overlap at bifurcations; the
  Lloyd smoothing of the Delaunay generator plays the role of the
  reference's fillets),
- graded interior points + Delaunay + centroid filtering produce the
  final triangulation.

Terminal caps are tagged as outlets; x = 0 as the inlet; the rest walls.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import Delaunay, cKDTree

from ..mesh import Mesh
from .stenosis2d import stenosis_profile_params, stenosis_radius_profile
from .tree.tree_2d import VascularTree2D


def _seg_dist(pts, a, b):
    """Distance from points (n,2) to segment ab."""
    ab = b - a
    t = np.clip(((pts - a) @ ab) / max(ab @ ab, 1e-30), 0.0, 1.0)
    proj = a + t[:, None] * ab
    return np.linalg.norm(pts - proj, axis=1)


def generate_stenosis_tree_mesh_2d(
    L=138.0,
    R_in=1.57,
    R_out=1.2,
    res=0.3,
    x_position_stenosis=30.0,
    severity=0.567,
    slope=0.4,
    tension=0.5,
    tree: VascularTree2D | None = None,
    dtype=np.float64,
    inlet_marker=2,
    outlet_marker=3,
    wall_marker=4,
    **_ignored,
) -> Mesh:
    if tree is None:
        tree = VascularTree2D(r_root=R_out).generate(
            (L, R_in), direction=0.0
        )

    xs, rs = stenosis_radius_profile(
        L, R_in, R_out, x_position_stenosis, severity, slope, tension
    )
    edges = [
        (np.asarray(tree.nodes[e["from"]], float),
         np.asarray(tree.nodes[e["to"]], float), float(e["radius"]))
        for e in tree.edges
    ]
    term_caps = []
    for t in tree.terminals:
        e = next(e for e in tree.edges if e["to"] == t)
        p0 = np.asarray(tree.nodes[e["from"]], float)
        p1 = np.asarray(tree.nodes[t], float)
        d = p1 - p0
        d = d / np.linalg.norm(d)
        n = np.array([-d[1], d[0]])
        term_caps.append((p1, n, float(e["radius"])))

    def in_channel(pts):
        r_at = np.interp(pts[:, 0], xs, rs, left=-1.0, right=-1.0)
        return (
            (pts[:, 0] >= 0) & (pts[:, 0] <= L)
            & (np.abs(pts[:, 1] - R_in) <= r_at)
        )

    def in_tree(pts, skip=None):
        inside = np.zeros(len(pts), dtype=bool)
        for k, (a, b, r) in enumerate(edges):
            if skip is not None and k == skip:
                continue
            inside |= _seg_dist(pts, a, b) <= r
        return inside

    def inside(pts):
        return in_channel(pts) | in_tree(pts)

    # ---- boundary samples -------------------------------------------
    bpts = []
    btag = []

    # stenosis walls (analytic profile) and inlet
    nw = max(16, int(round(L / (0.7 * res))))
    xw = np.linspace(0, L, nw, endpoint=False)
    rw = np.interp(xw, xs, rs)
    for sgn in (+1, -1):
        wall = np.stack([xw, R_in + sgn * rw], axis=-1)
        keep = ~in_tree(wall)
        bpts.append(wall[keep])
        btag.append(np.full(keep.sum(), wall_marker))
    ni = max(4, int(round(2 * R_in / (0.7 * res))))
    yi = np.linspace(0, 2 * R_in, ni + 1)
    bpts.append(np.stack([np.zeros_like(yi), yi], axis=-1))
    btag.append(np.full(len(yi), inlet_marker))

    # branch side walls
    for k, (a, b, r) in enumerate(edges):
        d = b - a
        ln = np.linalg.norm(d)
        d = d / ln
        n = np.array([-d[1], d[0]])
        ns = max(3, int(round(ln / (0.7 * res))))
        t = np.linspace(0, 1, ns, endpoint=False)
        for sgn in (+1, -1):
            w = a[None] + t[:, None] * (ln * d)[None] + sgn * r * n[None]
            keep = ~(in_channel(w) | in_tree(w, skip=k))
            bpts.append(w[keep])
            btag.append(np.full(keep.sum(), wall_marker))

    # terminal caps (outlets)
    for (p, n, r) in term_caps:
        nc = max(3, int(round(2 * r / (0.6 * res))) + 1)
        t = np.linspace(-r, r, nc)
        cap = p[None] + t[:, None] * n[None]
        bpts.append(cap)
        btag.append(np.full(len(cap), outlet_marker))

    boundary = np.concatenate(bpts, axis=0)
    btags = np.concatenate(btag)

    # dedupe nearly-coincident boundary points (junction overlaps)
    tree_b = cKDTree(boundary)
    pairs = tree_b.query_pairs(0.45 * res, output_type="ndarray")
    drop = np.zeros(len(boundary), dtype=bool)
    for i, j in pairs:
        if not drop[i]:
            drop[j] = True
    boundary = boundary[~drop]
    btags = btags[~drop]

    # ---- interior points --------------------------------------------
    lo = boundary.min(axis=0) - res
    hi = boundary.max(axis=0) + res
    rng = np.random.RandomState(0)
    cand = []
    s = res
    nx = int(np.ceil((hi[0] - lo[0]) / s)) + 1
    ny = int(np.ceil((hi[1] - lo[1]) / s)) + 1
    gx, gy = np.meshgrid(
        lo[0] + s * np.arange(nx), lo[1] + s * np.arange(ny),
        indexing="ij",
    )
    P = np.stack([gx.ravel(), gy.ravel()], axis=-1)
    P = P + rng.uniform(-0.15 * s, 0.15 * s, P.shape)
    P = P[inside(P)]
    d, _ = cKDTree(boundary).query(P)
    P = P[d > 0.55 * res]

    pts = np.concatenate([boundary, P], axis=0)
    n_bnd = len(boundary)

    def triangulate(pts):
        tri = Delaunay(pts)
        cells = tri.simplices
        cent = pts[cells].mean(axis=1)
        # drop slivers outside the domain and outside-bridge triangles
        ok = inside(cent)
        # drop degenerate triangles
        a = pts[cells[:, 1]] - pts[cells[:, 0]]
        b = pts[cells[:, 2]] - pts[cells[:, 0]]
        area = 0.5 * np.abs(a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0])
        ok &= area > 1e-6 * res * res
        return cells[ok]

    cells = triangulate(pts)
    for _ in range(6):
        nbr_sum = np.zeros_like(pts)
        nbr_cnt = np.zeros(len(pts))
        for (ia, ib) in [(0, 1), (1, 2), (2, 0)]:
            e0, e1 = cells[:, ia], cells[:, ib]
            np.add.at(nbr_sum, e0, pts[e1])
            np.add.at(nbr_sum, e1, pts[e0])
            np.add.at(nbr_cnt, e0, 1)
            np.add.at(nbr_cnt, e1, 1)
        avg = nbr_sum / np.maximum(nbr_cnt, 1)[:, None]
        pts[n_bnd:] = avg[n_bnd:]
        # clamp smoothed points that drifted outside back (reject move)
        bad = ~inside(pts[n_bnd:])
        cells = triangulate(pts)

    used = np.unique(cells)
    remap = -np.ones(len(pts), dtype=np.int64)
    remap[used] = np.arange(len(used))
    mesh = Mesh(
        points=pts[used].astype(dtype),
        cells=remap[cells].astype(np.int32),
        cell_type="triangle",
        dtype=np.dtype(dtype),
    )

    # ---- facet tagging ----------------------------------------------
    mids = mesh.midpoints_of_facets(np.arange(len(mesh.facets)))
    mesh.facet_tags[:] = wall_marker
    mesh.facet_tags[np.isclose(mids[:, 0], 0.0, atol=0.3 * res)] = (
        inlet_marker
    )
    for (p, n, r) in term_caps:
        d_ax = np.abs((mids - p) @ np.array([n[1], -n[0]]))
        d_lat = np.abs((mids - p) @ n)
        on_cap = (d_ax < 0.7 * res) & (d_lat <= r + 0.5 * res)
        mesh.facet_tags[on_cap] = outlet_marker
    return mesh
