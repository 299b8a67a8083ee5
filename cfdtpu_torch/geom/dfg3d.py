"""DFG 3D channel-with-cylinder geometry (Schafer and Turek 1996, 3D-1Z
and 3D-2Z): a 2.5 x 0.41 x 0.41 channel with a cylinder of diameter 0.1
whose axis runs along z through (0.5, 0.2), meshed as the DFG graded
cross-section extruded into P1 tetrahedra.

The cross-section grades from r/6 at the cylinder to H/13 within 2H
(times res_scale), as geom/dfg.py's 2D mesh; `layers` uniform layers
span the depth H, and each prism is cut into three tetrahedra by the
global vertex-number rule (with its triangle's vertices a < b < c:
(A, B, C, A'), (B, C, A', B'), (C, A', B', C'), bottom and top), which
cuts each quadrilateral face the same way from both prisms that share
it.
"""

from __future__ import annotations

import numpy as np

from ..mesh import Mesh
from .delaunay2d import generate_mesh_2d, polyline_loop

L = 2.5
H = 0.41
CX, CY = 0.5, 0.2
R = 0.05


def extrude_prisms(points2, tris, depth: float, layers: int):
    """Points (n2 (layers + 1), 3) and positively oriented tetrahedra
    (3 nt layers, 4) of the prisms over the triangles: node k n2 + i is
    2D node i at z = k depth / layers."""
    n2 = len(points2)
    pts = np.concatenate([np.column_stack([points2, np.full(n2, zk)])
                          for zk in np.arange(layers + 1) * (depth
                                                             / layers)])
    a, b, c = np.sort(np.asarray(tris), axis=1).T.astype(np.int64)
    cells = []
    for k in range(layers):
        lo, hi = k * n2, (k + 1) * n2
        A, B, C, At, Bt, Ct = a + lo, b + lo, c + lo, a + hi, b + hi, c + hi
        cells.append(np.stack([np.stack([A, B, C, At], 1),
                               np.stack([B, C, At, Bt], 1),
                               np.stack([C, At, Bt, Ct], 1)],
                              1).reshape(-1, 4))
    cells = np.concatenate(cells)
    x = pts[cells]
    vol = np.einsum("ci,ci->c", np.cross(x[:, 1] - x[:, 0],
                                         x[:, 2] - x[:, 0]),
                    x[:, 3] - x[:, 0])
    neg = vol < 0
    cells[neg] = cells[neg][:, [0, 2, 1, 3]]
    return pts, cells


def generate_dfg3d_mesh(res_scale: float = 1.0, layers: int = 16,
                        dtype=np.float64, inlet_marker=2, outlet_marker=3,
                        wall_marker=4, obstacle_marker=5) -> Mesh:
    """The DFG 3D channel on P1 tetrahedra, its boundary facets tagged
    inlet (x = 0), outlet (x = L), wall (y = 0, H and z = 0, H) and
    obstacle."""
    res_min = R / 6 * res_scale
    res_max = H / 13 * res_scale

    def size_fn(x):
        x = np.asarray(x)
        d = np.hypot(x[..., 0] - CX, x[..., 1] - CY) - R
        t = np.clip((d - R) / (2 * H - R), 0.0, 1.0)
        return res_min + (res_max - res_min) * t

    outer = polyline_loop([(0, 0), (L, 0), (L, H), (0, H)], size_fn)
    nth = max(12, int(round(2 * np.pi * R / res_min)))
    th = np.linspace(0, 2 * np.pi, nth, endpoint=False)
    hole = np.stack([CX + R * np.cos(th), CY + R * np.sin(th)], axis=-1)
    sec = generate_mesh_2d(
        outer, [hole], size_fn, dtype=np.float64,
        inside_fn=lambda P: ((P[:, 0] > 0) & (P[:, 0] < L)
                             & (P[:, 1] > 0) & (P[:, 1] < H)),
        hole_fns=[lambda P: np.hypot(P[:, 0] - CX, P[:, 1] - CY) < R])
    pts, cells = extrude_prisms(sec.points, sec.cells, H, int(layers))
    m = Mesh(points=pts, cells=cells, cell_type="tetrahedron", dtype=dtype)
    tol = 1e-6
    m.mark_boundary_facets(lambda x: np.abs(x[0]) < tol, inlet_marker)
    m.mark_boundary_facets(lambda x: np.abs(x[0] - L) < tol, outlet_marker)
    m.mark_boundary_facets(
        lambda x: np.hypot(x[0] - CX, x[1] - CY) < R + res_min,
        obstacle_marker)
    # the walls last, each plane apart: the planes z = 0 and z = H meet
    # the cylinder, and a corner triangle of the inlet has its vertices on
    # different walls
    for axis, at in ((1, 0.0), (1, H), (2, 0.0), (2, H)):
        m.mark_boundary_facets(
            lambda x, axis=axis, at=at: np.abs(x[axis] - at) < tol,
            wall_marker)
    return m
