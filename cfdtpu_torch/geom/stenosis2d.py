"""2D stenosed-channel geometry (cubic-Bezier bump, C1 tangent continuity).

Rebuild of the gmsh OCC geometry in
the reference's src/scenarios/stenosis.py:263-433: a channel tapering
linearly from radius R_in to R_out about the centerline y = R_in, with the
radius at x_position_stenosis further reduced to
R_min = (1 - severity) * r_taper(x_sten); the wall transitions through two
cubic Beziers whose handles follow the taper slope (C1 continuity),
handle length = tension * dist_x, dist_x = h_sten / slope clipped to stay
inside the channel (:291-292). Meshing uses the native Delaunay generator.
"""

from __future__ import annotations

import numpy as np

from ..mesh import Mesh
from .delaunay2d import generate_mesh_2d


def _bezier(p0, p1, p2, p3, t):
    t = np.asarray(t)[:, None]
    return (
        (1 - t) ** 3 * p0
        + 3 * (1 - t) ** 2 * t * p1
        + 3 * (1 - t) * t ** 2 * p2
        + t ** 3 * p3
    )


def stenosis_profile_params(
    L, R_in, R_out, x_position_stenosis, severity, slope, tension
):
    x_sten = x_position_stenosis
    r_taper_mid = R_in + (R_out - R_in) * (x_sten / L)
    R_min = (1.0 - severity) * r_taper_mid
    if R_min <= 0:
        raise ValueError(
            "severity too large: stenosis would close the channel"
        )
    h_sten = r_taper_mid - R_min
    dist_x = h_sten / slope if slope > 0 else L / 4
    dist_x = min(dist_x, min(x_sten, L - x_sten) * 0.95)
    return {
        "r_taper_mid": r_taper_mid,
        "R_min": R_min,
        "h_sten": h_sten,
        "dist_x": dist_x,
        "cp1_x": x_sten - dist_x,
        "cp2_x": x_sten + dist_x,
        "slope_top": (R_out - R_in) / L,
        "ha": tension * dist_x,
    }


def _wall_points(L, R_in, R_out, x_sten, prof, res, side: int):
    """Sample one wall left -> right. side=+1 top, -1 bottom."""

    def taper_r(x):
        return R_in + (R_out - R_in) * (x / L)

    cp1_x, cp2_x = prof["cp1_x"], prof["cp2_x"]
    s = prof["slope_top"] * side  # wall slope dy/dx away from stenosis
    ha = prof["ha"]
    y = lambda x, r: R_in + side * r

    p_start = np.array([0.0, y(0.0, R_in)])
    p_cp1 = np.array([cp1_x, y(cp1_x, taper_r(cp1_x))])
    p_mid = np.array([x_sten, y(x_sten, prof["R_min"])])
    p_cp2 = np.array([cp2_x, y(cp2_x, taper_r(cp2_x))])
    p_end = np.array([L, y(L, R_out)])

    def straight(a, b):
        n = max(1, int(round(np.linalg.norm(b - a) / res)))
        t = np.arange(n) / n
        return a[None] + t[:, None] * (b - a)[None]

    # Bezier control handles (reference :348-357); at the stenosis peak the
    # tangent also follows the taper slope for C1 continuity
    b1 = _bezier(
        p_cp1,
        p_cp1 + np.array([ha, ha * s]),
        p_mid - np.array([ha, ha * s]),
        p_mid,
        np.arange(max(2, int(round(2 * prof["dist_x"] / res))))
        / max(2, int(round(2 * prof["dist_x"] / res))),
    )
    b2 = _bezier(
        p_mid,
        p_mid + np.array([ha, ha * s]),
        p_cp2 - np.array([ha, ha * s]),
        p_cp2,
        np.arange(max(2, int(round(2 * prof["dist_x"] / res))))
        / max(2, int(round(2 * prof["dist_x"] / res))),
    )
    return np.concatenate(
        [straight(p_start, p_cp1), b1, b2, straight(p_cp2, p_end)]
    )


def generate_stenosis_mesh_2d(
    L=138.0,
    R_in=1.57,
    R_out=1.2,
    res=0.15,
    x_position_stenosis=30.0,
    severity=0.567,
    slope=0.4,
    tension=0.5,
    dtype=np.float64,
    inlet_marker=2,
    outlet_marker=3,
    wall_marker=4,
    **_ignored,
) -> Mesh:
    prof = stenosis_profile_params(
        L, R_in, R_out, x_position_stenosis, severity, slope, tension
    )
    top = _wall_points(L, R_in, R_out, x_position_stenosis, prof, res, +1)
    bot = _wall_points(L, R_in, R_out, x_position_stenosis, prof, res, -1)

    def vline(x, y0, y1):
        n = max(1, int(round(abs(y1 - y0) / res)))
        t = np.arange(n) / n
        return np.stack([np.full(n, x), y0 + t * (y1 - y0)], axis=-1)

    # closed CCW loop: bottom wall L->R, outlet up, top wall R->L, inlet down
    loop = np.concatenate(
        [
            bot,
            vline(L, R_in - R_out, R_in + R_out),
            top[::-1],
            vline(0.0, 2 * R_in, 0.0),
        ]
    )
    # higher resolution near the throat
    x_sten, dist_x = x_position_stenosis, prof["dist_x"]

    def size_fn(x):  # batched: points along the LAST axis
        x = np.asarray(x)
        d = np.abs(x[..., 0] - x_sten)
        t = np.clip((d - dist_x) / (3 * dist_x), 0.0, 1.0)
        return res * (0.7 + 0.8 * t)

    mesh = generate_mesh_2d(loop, [], size_fn, dtype=dtype)
    mesh.mark_boundary_facets(
        lambda x: np.isclose(x[0], 0.0, atol=1e-9), inlet_marker
    )
    mesh.mark_boundary_facets(
        lambda x: np.isclose(x[0], L, atol=1e-9), outlet_marker
    )
    untagged = mesh.facet_tags == 0
    mesh.facet_tags[untagged] = wall_marker
    return mesh


def stenosis_radius_profile(
    L, R_in, R_out, x_position_stenosis, severity, slope, tension,
    n_samples=4000,
):
    """Channel radius R(x) including the Bezier bump, as interpolation
    tables (x_s, r_s). The Bezier x(t) is monotone; sampled densely and
    inverted by linear interpolation."""
    prof = stenosis_profile_params(
        L, R_in, R_out, x_position_stenosis, severity, slope, tension
    )
    top = _wall_points(
        L, R_in, R_out, x_position_stenosis, prof, L / n_samples, +1
    )
    xs = np.append(top[:, 0], L)
    rs = np.append(top[:, 1] - R_in, R_out)
    order = np.argsort(xs)
    return xs[order], rs[order]


def generate_stenosis_mesh_structured(
    L=138.0,
    R_in=1.57,
    R_out=1.2,
    res=0.15,
    x_position_stenosis=30.0,
    severity=0.567,
    slope=0.4,
    tension=0.5,
    dtype=np.float64,
    inlet_marker=2,
    outlet_marker=3,
    wall_marker=4,
    **_ignored,
) -> Mesh:
    """Structured (transfinite) stenosis mesh: a rectangular grid mapped so
    that y spans [R_in - R(x), R_in + R(x)] — the native analogue of the
    reference's setTransfiniteCurve meshing
    (the reference's src/scenarios/stenosis_pressure_structured.py:362-380).
    Radial point count is kept even for symmetry, as in the reference."""
    from ..mesh import create_rectangle

    xs, rs = stenosis_radius_profile(
        L, R_in, R_out, x_position_stenosis, severity, slope, tension
    )
    nx = max(8, int(round(L / res)))
    ny = max(4, int(round(2 * max(rs) / res)))
    ny += ny % 2  # even radial count
    m = create_rectangle((0.0, 0.0), (L, 1.0), (nx, ny), dtype=np.float64)
    r_at = np.interp(m.points[:, 0], xs, rs)
    y = R_in + (m.points[:, 1] - 0.5) * 2.0 * r_at
    pts = np.stack([m.points[:, 0], y], axis=-1)
    mesh = Mesh(
        points=pts.astype(dtype), cells=m.cells, cell_type=m.cell_type,
        dtype=np.dtype(dtype),
    )
    mesh.mark_boundary_facets(
        lambda x: np.isclose(x[0], 0.0, atol=1e-9), inlet_marker
    )
    mesh.mark_boundary_facets(
        lambda x: np.isclose(x[0], L, atol=1e-9), outlet_marker
    )
    mesh.facet_tags[mesh.facet_tags == 0] = wall_marker
    return mesh
