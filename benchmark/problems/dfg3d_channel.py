"""The DFG 3D channel around a cylinder (Schafer and Turek 1996, 3D-1Z):
its boundary data, its seeded start state and its reference.

Read from the configuration: `channel_length` L, `channel_height` H (the
channel's height and depth: a square section), `cylinder_center` (CX,
CY), `cylinder_diameter` (R its half), `u_max` U_m, `rho`, `mu`, `dtype`
and the mesh's `markers`; from the cell: `dt` and `perturbation`.

Boundary data: the inflow u_x = 16 U_m y z (H - y)(H - z) / H^4 on the
inlet, no slip on the walls and the obstacle (the last of inlet,
obstacle, wall wins on a shared node; all three are 0 where they meet),
p = 0 on the outlet's nodes.

The start state's base flow is the 2D channel flow led around the
cylinder (benchmark/problems/dfg_channel.py: the stream function psi_0
= c(r) psi_P(y) + (1 - c(r)) psi_P(CY) of the parabolic profile of
maximum U_m) times w_z(z) = 4 z (H - z) / H^2: u = w_z (d psi_0 / dy,
-d psi_0 / dx, 0), which is divergence-free, equals the inflow at x = 0
(to 1e-4, as in 2D) and vanishes on the cylinder and the walls; the
Dirichlet nodes then take their values exactly. A smooth start with no
impulse, as in 2D.

The perturbation added to it is smooth and divergence-free, drawn from
the seed: the curl of the vector potential (phi, 0, psi),

    u' = (d psi / dy, d phi / dz - d psi / dx, -d phi / dy),
    psi = w^3 sum_k a_k s_k(x, y, z),  phi = w^3 sum_k b_k s'_k(x, y, z)

with s_k products of sines of the modes in MODES (phases drawn) and w =
(x / L) w_y w_z w_c, w_y = 4 y (H - y) / H^2, w_c = 1 - exp(-((r - R) /
R)^2): w vanishes on the inlet, the walls and the obstacle, so u' and
its first derivatives vanish there and the perturbation keeps the
Dirichlet values. Every seed has the same modes and the same size, max
|u'| = `perturbation` * U_m: the seed draws only the amplitudes' signs
and weights and the phases. The pressure starts at 0.
"""

from __future__ import annotations

import numpy as np

from benchmark.meshes.dfg import geometry
from benchmark.problems.dfg_channel import _channel_psi

MODES = ((1, 1, 1), (2, 1, 1), (1, 2, 1), (1, 1, 2), (3, 2, 1), (2, 1, 3))


def inflow(y, z, u_max, H):
    """The published inflow's u_x at (0, y, z)."""
    return 16 * u_max * y * z * (H - y) * (H - z) / H ** 4


def dirichlet(config, mesh):
    """(bc_u (n,) bool, g (n, 3), bc_p (n,) bool) in float64."""
    H = geometry(config)["H"]
    markers = config["mesh"]["markers"]
    x = np.asarray(mesh["points"], dtype=np.float64)
    facets = np.asarray(mesh["facets"], dtype=np.int64)
    tags = np.asarray(mesh["facet_tags"])
    n = len(x)
    g = np.zeros((n, 3))
    bc_u = np.zeros(n, dtype=bool)
    for name in ("inlet", "obstacle", "wall"):
        nodes = np.unique(facets[tags == markers[name]])
        bc_u[nodes] = True
        g[nodes] = 0.0
        if name == "inlet":
            g[nodes, 0] = inflow(x[nodes, 1], x[nodes, 2],
                                 float(config["u_max"]), H)
    bc_p = np.zeros(n, dtype=bool)
    bc_p[np.unique(facets[tags == markers["outlet"]])] = True
    return bc_u, g, bc_p


def reference(config, cell, mesh, device, dtype):
    """The plain reference of one time step (benchmark/reference/ns3d.py)
    on this problem, its arithmetic in `dtype`."""
    from benchmark.reference.ns3d import Problem

    phys = {"rho": config["rho"], "mu": config["mu"], "dt": cell["dt"],
            "eps": float(np.finfo(np.dtype(config["dtype"])).resolution)}
    return Problem(mesh, phys, *dirichlet(config, mesh), device=device,
                   dtype=dtype)


def _weight(x, y, z, geo):
    L, H, R = geo["L"], geo["H"], geo["R"]
    CX, CY = geo["center"]
    r = np.hypot(x - CX, y - CY)
    return ((x / L) * (4 * y * (H - y) / H ** 2) * (4 * z * (H - z) / H ** 2)
            * (1 - np.exp(-((r - R) / R) ** 2)))


def _potential(x, y, z, a, ph, geo):
    """w^3 sum_k a_k sin(kx pi x / L + ph_k0) sin(ky pi y / H + ph_k1)
    sin(kz pi z / H + ph_k2)."""
    L, H = geo["L"], geo["H"]
    s = sum(ak * np.sin(kx * np.pi * x / L + p[0])
            * np.sin(ky * np.pi * y / H + p[1])
            * np.sin(kz * np.pi * z / H + p[2])
            for ak, (kx, ky, kz), p in zip(a, MODES, ph))
    return _weight(x, y, z, geo) ** 3 * s


def _d(fn, x, y, z, axis, d=1e-6):
    e = [0.0, 0.0, 0.0]
    e[axis] = d
    return (fn(x + e[0], y + e[1], z + e[2])
            - fn(x - e[0], y - e[1], z - e[2])) / (2 * d)


def base_flow(config, x, y, z):
    """(n, 3): the 2D channel flow around the cylinder times w_z."""
    geo = geometry(config)
    H = geo["H"]
    u_max = float(config["u_max"])

    def psi0(xx, yy, zz):
        return _channel_psi(xx, yy, u_max, geo)

    wz = 4 * z * (H - z) / H ** 2
    return np.stack([wz * _d(psi0, x, y, z, 1), -wz * _d(psi0, x, y, z, 0),
                     np.zeros_like(x)], axis=1)


def start_state(config, cell, mesh, seed):
    """(u (n, 3), p (n,)) in float64: the base flow plus the seeded
    perturbation, the Dirichlet values at their nodes."""
    geo = geometry(config)
    u_max = float(config["u_max"])
    bc_u, g, _ = dirichlet(config, mesh)
    rng = np.random.default_rng(int(seed) % 2 ** 64)
    k = len(MODES)
    a = rng.uniform(0.5, 1.0, k) * rng.choice([-1.0, 1.0], k)
    b = rng.uniform(0.5, 1.0, k) * rng.choice([-1.0, 1.0], k)
    pa = rng.uniform(0, 2 * np.pi, (k, 3))
    pb = rng.uniform(0, 2 * np.pi, (k, 3))
    pts = np.asarray(mesh["points"], np.float64)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]

    def psi(xx, yy, zz):
        return _potential(xx, yy, zz, a, pa, geo)

    def phi(xx, yy, zz):
        return _potential(xx, yy, zz, b, pb, geo)

    u = np.stack([_d(psi, x, y, z, 1),
                  _d(phi, x, y, z, 2) - _d(psi, x, y, z, 0),
                  -_d(phi, x, y, z, 1)], axis=1)
    u *= float(cell["perturbation"]) * u_max / max(float(np.abs(u).max()),
                                                   1e-300)
    u += base_flow(config, x, y, z)
    u[bc_u] = g[bc_u]
    return u, np.zeros(len(pts))
