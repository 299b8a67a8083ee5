"""The DFG channel around a cylinder (Schafer and Turek 1996): its
boundary data, its seeded start state and its reference.

Read from the configuration: `channel_length` L, `channel_height` H,
`cylinder_center`, `cylinder_diameter` (R its half), `u_max`, `rho`,
`mu`, `dtype` and the mesh's `markers`; from the cell: `dt` and
`perturbation`.

Boundary data: the parabolic inflow u_x = 4 u_max y (H - y) / H^2 on
the inlet, no slip on the walls and the obstacle (the last of inlet,
obstacle, wall wins on a shared node; all three are 0 at the corners),
p = 0 on the outlet's nodes.

The start state's base flow is the undisturbed channel flow led around
the obstacle: the stream function psi_0 = c(r) psi_P(y) + (1 - c(r))
psi_P(CY), with psi_P the Poiseuille profile's and c(r) = 1 - exp(-((r
- R) / R)^2), so the velocity vanishes on the obstacle and matches the
inlet profile to 1e-4 at the inlet; the Dirichlet nodes then take their
values exactly. A smooth start with no impulse: Crank-Nicolson does not
damp the oscillation that a start incompatible with the inflow excites
(rest with the inflow in place made the DFG 2D-2 march fail within 21
steps on the card).

The perturbation added to it is smooth and divergence-free, drawn from
the seed:

    u' = curl psi,  psi = (w_x w_y w_c)^2 * sum_k a_k sin(kx_k pi x / L
                                    + phi_k) sin(ky_k pi y / H + theta_k)

with w_x = x / L, w_y = 4 y (H - y) / H^2 and w_c = 1 - exp(-((r -
R) / R)^2), which vanish with their first derivatives on the inlet, the
walls and the obstacle, so the perturbation keeps the Dirichlet values.
Every seed has the same modes (kx, ky) and the same size, max |u'| =
`perturbation` * u_max: the seed draws only the amplitudes' signs and
weights and the phases. The pressure starts at 0.
"""

from __future__ import annotations

import numpy as np

from benchmark.meshes.dfg import geometry

MODES = ((1, 1), (2, 1), (1, 2), (3, 2), (5, 1), (4, 3))


def dirichlet(config, mesh):
    """(bc_u (n,) bool, g (n, 2), bc_p (n,) bool) in float64."""
    H = geometry(config)["H"]
    markers = config["mesh"]["markers"]
    x = np.asarray(mesh["points"], dtype=np.float64)
    facets = np.asarray(mesh["facets"], dtype=np.int64)
    tags = np.asarray(mesh["facet_tags"])
    n = len(x)
    g = np.zeros((n, 2))
    bc_u = np.zeros(n, dtype=bool)
    for name in ("inlet", "obstacle", "wall"):
        nodes = np.unique(facets[tags == markers[name]])
        bc_u[nodes] = True
        if name == "inlet":
            y = x[nodes, 1]
            g[nodes, 0] = (4 * float(config["u_max"]) * y * (H - y) / H ** 2)
            g[nodes, 1] = 0.0
        else:
            g[nodes] = 0.0
    bc_p = np.zeros(n, dtype=bool)
    bc_p[np.unique(facets[tags == markers["outlet"]])] = True
    return bc_u, g, bc_p


def reference(config, cell, mesh, device, dtype):
    """The plain reference of one time step (benchmark/reference/ns.py)
    on this problem, its arithmetic in `dtype`."""
    from benchmark.reference.ns import Problem

    phys = {"rho": config["rho"], "mu": config["mu"], "dt": cell["dt"],
            "eps": float(np.finfo(np.dtype(config["dtype"])).resolution)}
    return Problem(mesh, phys, *dirichlet(config, mesh), device=device,
                   dtype=dtype)


def _psi(x, y, a, phi, theta, geo):
    L, H, R = geo["L"], geo["H"], geo["R"]
    CX, CY = geo["center"]
    r = np.hypot(x - CX, y - CY)
    w = (x / L) * (4 * y * (H - y) / H ** 2) * (
        1 - np.exp(-((r - R) / R) ** 2))
    s = sum(ak * np.sin(kx * np.pi * x / L + ph) * np.sin(ky * np.pi * y / H
                                                         + th)
            for ak, (kx, ky), ph, th in zip(a, MODES, phi, theta))
    return w * w * s


def _channel_psi(x, y, u_max, geo):
    H, R = geo["H"], geo["R"]
    CX, CY = geo["center"]

    def psi_p(yy):
        return 4 * u_max / H ** 2 * (H * yy ** 2 / 2 - yy ** 3 / 3)

    c = 1 - np.exp(-((np.hypot(x - CX, y - CY) - R) / R) ** 2)
    return c * psi_p(y) + (1 - c) * psi_p(CY)


def _curl(fn, x, y):
    d = 1e-6
    ux = (fn(x, y + d) - fn(x, y - d)) / (2 * d)
    uy = -(fn(x + d, y) - fn(x - d, y)) / (2 * d)
    return np.stack([ux, uy], axis=1)


def start_state(config, cell, mesh, seed):
    """(u (n, 2), p (n,)) in float64: the base flow plus the seeded
    perturbation, the Dirichlet values at their nodes."""
    geo = geometry(config)
    u_max = float(config["u_max"])
    bc_u, g, _ = dirichlet(config, mesh)
    rng = np.random.default_rng(int(seed) % 2 ** 64)
    k = len(MODES)
    a = rng.uniform(0.5, 1.0, k) * rng.choice([-1.0, 1.0], k)
    phi = rng.uniform(0, 2 * np.pi, k)
    theta = rng.uniform(0, 2 * np.pi, k)
    points = mesh["points"]
    x = np.asarray(points[:, 0], np.float64)
    y = np.asarray(points[:, 1], np.float64)
    u = _curl(lambda xx, yy: _psi(xx, yy, a, phi, theta, geo), x, y)
    u *= float(cell["perturbation"]) * u_max / max(float(np.abs(u).max()),
                                                   1e-300)
    u += _curl(lambda xx, yy: _channel_psi(xx, yy, u_max, geo), x, y)
    u[bc_u] = g[bc_u]
    return u, np.zeros(len(points))
