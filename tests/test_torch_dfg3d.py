"""The DFG 3D-1Z case on P1 tetrahedra, on the CPU: the benchmark's
extruded mesh (benchmark/meshes/dfg3d.py), its start state
(benchmark/problems/dfg3d_channel.py), its plain reference
(benchmark/reference/ns3d.py) and the port's DFG 3D scenario
(cfdtpu_torch/scenarios/dfg_3d.py) through the harness's path.

Sizes: the cross-section at res_scale 4.0 in 2 layers (a few thousand
DOF) for the solves, 3.0 in 3 layers for the mesh's checks, and the
configuration's own size once, for its declared counts. The port and
the reference integrate with the same rules (14 points a tetrahedron, 6
a facet), so one float64 step of the port run to the rounding floor
agrees with the reference's within 1e-8.
"""

import os

import numpy as np
import pytest
import torch

from benchmark import cell as cellmod
from benchmark.checkpoint import write_checkpoint
from benchmark.meshes import dfg3d
from benchmark.problems import dfg3d_channel
from benchmark.reference.ns3d import Problem, gmres

torch.set_num_threads(1)

CELL = "dfg3d1z_developed"
SOLVE = {"dtype": "float64", "mesh": {"res_scale": 4.0, "layers": 2}}
CHECK = {"dtype": "float64", "mesh": {"res_scale": 3.0, "layers": 3}}
TIGHT = {"snes_rtol": 1e-13, "snes_atol": 1e-15, "snes_stol": 1e-15,
         "snes_lag_jacobian": False, "pc_lag_steps": 1, "stats_every": 1,
         "ksp_rtol": 1e-12}
SEED = 2 ** 31 + 977


def _resolve(patch, cache=None):
    _, _, cell, config = cellmod.resolve(CELL, config_patch=patch)
    mesh = dfg3d.make(config, cache_dir=cache)
    return cell, config, mesh


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    cache = str(tmp_path_factory.mktemp("mesh3d"))
    return _resolve(SOLVE, cache)


@pytest.fixture(scope="module")
def checked(tmp_path_factory):
    cache = str(tmp_path_factory.mktemp("mesh3d_check"))
    return _resolve(CHECK, cache)


# ---------------------------------------------------------------------
# (d) the generator
def test_the_configuration_declares_the_generators_size(tmp_path):
    """243,018 nodes, 1,367,718 tetrahedra and 972,072 DOF: the
    cross-section's 10,566 nodes in 23 planes, three tetrahedra a prism
    of its 20,723 triangles in 22 layers."""
    _, _, _, config = cellmod.resolve(CELL)
    mesh = dfg3d.make(config, cache_dir=str(tmp_path))
    m = config["mesh"]
    assert len(mesh["points"]) == m["nodes"] == 243018
    assert len(mesh["cells"]) == m["cells"] == 1367718
    assert 4 * len(mesh["points"]) == m["dofs"] == 972072
    assert mesh["points"].dtype == np.float32


def test_surface_is_closed_and_outward(checked):
    """The divergence theorem for the field x: the sum of x . n dS over
    the boundary facets is three times the volume."""
    _, _, mesh = checked
    x = mesh["points"].astype(np.float64)
    v = x[mesh["facets"]]
    nds = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]) / 2
    c = mesh["cells"]
    vol = np.einsum("ci,ci->c", np.cross(x[c[:, 1]] - x[c[:, 0]],
                                         x[c[:, 2]] - x[c[:, 0]]),
                    x[c[:, 3]] - x[c[:, 0]]) / 6
    assert vol.min() > 0  # positively oriented
    assert np.isclose((v.mean(axis=1) * nds).sum(), 3 * vol.sum(),
                      rtol=1e-12)
    # and each facet's normal points away from its cell
    out = v.mean(axis=1) - x[c[mesh["facet_cells"]]].mean(axis=1)
    assert ((nds * out).sum(axis=1) > 0).all()


def test_volume_is_the_extruded_cross_section(checked):
    """(L H - the polygon's area) H: the cylinder is the 2D generator's
    polygon of nth sides."""
    _, config, mesh = checked
    L, H, R = 2.5, 0.41, 0.05
    res_min = R / 6 * config["mesh"]["res_scale"]
    nth = max(12, int(round(2 * np.pi * R / res_min)))
    polygon = nth / 2 * R * R * np.sin(2 * np.pi / nth)
    x = mesh["points"].astype(np.float64)
    c = mesh["cells"]
    vol = np.einsum("ci,ci->c", np.cross(x[c[:, 1]] - x[c[:, 0]],
                                         x[c[:, 2]] - x[c[:, 0]]),
                    x[c[:, 3]] - x[c[:, 0]]).sum() / 6
    assert np.isclose(vol, (L * H - polygon) * H, rtol=1e-6)
    assert np.isclose(vol, (L * H - np.pi * R * R) * H, rtol=1e-3)


def test_every_boundary_facet_is_tagged(checked):
    _, config, mesh = checked
    tags = mesh["facet_tags"]
    markers = config["mesh"]["markers"]
    assert (tags != 0).all()
    assert set(np.unique(tags)) == set(markers.values())
    x = mesh["points"].astype(np.float64)
    fx = x[mesh["facets"]]
    inlet = tags == markers["inlet"]
    assert np.allclose(fx[inlet][..., 0], 0.0)
    assert np.allclose(fx[tags == markers["outlet"]][..., 0], 2.5)
    r = np.hypot(fx[..., 0] - 0.5, fx[..., 1] - 0.2)
    assert (r[tags == markers["obstacle"]] < 0.06).all()
    # the inlet is the whole 0.41 x 0.41 square
    a = np.linalg.norm(np.cross(fx[:, 1] - fx[:, 0], fx[:, 2] - fx[:, 0]),
                       axis=1) / 2
    assert np.isclose(a[inlet].sum(), 0.41 * 0.41, rtol=1e-12)


def test_prisms_conform(checked):
    """Every triangle of the tetrahedra is met by one cell (a boundary
    facet) or by two: neighbouring prisms cut their shared faces the
    same way."""
    _, _, mesh = checked
    c = mesh["cells"].astype(np.int64)
    faces = np.sort(c[:, np.array(dfg3d.TET_FACETS)].reshape(-1, 3), axis=1)
    _, counts = np.unique(faces, axis=0, return_counts=True)
    assert counts.max() == 2
    assert (counts == 1).sum() == len(mesh["facets"])
    # the facets' cells and local indices: facet i opposite vertex i
    local = np.array(dfg3d.TET_FACETS)[mesh["facet_local_index"]]
    own = np.take_along_axis(c[mesh["facet_cells"]], local, axis=1)
    assert np.array_equal(np.sort(own, axis=1),
                          np.sort(mesh["facets"], axis=1))


def test_nodes_are_in_the_programs_order(checked):
    from cfdtpu_torch.mesh.mesh import _sfc_key

    _, _, mesh = checked
    assert (np.diff(_sfc_key(mesh["points"])) >= 0).all()
    assert np.array_equal(dfg3d.morton_key(mesh["points"]),
                          _sfc_key(mesh["points"]))


# ---------------------------------------------------------------------
# (e) the start state
def test_start_state_keeps_the_dirichlet_data(checked):
    cell, config, mesh = checked
    u, p = dfg3d_channel.start_state(config, cell, mesh, SEED)
    bc_u, g, bc_p = dfg3d_channel.dirichlet(config, mesh)
    assert np.array_equal(u[bc_u], g[bc_u])
    assert (p == 0).all() and bc_p.any()
    x = mesh["points"].astype(np.float64)
    inlet = bc_u & (np.abs(x[:, 0]) < 1e-9)
    assert np.abs(u[inlet, 0] - dfg3d_channel.inflow(
        x[inlet, 1], x[inlet, 2], 0.45, 0.41)).max() == 0
    # the flow led around the cylinder speeds up beside it
    assert 0.45 <= u[:, 0].max() < 2 * 0.45


def _cell_divergence(mesh, u):
    """div and |grad u| of the P1 interpolant, cell by cell."""
    x = mesh["points"].astype(np.float64)
    c = mesh["cells"]
    J = np.stack([x[c[:, k]] - x[c[:, 0]] for k in (1, 2, 3)], axis=2)
    Ji = np.linalg.inv(J)  # rows: gradients of the barycentric coords 1..3
    du = np.stack([u[c[:, k]] - u[c[:, 0]] for k in (1, 2, 3)], axis=1)
    G = np.einsum("ckg,cki->cig", Ji, du)  # d u_i / d x_g
    return np.trace(G, axis1=1, axis2=2), np.linalg.norm(G, axis=(1, 2))


def _field(config, cell, points, seed):
    """The start state's velocity at any points (no Dirichlet nodes)."""
    at = {"points": points, "facets": np.zeros((0, 3), dtype=np.int64),
          "facet_tags": np.zeros(0, dtype=np.int32)}
    return dfg3d_channel.start_state(config, cell, at, seed)[0]


@pytest.mark.parametrize("pert", [0.0, 0.1], ids=["base", "perturbed"])
def test_start_state_is_divergence_free(checked, pert):
    """The field is divergence-free (central differences at points
    inside the channel), and its interpolant's divergence is
    discretisation error: it shrinks as the mesh is refined."""
    cell, config, mesh = checked
    cell = {**cell, "perturbation": pert}
    rng = np.random.default_rng(7)
    P = rng.uniform([0.02, 0.02, 0.02], [2.48, 0.39, 0.39], (400, 3))
    P = P[np.hypot(P[:, 0] - 0.5, P[:, 1] - 0.2) > 0.06]
    d = 1e-4
    # one call for every shifted point: the perturbation's size is set
    # by its largest value over the points it is given
    shifted = np.concatenate([P + s * d * e for e in np.eye(3)
                              for s in (1, -1)])
    u = _field(config, cell, shifted, SEED).reshape(3, 2, len(P), 3)
    grad = np.stack([(u[k, 0] - u[k, 1]) / (2 * d) for k in range(3)],
                    axis=2)  # [n, i, g]
    div = np.trace(grad, axis1=1, axis2=2)
    assert np.abs(div).max() <= 1e-5 * np.abs(grad).max()
    ratios = []
    for patch in (CHECK, {"dtype": "float64",
                          "mesh": {"res_scale": 2.0, "layers": 5}}):
        _, cfg, m = _resolve(patch)
        u, _ = dfg3d_channel.start_state(cfg, cell, m, SEED)
        div, g = _cell_divergence(m, u)
        ratios.append(np.abs(div).mean() / g.mean())
    assert ratios[1] < 0.8 * ratios[0]


def test_seeds_draw_signs_weights_and_phases_only(checked):
    cell, config, mesh = checked
    a, _ = dfg3d_channel.start_state(config, cell, mesh, 1)
    b, _ = dfg3d_channel.start_state(config, cell, mesh, 2)
    c, _ = dfg3d_channel.start_state(config, cell, mesh, 1)
    base, _ = dfg3d_channel.start_state(config, {**cell,
                                                 "perturbation": 0.0},
                                        mesh, 1)
    assert np.array_equal(a, c) and not np.array_equal(a, b)
    for u in (a, b):
        assert np.isclose(np.abs(u - base).max(), 0.1 * 0.45, rtol=1e-6)


# ---------------------------------------------------------------------
# (a) the port against the reference, (b) GMRES against LU
def _program(small, tmp_path, solver_kw):
    cell, config, mesh = small
    config = {**config, "solver_kw": {**config["solver_kw"], **solver_kw}}
    start = cellmod.start_state(config, cell, mesh, SEED)
    ckpt = os.path.join(str(tmp_path), "start.npz")
    write_checkpoint(ckpt, *start, np.float64)
    sc = cellmod.build_scenario(config, cell, mesh, ckpt, "cpu")
    return sc, start


class Stop(Exception):
    pass


@pytest.fixture(scope="module")
def stepped(small, tmp_path_factory):
    """One tight float64 step of the port from the seeded start, and the
    reference's from the same state."""
    cell, config, mesh = small
    tmp = tmp_path_factory.mktemp("dfg3d_step")
    sc, start = _program(small, tmp, TIGHT)
    s = sc.solver
    got = []

    def after(t):
        got.append((s.u_sol.numpy().copy(), s.p_sol.numpy().copy()))
        raise Stop

    with pytest.raises(Stop):
        sc.solve(str(tmp / "out"), afterStepCallback=after)
    prob = cellmod.make_problem(config, cell, mesh, "cpu")
    ref = prob.step(*start)
    return sc, prob, start, got[0], ref


def test_port_residual_is_the_references(stepped):
    sc, prob, start, _, _ = stepped
    s = sc.solver
    rng = np.random.default_rng(0)
    n = prob.n
    u = start[0] + 0.05 * rng.standard_normal((n, 3))
    p = 0.1 * rng.standard_normal(n)
    up = start[0] + 0.02 * rng.standard_normal((n, 3))
    ru, rp = s.form.residual(torch.tensor(u), torch.tensor(p),
                             (torch.tensor(up),), s.params())
    X = prob.flat(u, p).reshape(n, 4)
    Xp = prob.flat(up, p).reshape(n, 4)
    re = prob.element_residual(X[prob.cells], Xp[prob.cells])
    r = torch.zeros(n, 4, dtype=torch.float64).index_add(
        0, prob.cells.reshape(-1), re.reshape(-1, 4))
    assert float((r[:, :3] - ru).abs().max()) <= 1e-13 * float(
        ru.abs().max())
    assert float((r[:, 3] - rp).abs().max()) <= 1e-13 * float(
        rp.abs().max())
    assert np.array_equal(np.sort(s.bc_dofs_u), np.flatnonzero(prob.bc_u))
    assert np.array_equal(np.sort(s.bc_dofs_p), np.flatnonzero(prob.bc_p))
    assert s.form.quad_degree == 4 and s.form.tabs.qw.shape[0] == 14


def test_port_step_is_the_references(stepped):
    """(a): one step from the seeded start within 1e-8 in float64."""
    _, _, _, (u1, p1), (ur, pr, _) = stepped
    assert np.abs(u1 - ur).max() <= 1e-8 * np.abs(ur).max()
    assert np.abs(p1 - pr).max() <= 1e-8 * np.abs(pr).max()


def test_reference_gmres_is_its_lu(small):
    """(b): the reference's step with its GMRES solves against the same
    step with SciPy's LU, within 1e-9."""
    cell, config, mesh = small
    start = cellmod.start_state(config, cell, mesh, SEED + 1)
    args = (mesh, {"rho": 1.0, "mu": 1e-3, "dt": cell["dt"],
                   "eps": float(np.finfo(np.float32).resolution)},
            *dfg3d_channel.dirichlet(config, mesh))
    g = Problem(*args)
    lu = Problem(*args, solver="lu")
    ug, pg, _ = g.step(*start)
    ul, pl, _ = lu.step(*start)
    assert np.abs(ug - ul).max() <= 1e-9 * np.abs(ul).max()
    assert np.abs(pg - pl).max() <= 1e-9 * np.abs(pl).max()
    its = g.seconds["iterations"]
    assert its and 0 < max(its) < 3000
    assert lu.seconds["iterations"] == [0] * len(lu.seconds["iterations"])


def test_gmres_stops_at_its_cap_with_nan():
    """A solve that reaches the cap returns NaN, so that the judge fails
    a loose reference."""
    rng = np.random.default_rng(3)
    A = torch.as_tensor(rng.standard_normal((40, 40)))
    b = torch.as_tensor(rng.standard_normal(40))
    x, k = gmres(lambda v: A @ v, lambda v: v, b, 1e-10, 5)
    assert k == 5 and torch.isnan(x).all()
    x, k = gmres(lambda v: A @ v, lambda v: v, b, 1e-10, 40)
    assert k <= 40 and float((A @ x - b).norm()) <= 1e-9 * float(b.norm())
    x, k = gmres(lambda v: A @ v, lambda v: v, torch.zeros(40), 1e-10, 5)
    assert k == 0 and float(x.abs().max()) == 0.0


def test_dfg3d_scenario_on_its_own_mesh_through_the_cli(tmp_path):
    """`python -m cfdtpu_torch simulate --simulation dfg_3d ... --device
    cpu`: the scenario's own extruded mesh (geom/dfg3d.py), one step,
    c_D, c_L and dp written."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "cfdtpu_torch", "simulate",
           "--simulation", "dfg_3d", "--solver", "stabilized_schur",
           "--T", "0.05", "--dt", "0.05", "--res_scale", "5",
           "--layers", "2", "--dtype", "float64", "--device", "cpu",
           "--pc_inner_method", "amg_p", "--name", "cli",
           "--output_dir", str(tmp_path)]
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    res = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "Solver converged" in res.stdout
    found = {}
    for root, _, files in os.walk(tmp_path):
        for name in ("drag_lift.txt", "pressure_diff.txt"):
            if name in files:
                with open(os.path.join(root, name)) as f:
                    found[name] = f.read()
    assert "c_D:" in found["drag_lift.txt"]
    assert "Pressure difference:" in found["pressure_diff.txt"]
    values = [float(line.split(":")[1]) for text in found.values()
              for line in text.strip().splitlines()]
    assert np.isfinite(values).all()


def test_own_mesh_tags_every_facet():
    """geom/dfg3d.py: the scenario's own mesh, every boundary facet
    tagged, the walls over the obstacle where z = 0 and z = H meet the
    cylinder."""
    from cfdtpu_torch.geom.dfg3d import generate_dfg3d_mesh

    m = generate_dfg3d_mesh(res_scale=5.0, layers=2)
    assert str(m.cell_type) == "tetrahedron"
    assert (m.facet_tags != 0).all()
    fx = m.points[m.facets]
    obstacle = m.facet_tags == 5
    assert not np.isclose(fx[obstacle][..., 2], 0.0).all(axis=1).any()
    r = np.hypot(fx[obstacle][..., 0] - 0.5, fx[obstacle][..., 1] - 0.2)
    assert (r < 0.06).all()


def test_pressure_difference_in_float32_on_a_fine_cylinder():
    """DFG3DBenchmark.pressure_difference in float32 where both probes
    are nodes on the cylinder (an even number of layers) and the
    cylinder's cells are fine enough that the probes' float32 rounding
    puts them outside every cell: the probes read their nodes, and a
    pressure p = x gives dp = 0.45 - 0.55."""
    import torch

    from cfdtpu_torch.scenarios.dfg_3d import DFG3DBenchmark

    sc = DFG3DBenchmark("stabilized_schur", dt=0.05, T=0.05,
                        dtype="float32", device="cpu", res_scale=1.0,
                        layers=2, pc_inner_method="amg_p")
    s = sc.solver
    s.p_sol = torch.as_tensor(s.Q.mesh.points[:, 0].astype(np.float32))
    assert abs(sc.pressure_difference() + 0.1) < 1e-6
