"""A tetrahedral mesh through the harness's mesh-to-program path: the
program gets a `tetrahedron` Mesh of the same points and cells and
steps on it; a mesh of other widths, or one the program would renumber,
is refused."""

import numpy as np
import pytest

from benchmark import cell as cellmod

from cfdtpu_torch.scenarios.base import Scenario
from cfdtpu_torch.spaces import BoundaryCondition

# the six tetrahedra of a cube's Kuhn split, as paths along the axes
KUHN = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))
LID, WALL = 1, 2
N = 4  # cubes along each axis: 125 nodes, 384 tetrahedra, 500 DOF


def box_mesh(n=N):
    """The unit cube cut into n^3 cubes of six tetrahedra each, in the
    layout a generator returns (benchmark/meshes), facets tagged LID at
    z = 1 and WALL elsewhere."""
    g = np.arange(n + 1)
    ijk = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    points = ijk / n
    node = lambda c: (c[..., 0] * (n + 1) + c[..., 1]) * (n + 1) + c[..., 2]
    corner = ijk[(ijk < n).all(axis=1)]
    cells = []
    for path in KUHN:
        c = corner.copy()
        tet = [node(c)]
        for axis in path:
            c = c.copy()
            c[:, axis] += 1
            tet.append(node(c))
        cells.append(np.stack(tet, axis=1))
    cells = np.concatenate(cells).astype(np.int64)
    # boundary facets: local facet i opposite vertex i, met by one cell
    local = np.array([[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]])
    faces = cells[:, local].reshape(-1, 3)
    _, first, counts = np.unique(np.sort(faces, axis=1), axis=0,
                                 return_index=True, return_counts=True)
    rows = np.sort(first[counts == 1])
    facets, fcells, flocal = faces[rows], rows // 4, rows % 4
    # outward: (v1 - v0) x (v2 - v0) away from the cell's centroid
    v = points[facets]
    normal = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    out = v.mean(axis=1) - points[cells[fcells]].mean(axis=1)
    flip = (normal * out).sum(axis=1) < 0
    facets[flip] = facets[flip][:, [0, 2, 1]]
    tags = np.where(np.isclose(v[:, :, 2], 1.0).all(axis=1), LID, WALL)
    return {"points": points, "cells": cells, "facets": facets,
            "facet_cells": fcells, "facet_local_index": flocal,
            "facet_tags": tags.astype(np.int32)}


def in_program_order(mesh):
    """The mesh with its nodes in the program's space-filling-curve
    order, which the program then keeps."""
    from cfdtpu_torch.mesh.mesh import _sfc_key

    perm = np.argsort(_sfc_key(mesh["points"]), kind="stable")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return {**mesh, "points": mesh["points"][perm],
            "cells": inv[mesh["cells"]], "facets": inv[mesh["facets"]]}


class LidCube(Scenario):
    """The lid-driven cube: no slip on five faces, u = (1, 0, 0) on the
    lid at z = 1 (its rim held by the walls), Re = 1 / mu. The harness
    gives it its mesh."""

    def __init__(self, solver_name, dt, T, *, rho=1.0, mu=0.01,
                 dtype="float64", device=None, **solver_kwargs):
        self._bcu = None
        super().__init__(solver_name, "lid_cube", rho, mu, dt, T,
                         (0.0, 0.0, 0.0), device=device, **solver_kwargs)
        self.setup()

    @property
    def bcu(self):
        if self._bcu is None:
            m = self.mesh
            lid = BoundaryCondition(lambda x: np.vstack(
                (np.ones(x.shape[1]), np.zeros((2, x.shape[1])))))
            lid.initTopological(2, m.tagged_facets(LID))
            wall = BoundaryCondition(np.zeros(3))
            wall.initTopological(2, m.tagged_facets(WALL))
            self._bcu = [lid, wall]
        return self._bcu

    @property
    def bcp(self):
        return []

    def initial_velocity(self, x):
        return np.zeros((3, x.shape[1]))


CONFIG = {
    "scenario": f"{__name__}:LidCube", "solver": "stabilized_schur",
    "dtype": "float64", "scenario_kw": {"rho": 1.0, "mu": 0.01},
    "solver_kw": {"pc_inner_method": "rasamg_sup", "pc_inner_u": 0,
                  "pc_inner_p": 5, "pc_ras_size": 32, "ksp_restart": 20},
}
CELL = {"dt": 0.01, "early_stop_tolerance": 0.0, "output_every": 100}


@pytest.fixture(scope="module")
def stepped(tmp_path_factory):
    """The lid-driven cube built through build_scenario and driven two
    steps by the harness's window."""
    mesh = in_program_order(box_mesh())
    sc = cellmod.build_scenario(CONFIG, CELL, mesh, None, "cpu")
    window = cellmod.Window(sc.solver, 1, 0.0)
    cellmod.run_window(sc, window, str(tmp_path_factory.mktemp("cube")))
    return mesh, sc, window


def test_box_mesh_is_a_closed_outward_surface():
    m = box_mesh()
    assert (len(m["points"]), len(m["cells"])) == (125, 384)
    x = m["points"]
    vol = np.linalg.det(x[m["cells"][:, 1:]] - x[m["cells"][:, :1]]) / 6
    assert np.allclose(np.abs(vol), 1 / 384)
    # the divergence theorem for the field x: the sum of x . n dS is
    # three times the volume
    v = x[m["facets"]]
    nds = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]) / 2
    assert np.isclose((v.mean(axis=1) * nds).sum(), 3.0)
    assert (m["facet_tags"] == LID).sum() == 2 * N * N


def test_tetrahedra_reach_the_program(stepped):
    mesh, sc, _ = stepped
    pm = sc.mesh
    assert str(pm.cell_type) == "tetrahedron" and pm.gdim == 3
    assert np.array_equal(pm.points, mesh["points"])
    assert np.array_equal(pm.cells, mesh["cells"])
    assert np.array_equal(pm.facets, mesh["facets"])
    assert sc.solver.V.num_global_dofs + sc.solver.Q.num_global_dofs == 500


def test_tetrahedra_take_two_steps(stepped):
    _, sc, window = stepped
    assert window.error is None and window.failed == 0
    assert window.first is not None and len(window.steps) == 1
    assert window.steps[0]["converged"] and window.steps[0]["newton"] >= 1
    u = sc.solver.u_sol.numpy()
    assert u.shape == (125, 3) and np.isfinite(u).all()
    # the lid drags the flow: the largest speed is the lid's
    assert np.isclose(np.abs(u).max(), 1.0)


def test_a_mesh_out_of_program_order_is_refused():
    with pytest.raises(cellmod.CellError, match="renumbered"):
        cellmod.build_scenario(CONFIG, CELL, box_mesh(), None, "cpu")


@pytest.mark.parametrize("widths", [(2, 4), (3, 3), (1, 2), (3, 8)])
def test_mismatched_widths_are_refused(widths):
    mesh = {"points": np.zeros((5, widths[0])),
            "cells": np.zeros((2, widths[1]), dtype=np.int64)}
    with pytest.raises(cellmod.CellError, match=f"width {widths[0]} .* "
                       f"{widths[1]} vertices"):
        cellmod.cell_type(mesh)
    with pytest.raises(cellmod.CellError):
        cellmod.build_scenario(CONFIG, CELL, mesh, None, "cpu")
