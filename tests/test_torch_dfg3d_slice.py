"""The DFG 3D scenario on P1 tetrahedra end to end against cfdtpu (JAX):
the port's DFG3DBenchmark (through the benchmark's mesh-to-program path)
and the same case built on cfdtpu's Scenario, on one small extruded
mesh (the cross-section at res_scale 6.0 in 2 layers), float64, from
rest, with the benchmark configuration's solver settings (Schur
fieldsplit with amg_p: GMRES(6) on the velocity block under node-block
Jacobi and the SELFP AMG on S; chord Newton, pc_lag_steps 4,
ksp_restart 20) at stats_every 1 and the 3D scenario's quadrature
(degree 4: 14 points a tetrahedron, 6 a facet), two steps.

Tolerance: both sides are float64 running the same algorithm; only the
order of floating-point sums differs. Newton and KSP counts per step
must be equal, and u and p agree to 1e-8 relative, as in the 2D slices.
"""

import numpy as np
import pytest
import torch

from benchmark import cell as cellmod
from benchmark.meshes import dfg3d

torch.set_num_threads(1)

TOL = 1e-8
STEPS = 2
PATCH = {"dtype": "float64", "mesh": {"res_scale": 6.0, "layers": 2}}


def jax_dfg3d(mesh, config, cell):
    """cfdtpu's Scenario on the benchmark's mesh: the DFG 3D boundary
    data of cfdtpu_torch/scenarios/dfg_3d.py, written with cfdtpu's
    classes."""
    from cfdtpu.mesh import Mesh
    from cfdtpu.scenarios.base import Scenario
    from cfdtpu.spaces import BoundaryCondition

    from cfdtpu_torch.scenarios.dfg_3d import QUAD_DEGREE

    jm = Mesh(points=mesh["points"], cells=mesh["cells"],
              cell_type="tetrahedron", facets=mesh["facets"],
              facet_cells=mesh["facet_cells"],
              facet_local_index=mesh["facet_local_index"],
              facet_tags=mesh["facet_tags"].copy(), dtype=np.float64)
    H, u_max = config["channel_height"], config["u_max"]
    mk = config["mesh"]["markers"]

    class JaxDFG3D(Scenario):
        inlet_marker, outlet_marker = mk["inlet"], mk["outlet"]
        wall_marker, obstacle_marker = mk["wall"], mk["obstacle"]

        def __init__(self, **kw):
            self._bcu = self._bcp = None
            super().__init__(config["solver"], "dfg_3d", config["rho"],
                             config["mu"], cell["dt"], 1.0, (0.0, 0.0, 0.0),
                             quad_degree=QUAD_DEGREE, **kw)
            self.setup()

        @property
        def mesh(self):
            return jm

        @property
        def bcu(self):
            if self._bcu is None:
                def inflow(x):
                    v = np.zeros((3, x.shape[1]))
                    v[0] = (16 * u_max * x[1] * x[2] * (H - x[1])
                            * (H - x[2]) / H ** 4)
                    return v

                out = []
                for f, tag in ((inflow, mk["inlet"]),
                               (np.zeros(3), mk["obstacle"]),
                               (np.zeros(3), mk["wall"])):
                    bc = BoundaryCondition(f)
                    bc.initTopological(2, jm.tagged_facets(tag))
                    out.append(bc)
                self._bcu = out
            return self._bcu

        @property
        def bcp(self):
            if self._bcp is None:
                bc = BoundaryCondition(0.0)
                bc.initTopological(2, jm.tagged_facets(mk["outlet"]))
                self._bcp = [bc]
            return self._bcp

        def initial_velocity(self, x):
            return np.zeros((3, x.shape[1]))

    return JaxDFG3D(**{**config["solver_kw"], "stats_every": 1})


def march(sc, steps):
    s = sc.solver
    counts = []
    for _ in range(steps):
        s.solveStep()
        assert s.last_stats["converged"]
        counts.append((int(s.last_stats["newton_iters"]),
                       int(s.last_stats["ksp_iters"])))
        s.u_prev, s.p_prev = s.u_sol, s.p_sol
    return {"counts": counts, "u": np.array(s.u_sol), "p": np.array(s.p_sol)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    _, _, cell, config = cellmod.resolve("dfg3d1z_developed",
                                         config_patch=PATCH)
    config["solver_kw"] = {**config["solver_kw"], "stats_every": 1}
    mesh = dfg3d.make(config, cache_dir=str(tmp_path_factory.mktemp("m")))
    port = cellmod.build_scenario(config, cell, mesh, None, "cpu")
    return {"port": march(port, STEPS),
            "jax": march(jax_dfg3d(mesh, config, cell), STEPS),
            "port_sc": port}


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def test_dfg3d_counts_equal(runs):
    assert runs["port"]["counts"] == runs["jax"]["counts"]
    assert all(n >= 1 and k >= 1 for n, k in runs["port"]["counts"])


@pytest.mark.parametrize("key", ["u", "p"])
def test_dfg3d_state_matches(runs, key):
    assert np.isfinite(runs["port"][key]).all()
    assert _rel(runs["port"][key], runs["jax"][key]) < TOL


def test_dfg3d_runs_on_tetrahedra(runs):
    s = runs["port_sc"].solver
    assert str(s.mesh.cell_type) == "tetrahedron"
    assert s.form.tabs.p1 and s.form.tabs.tet
    assert s.form.tabs.qw.shape[0] == 14
    # the flow has started: the inflow's momentum is in the channel
    assert np.abs(runs["port"]["u"]).max() > 0.3
