"""The port's 2D geometry (geom/stenosis2d.py, geom/tree/tree_2d.py,
geom/tree_mesh2d.py and stenosis_mesh_variable's sizing) must build
exactly the meshes cfdtpu builds: points, cells, facets and facet tags
bit for bit, as tests/test_torch_host.py holds the DFG mesh. The host
layer is the same numpy code on the same inputs.
"""

import numpy as np
import pytest

from cfdtpu.geom import stenosis2d as jax_st
from cfdtpu.geom import tree_mesh2d as jax_tm
from cfdtpu.geom.tree import VascularTree2D as JaxTree
from cfdtpu.scenarios.stenosis_mesh_variable import (
    StenosisMeshVariableSimulation as JaxVariable)

from cfdtpu_torch.geom import stenosis2d, tree_mesh2d
from cfdtpu_torch.geom.tree import VascularTree2D
from cfdtpu_torch.scenarios.stenosis_mesh_variable import (
    StenosisMeshVariableSimulation)

FIELDS = ("points", "cells", "facets", "facet_cells", "facet_local_index",
          "facet_tags")
# StenosisSimulation's mesh options at the severe grade
SEVERE = dict(L=138.0, R_in=1.57, R_out=1.2, x_position_stenosis=30.0,
              severity=0.75, slope=0.3, tension=0.5)
TREE = dict(n_generations=3, gamma=3.0, bifurcation_angle=35.0,
            length_ratio=8.0, asymmetry=0.5)


def same_mesh(a, b):
    for name in FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert a.cell_type.value == b.cell_type.value
    np.testing.assert_array_equal(a.h(), b.h())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_stenosis_mesh_2d(dtype):
    kw = dict(SEVERE, res=1.0, dtype=dtype)
    a = jax_st.generate_stenosis_mesh_2d(**kw)
    b = stenosis2d.generate_stenosis_mesh_2d(**kw)
    same_mesh(a, b)
    assert set(np.unique(b.facet_tags)) == {2, 3, 4}


def test_stenosis_mesh_structured():
    kw = dict(SEVERE, res=1.0)
    a = jax_st.generate_stenosis_mesh_structured(**kw)
    b = stenosis2d.generate_stenosis_mesh_structured(**kw)
    same_mesh(a, b)


def test_stenosis_radius_profile():
    args = [SEVERE[k] for k in ("L", "R_in", "R_out", "x_position_stenosis",
                                "severity", "slope", "tension")]
    for x, y in zip(jax_st.stenosis_radius_profile(*args),
                    stenosis2d.stenosis_radius_profile(*args)):
        assert np.array_equal(x, y)
    assert jax_st.stenosis_profile_params(*args) == \
        stenosis2d.stenosis_profile_params(*args)


def _variable_mesh(cls):
    """StenosisMeshVariableSimulation.mesh without building a solver:
    the property reads only the mesh options, n_rad, n_axial and the
    dtype."""
    sc = cls.__new__(cls)
    sc._mesh = None
    sc.mesh_options = dict(SEVERE, res=1.0)
    sc.n_rad, sc.n_axial = 3, 10  # coarser than the default 6
    sc._dtype = np.float64
    return sc.mesh


def test_stenosis_mesh_variable():
    same_mesh(_variable_mesh(JaxVariable),
              _variable_mesh(StenosisMeshVariableSimulation))


def _trees(r_root):
    return (JaxTree(r_root=r_root, **TREE).generate((138.0, 1.57), 0.0),
            VascularTree2D(r_root=r_root, **TREE).generate((138.0, 1.57),
                                                           0.0))


def test_vascular_tree_2d():
    a, b = _trees(0.9 * 1.2)
    assert sorted(a.nodes) == sorted(b.nodes)
    for k in a.nodes:
        assert np.array_equal(a.nodes[k], b.nodes[k])
    assert a.edges == b.edges and a.terminals == b.terminals
    assert len(b.terminals) == 2 ** TREE["n_generations"]
    assert a.poiseuille_resistance(3.5e-3) == \
        b.poiseuille_resistance(3.5e-3)


def test_stenosis_tree_mesh_2d():
    a_tree, b_tree = _trees(0.9 * 1.2)
    kw = dict(SEVERE, x_position_stenosis=0.2 * 138.0, res=0.6)
    a = jax_tm.generate_stenosis_tree_mesh_2d(tree=a_tree, **kw)
    b = tree_mesh2d.generate_stenosis_tree_mesh_2d(tree=b_tree, **kw)
    same_mesh(a, b)
    assert set(np.unique(b.facet_tags)) == {2, 3, 4}
