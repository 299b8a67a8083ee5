"""The node-block byte count of the matvec bound, against hand counts,
and the block that spmv_roofline takes from the mesh."""

import importlib.util
import os

import numpy as np
import pytest

from benchmark import cell as cellmod
from benchmark.peaks import node_block_pairs, spmv_bytes


def load_module(metric):
    """benchmark/metrics/<metric>.py, loaded as run.py loads a reader."""
    path = os.path.join(cellmod.BENCH_DIR, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_two_triangles_by_hand():
    # the unit square cut along one diagonal: 4 nodes, 5 edges
    cells = np.array([[0, 1, 2], [1, 3, 2]])
    assert node_block_pairs(cells, 4) == 4 + 2 * 5
    # 14 blocks of 3 x 3 float32 values and an int32 column each, 5 row
    # pointers, x read and y written (12 float32 each)
    assert spmv_bytes(cells, 4, 3, 4) == 14 * (36 + 4) + 5 * 4 + 2 * 12 * 4
    assert spmv_bytes(cells, 4, 3, 8) == 14 * (72 + 4) + 5 * 4 + 2 * 12 * 8


def test_mesh_pairs_are_nodes_plus_twice_the_edges():
    _, _, _, config = cellmod.resolve(
        "dfg2d2_transient", config_patch={"mesh": {"res_scale": 2.0}})
    m = cellmod.make_mesh(config)
    cells = m["cells"]
    e = np.sort(np.concatenate([cells[:, [0, 1]], cells[:, [1, 2]],
                                cells[:, [0, 2]]]), axis=1)
    n_edges = len(np.unique(e, axis=0))
    assert node_block_pairs(cells, len(m["points"])) == (
        len(m["points"]) + 2 * n_edges)


def test_two_tetrahedra_by_hand():
    # two tetrahedra sharing the face (1, 2, 3): 5 nodes, 6 + 6 - 3 = 9
    # edges
    cells = np.array([[0, 1, 2, 3], [1, 2, 3, 4]])
    assert node_block_pairs(cells, 5) == 5 + 2 * 9
    # 23 blocks of 4 x 4 float32 values and an int32 column each, 6 row
    # pointers, x read and y written (20 float32 each)
    assert spmv_bytes(cells, 5, 4, 4) == 23 * (64 + 4) + 6 * 4 + 2 * 20 * 4
    assert spmv_bytes(cells, 5, 4, 8) == 23 * (128 + 4) + 6 * 4 + 2 * 20 * 8


@pytest.mark.parametrize("workload", ["dfg2d1_developed", "dfg2d2_transient"])
def test_roofline_bytes_on_triangles_are_block_3(workload):
    """spmv_roofline's bound on a coarse mesh of each 2D cell: the count
    with the node block 3 that it used before it read d from the mesh."""
    _, _, _, config = cellmod.resolve(
        workload, config_patch={"mesh": {"res_scale": 2.0}})
    m = cellmod.make_mesh(config)
    item = np.dtype(config["dtype"]).itemsize
    assert load_module("spmv_roofline").node_block_bytes(m, item) == \
        spmv_bytes(m["cells"], len(m["points"]), 3, item)


def test_roofline_bytes_on_tetrahedra_are_block_4():
    from benchmark.tests.test_bench_tet import box_mesh

    m = box_mesh(2)
    assert load_module("spmv_roofline").node_block_bytes(m, 4) == \
        spmv_bytes(m["cells"], len(m["points"]), 4, 4)
