"""The node-block byte count of the matvec bound, against hand counts."""

import numpy as np

from benchmark import cell as cellmod
from benchmark.peaks import node_block_pairs, spmv_bytes


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
