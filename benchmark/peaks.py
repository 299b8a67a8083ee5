"""The card's peak bandwidth and the bytes a kernel's work needs.

The peak: NVIDIA's H100 SXM5 80 GB data sheet, at the full 700 W power
limit. A roofline share is stated against it, with the card's power
limit beside it.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12


def node_block_pairs(cells: np.ndarray, n_nodes: int) -> int:
    """Nonzero node blocks of a P1 operator: each node with itself and
    with every node it shares a cell with (each ordered pair once)."""
    cells = np.asarray(cells, dtype=np.int64)
    nv = cells.shape[1]
    a = np.repeat(cells, nv, axis=1).reshape(-1)
    b = np.tile(cells, (1, nv)).reshape(-1)
    return int(np.unique(a * n_nodes + b).size)


def spmv_bytes(cells, n_nodes: int, block: int, itemsize: int) -> int:
    """Bytes the node-block sparsity of y = A x needs: each nonzero
    block's values (block x block) and one int32 column index, one int32
    row pointer a node (and the last), x read once and y written once."""
    nb = node_block_pairs(cells, n_nodes)
    n = n_nodes * block
    return (nb * (block * block * itemsize + 4) + 4 * (n_nodes + 1)
            + 2 * n * itemsize)
