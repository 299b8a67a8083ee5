"""Supernode-blocked ELL sparse layout.

The counterpart of cfdtpu/la/superell.py: g consecutive (Hilbert-
ordered) node ids form one supernode; coupled supernode pairs own dense
(g*bs, g*bs) blocks in an ELL layout (ns, Kg, ., .), and a matvec
gathers (g*bs)-wide rows of the supernode-major x. The maps are built
in numpy exactly as in cfdtpu; the matvec is kernel K1
(kernels/sup_spmv.py).

Row layout inside a superblock (matching the solver's flat dof layout
[u.reshape(-1), p]): local node a in [0, g), velocity component i in
[0, d) sits at row a*d + i; the pressure dof of node a at row g*d + a.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.sup_spmv import sup_spmv


class SuperMaps:
    """Static supernode maps for a node-pair COO graph (row, col, n).

    sup_cols (ns, Kg) int32 on `device` holds the coupled supernode of
    each slot, padded with ns."""

    __slots__ = ("g", "ns", "Kg", "sup_cols", "pair_slot", "n")

    def __init__(self, row: np.ndarray, col: np.ndarray, n: int, g: int,
                 device="cpu"):
        self.g = int(g)
        self.n = int(n)
        ns = -(-n // g)
        self.ns = ns
        srow = (row // g).astype(np.int64)
        scol = (col // g).astype(np.int64)
        keys = srow * ns + scol
        uniq, inv = np.unique(keys, return_inverse=True)
        urow = uniq // ns
        ucol = uniq % ns
        cnt = np.bincount(urow, minlength=ns)
        Kg = int(cnt.max()) if len(uniq) else 1
        starts = np.cumsum(cnt) - cnt
        slot_of_pair = np.arange(len(uniq)) - starts[urow]
        cols = np.full(ns * Kg, ns, dtype=np.int64)
        cols[urow * Kg + slot_of_pair] = ucol
        self.Kg = Kg
        self.sup_cols = torch.as_tensor(
            cols.reshape(ns, Kg).astype(np.int32), device=device)
        # per-COO-entry (pair) slot id in [0, ns*Kg)
        self.pair_slot = (urow * Kg + slot_of_pair)[inv]

    def scalar_positions(self, row: np.ndarray, col: np.ndarray
                         ) -> np.ndarray:
        """Flat positions of scalar COO entries in (ns*Kg, g, g)."""
        g = self.g
        return (self.pair_slot * g + row % g) * g + col % g

    def block_positions_uniform(self, row: np.ndarray, col: np.ndarray,
                                d: int) -> np.ndarray:
        """Flat positions for pure (d x d) blocks (all rows are
        components of the same field): local node a, component i sits at
        superblock row a*d + i. Returns (nnz, d, d) int64."""
        g = self.g
        gd = g * d
        a = (row % g)[:, None]
        b = (col % g)[:, None]
        comp = np.arange(d)[None, :]
        roff = a * d + comp
        coff = b * d + comp
        return (
            (self.pair_slot[:, None, None] * gd + roff[:, :, None]) * gd
            + coff[:, None, :]
        )

    def block_positions(self, row: np.ndarray, col: np.ndarray, d: int
                        ) -> np.ndarray:
        """Flat positions of all (d+1)x(d+1) node-block scalar entries in
        (ns*Kg, gbs, gbs): returns (nnz, bs, bs) int64."""
        g = self.g
        bs = d + 1
        gbs = g * bs
        a = (row % g)[:, None]
        b = (col % g)[:, None]
        comp = np.arange(bs)[None, :]
        roff = np.where(comp < d, a * d + comp, g * d + a)  # (nnz, bs)
        coff = np.where(comp < d, b * d + comp, g * d + b)
        return (
            (self.pair_slot[:, None, None] * gbs + roff[:, :, None]) * gbs
            + coff[:, None, :]
        )


def place(flat_pos: torch.Tensor, vals: torch.Tensor, size: int, shape):
    """Unique-index placement of values into a zero (size,) buffer,
    reshaped to `shape`. The positions are unique, so the plain index
    write is deterministic (no accumulation)."""
    out = torch.zeros((size,), dtype=vals.dtype, device=vals.device)
    out[flat_pos] = vals.reshape(-1)
    return out.reshape(shape)


def place_scalar(maps: SuperMaps, row, col, vals):
    """Scatter scalar COO values into the (ns, Kg, g, g) layout."""
    pos = torch.as_tensor(
        maps.scalar_positions(np.asarray(row), np.asarray(col)),
        device=vals.device,
    )
    g = maps.g
    return place(pos, vals, maps.ns * maps.Kg * g * g,
                 (maps.ns, maps.Kg, g, g))


def sup_rows(x, ns: int, width: int):
    """x (m,) -> the (ns+1, width) supernode-row array: x zero-padded to
    ns*width, plus the zero sentinel row ns."""
    xp = torch.zeros(((ns + 1) * width,), dtype=x.dtype, device=x.device)
    xp[: x.shape[0]] = x
    return xp.reshape(ns + 1, width)


def sup_matvec(maps: SuperMaps, vals_sup, x):
    """y = A x for scalar x (n,), vals_sup (ns, Kg, g, g)."""
    return sup_spmv(vals_sup, maps.sup_cols, sup_rows(x, maps.ns, maps.g),
                    n_out=maps.n)
