"""Hand-written CUDA kernels of the Newton-Krylov step and their wrappers.

K1 sup_spmv            supernode-ELL SpMV with fused epilogues
K2 ell_sum             deterministic ELL gather-reduce (sorted scatter)
K3 ns_cell_residual_p1 fused stabilized-NS cell residual, P1 triangles
K4 selfp_triple        SELFP triple products Apu diag(Auu)^-1 Aup
K5 patch_spmv          in-patch scalar ELL SpMV (the gather microbenchmark)
K6 ras_apply           restricted additive Schwarz window apply

Every wrapper takes its plain PyTorch version for CPU tensors and
launches its kernel for CUDA tensors (or raises); each launch adds one
to the wrapper's counter, `COUNTERS[name].n`.
"""

from __future__ import annotations


class LaunchCounter:
    """Plain integer count of a kernel's launches."""

    __slots__ = ("name", "n")

    def __init__(self, name: str):
        self.name = name
        self.n = 0


COUNTERS = {
    name: LaunchCounter(name)
    for name in ("sup_spmv", "ell_sum", "ns_cell_residual_p1",
                 "selfp_triple", "patch_spmv", "ras_apply")
}


def reset_counts() -> None:
    for c in COUNTERS.values():
        c.n = 0


def counts() -> dict[str, int]:
    return {name: c.n for name, c in COUNTERS.items()}
