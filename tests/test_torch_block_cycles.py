"""The velocity block's AMG cycles against cfdtpu (JAX): BlockAMG with
the W-cycle, the K-cycle, Chebyshev smoothing (degree 1, 2, 3) and all
three together, at n_smooth 1 and 2, with and without the RAS fine
smoother (on whose level Chebyshev gives way to RAS, as in cfdtpu); and
the oracle that the *_sup methods' near-true Schur action stays linear
with the hierarchy's K-cycle on. The case, the hierarchies and the
comparison are tests/test_torch_cycles.py's: DFG 2D-1 at res_scale 1.0,
float64, 1e-11 (cycles) and 1e-12 (linearity).
"""

import numpy as np
import pytest
import torch

from cfdtpu_torch.la.schur import _near_true_schur, _sub_ops

from test_torch_cycles import (CASES, T, assert_close, case,  # noqa: F401
                               check_cycle, hier)

torch.set_num_threads(1)


@pytest.mark.parametrize("kind", ["block", "block + ras"])
@pytest.mark.parametrize("cycle,n_smooth", CASES)
def test_block_cycle_matches_cfdtpu(case, hier, kind, cycle, n_smooth):
    check_cycle(hier, kind, cycle, n_smooth)


def test_near_true_schur_linear_under_kcycle(case, hier):
    """With the hierarchy's K-cycle (and W, Chebyshev) on, the near-true
    S still runs a linear cycle: S(a x + b y) = a S x + b S y (1e-12)."""
    ts, tnb, mask = case["ts"], case["tnb"], case["mask"]
    nuf = ts.form.n_u_flat
    mu, mp = T(mask[:nuf]), T(mask[nuf:])
    _, th, vals = hier("block + ras", 1)
    th.set_cycle(kcycle=True, wcycle=True, cheby=2)
    try:
        built = th.build(T(vals))
        _, Aup, Apu, App, _ = _sub_ops(tnb, case["tvals"], mu, mp, False,
                                       case["inv_d_u"])
        S = _near_true_schur(th, built, Aup, Apu, App, mu, mp, False)
        rng = np.random.default_rng(8)
        x, y = (T(rng.standard_normal(tnb.n_nodes)) for _ in range(2))
        a, c = 0.7, -1.3
        lhs = S(a * x + c * y)
        rhs = a * S(x) + c * S(y)
        assert_close(lhs, rhs.numpy(), 1e-12)
    finally:
        th.set_cycle(kcycle=False, wcycle=False, cheby=0)
