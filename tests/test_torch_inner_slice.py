"""The non-AMG inner methods end to end against cfdtpu (JAX): DFG 2D-1,
float64, res_scale 2.5 (1,626 DOF), 2 steps from rest at the CLI's
defaults (Newton with the operator and preconditioner rebuilt each
iteration) with pc_inner_method gmres (cfdtpu's default inner method:
pc_inner_u 6, pc_inner_p its default 30 without AMG) and chebyshev_p
(Chebyshev on the SELFP Schur block; about 150 outer iterations a step
here, as cfdtpu/la/chebyshev.py:17-25 measured). Equal counts per step,
u, p, c_D, c_L and dp within 1e-8 (tests/test_torch_cycles_slice.py's
check).
"""

import pytest
import torch

from test_torch_cycles_slice import check_slice

torch.set_num_threads(1)

BASE = dict(dt=0.05, T=1.0, res_scale=2.5, dtype="float64", stats_every=1)


@pytest.mark.parametrize("method", ["gmres", "chebyshev_p"])
def test_inner_method_slice_matches_cfdtpu(method):
    check_slice(dict(BASE, pc_inner_method=method))
