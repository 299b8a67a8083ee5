"""The residual's facet term against cfdtpu (JAX): the facet block's
contributions reduced to the nodes by K2 over a sorted scatter of the
block's velocity dofmap, where cfdtpu adds them with .at[dm_u].add.
DFG 2D-1 at res_scale 2.5, float64, inputs made with numpy.

Tolerance 1e-12 relative: float64 on both sides, each node sums the same
few facet contributions in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdtpu.scenarios.dfg_1 import DFG1Benchmark as JaxDFG

from cfdtpu_torch import kernels
from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark as TorchDFG

torch.set_num_threads(1)

RTOL = 1e-12
KW = dict(dt=0.05, T=1.0, res_scale=2.5, dtype="float64",
          pc_inner_method="rasamg_sup", pc_inner_u=0, pc_inner_p=5,
          pc_ras_size=32, snes_lag_jacobian=True, pc_lag_steps=4)


@pytest.fixture(scope="module")
def pair():
    return (JaxDFG("stabilized_schur", **KW).solver,
            TorchDFG("stabilized_schur", device="cpu", **KW).solver)


def _close(got, ref):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= RTOL * np.abs(ref).max()


@pytest.mark.parametrize("seed", [0, 1])
def test_facet_scatter_matches_at_add(pair, seed):
    js, ts = pair
    (jblock,), (tblock,) = js.form._facet_blocks, ts.form._facet_blocks
    dm_u = tblock["dofmap_u"]
    np.testing.assert_array_equal(np.asarray(jblock["dofmap_u"]),
                                  dm_u.numpy())
    ru_f = np.random.default_rng(seed).standard_normal(
        tuple(dm_u.shape) + (2,))
    ref = jnp.zeros((ts.V.num_dofs, 2)).at[jnp.asarray(dm_u.numpy())].add(
        jnp.asarray(ru_f))
    got = tblock["scatter_u"](torch.as_tensor(ru_f.reshape(-1, 2)))
    _close(got, ref)


def test_residual_with_facet_term(pair):
    """form.residual (cell term K3 + K2, then the facet term K2) at a
    random state, and its repeatability: two calls are bitwise equal."""
    js, ts = pair
    rng = np.random.default_rng(4)
    n_u, n_p = ts.V.num_dofs, ts.Q.num_dofs
    u, up = (0.3 * rng.standard_normal((n_u, 2)) for _ in range(2))
    p = rng.standard_normal(n_p)
    ref = js.form.residual(jnp.asarray(u), jnp.asarray(p),
                           (jnp.asarray(up),), js.params())
    kernels.reset_counts()
    args = (torch.as_tensor(u), torch.as_tensor(p), (torch.as_tensor(up),),
            ts.params())
    got = ts.form.residual(*args)
    again = ts.form.residual(*args)
    for g, a, r in zip(got, again, ref):
        _close(g, r)
        assert torch.equal(g, a)
    assert kernels.counts()["ell_sum"] == 0  # CPU tensors: plain versions
