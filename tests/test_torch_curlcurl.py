"""The curl-curl form of cfdtpu_torch against cfdtpu (JAX): K15's plain
cell body (ns_cell_residual_curl_p1 and ns_cell_jacobian_curl_p1 on CPU
tensors) against StabilizedNSFormCurlCurl's cell kernel vmapped (and
vmap(jacfwd(.)) through element_jacobians), and the form of
stabilized_schur_pressurebc (K15 with its four facet blocks: weak
pressure and curl-form Nitsche on the inlet and on the outlet) against
cfdtpu's, on pipe_cylinder_pressurebc at res_scale 2.0 (2,520 DOF),
float64, at states made with numpy from a seed (one with a third of
u_prev at rest: tau's eps guard).

Tolerance: 1e-12 relative to the largest magnitude of the reference
(both sides float64, only the order of the sums differs); 1e-6 for the
Jacobian against central differences of the residual (step 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdtpu.scenarios.pipe_cylinder_pressurebc import (
    PipeCylinderPressureBC as JaxPipe)

from cfdtpu_torch import kernels
from cfdtpu_torch.forms import StabilizedNSFormCurlCurl
from cfdtpu_torch.kernels.ns_cell_residual import (
    ns_cell_jacobian_curl_p1, ns_cell_residual_curl_p1,
    ns_cell_residual_p1)
from cfdtpu_torch.scenarios.pipe_cylinder_pressurebc import (
    PipeCylinderPressureBC as TorchPipe)

torch.set_num_threads(1)

RTOL = 1e-12
FD_RTOL = 1e-6
FD_STEP = 1e-5
SOLVER = "stabilized_schur_pressurebc"
KW = dict(dt=0.05, T=1.0, res_scale=2.0, p_inlet=0.15, p_outlet=0.02,
          dtype="float64")


@pytest.fixture(scope="module")
def pair():
    kernels.reset_counts()
    return (JaxPipe(SOLVER, **KW).solver,
            TorchPipe(SOLVER, device="cpu", **KW).solver)


def _state(ts, seed):
    rng = np.random.default_rng(seed)
    n_u, n_p = ts.V.num_dofs, ts.Q.num_dofs
    u, up = (0.3 * rng.standard_normal((n_u, 2)) for _ in range(2))
    if seed % 2:
        up[: n_u // 3] = 0.0  # cells at rest: tau's eps guard
    return u, up, rng.standard_normal(n_p)


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert scale > 0
    assert err <= rtol * scale, f"max err {err:.3e} vs scale {scale:.3e}"


def _cell_args(ts, u, up, p):
    f, T, prm = ts.form, torch.as_tensor, ts.params()
    return (T(u), T(up), T(p), f.dofmap_u, f.dofmap_p, f.cell_coords,
            f.cell_h, f.tabs, prm["rho"], prm["mu"], prm["dt"], prm["f"],
            f.eps)


@pytest.mark.parametrize("seed", [0, 1])
def test_curl_cell_residual_matches_cfdtpu(pair, seed):
    """K15's plain residual against vmap of StabilizedNSFormCurlCurl's
    cell kernel."""
    js, ts = pair
    u, up, p = _state(ts, seed)
    J = jnp.asarray
    f = js.form
    ref = jax.vmap(f._kernel, in_axes=(0, 0, 0, 0, 0, None))(
        J(u)[f.dofmap_u], J(p)[f.dofmap_p], (J(up)[f.dofmap_u],),
        f.cell_coords, f.cell_h, js.params())
    got = ns_cell_residual_curl_p1(*_cell_args(ts, u, up, p))
    assert len(got) == 2
    for g, r in zip(got, ref):
        _close(g, r)
    # not K3's body: the rotational form differs from the sigma form
    k3 = ns_cell_residual_p1(*_cell_args(ts, u, up, p))
    assert (k3[0] - got[0]).abs().max() > 1e-3 * got[0].abs().max()


@pytest.mark.parametrize("seed", [0, 1])
def test_curl_cell_jacobian_matches_cfdtpu(pair, seed):
    js, ts = pair
    u, up, p = _state(ts, seed)
    J = jnp.asarray
    A_cells, _ = js.form.element_jacobians(J(u), J(p), (J(up),),
                                           js.params())
    got = ns_cell_jacobian_curl_p1(*_cell_args(ts, u, up, p))
    _close(got, A_cells)


def test_curl_cell_jacobian_matches_central_difference(pair):
    """A_e d against (r(x + e d) - r(x - e d)) / 2e: independent of
    jacfwd."""
    _, ts = pair
    u, up, p = _state(ts, 2)
    rng = np.random.default_rng(9)
    du, dp = rng.standard_normal(u.shape), rng.standard_normal(p.shape)
    A = ns_cell_jacobian_curl_p1(*_cell_args(ts, u, up, p))

    def r(sign):
        ru, rp = ns_cell_residual_curl_p1(*_cell_args(
            ts, u + sign * FD_STEP * du, up, p + sign * FD_STEP * dp))
        return torch.cat([ru.reshape(len(A), -1), rp], dim=1)

    fd = (r(1.0) - r(-1.0)) / (2 * FD_STEP)
    f = ts.form
    d_e = torch.cat([torch.as_tensor(du)[f.dofmap_u.long()].reshape(
        len(A), -1), torch.as_tensor(dp)[f.dofmap_p.long()]], dim=1)
    _close(torch.einsum("cab,cb->ca", A, d_e), fd, FD_RTOL)


def test_pressurebc_form_matches_cfdtpu(pair):
    """stabilized_schur_pressurebc's form (K15 with four blocks in its
    launch): the assembled residual and every element Jacobian block,
    the weak pressures' zero."""
    js, ts = pair
    assert isinstance(ts.form, StabilizedNSFormCurlCurl)
    assert [(b["name"], b["term"].term) for b in ts.form._facet_blocks] == [
        ("weak_pressure_in", "weakp"), ("weak_pressure_out", "weakp"),
        ("nitsche_in", "nitsche_curl"), ("nitsche_out", "nitsche_curl")]
    u, up, p = _state(ts, 3)
    J, T = jnp.asarray, torch.as_tensor
    ref = js.form.residual(J(u), J(p), (J(up),), js.params())
    got = ts.form.residual(T(u), T(p), (T(up),), ts.params())
    for g, r in zip(got, ref):
        _close(g, r)
    A_c, blocks = js.form.element_jacobians(J(u), J(p), (J(up),),
                                            js.params())
    got_c, got_blocks = ts.form.element_jacobians(T(u), T(p), (T(up),),
                                                  ts.params())
    _close(got_c, A_c)
    assert len(got_blocks) == len(blocks) == 4
    for k, ((gd, ga), (jd, ja)) in enumerate(zip(got_blocks, blocks)):
        np.testing.assert_array_equal(gd.numpy(), np.asarray(jd))
        if k < 2:
            assert not ga.any() and not np.asarray(ja).any()
        else:
            _close(ga, ja)


def test_element_call_carries_the_four_blocks(pair):
    """K15's entry point with the form's blocks (as its launch carries
    them): the cells as K15 alone gives them and each block as its own
    entry point, bit for bit on the CPU."""
    _, ts = pair
    u, up, p = _state(ts, 4)
    f, prm = ts.form, ts.params()
    T = torch.as_tensor
    blocks = [f._kernel_block(b, prm) for b in f._facet_blocks]
    out = ns_cell_residual_curl_p1(*_cell_args(ts, u, up, p), facets=blocks)
    alone = ns_cell_residual_curl_p1(*_cell_args(ts, u, up, p))
    assert len(out) == 6
    assert torch.equal(out[0], alone[0]) and torch.equal(out[1], alone[1])
    for got, block in zip(out[2:], f._facet_blocks):
        _, ref = f._block_residual(block, T(u), T(p), (T(up),), prm)
        assert torch.equal(got, ref)
    jac = ns_cell_jacobian_curl_p1(*_cell_args(ts, u, up, p), facets=blocks)
    assert len(jac) == 5
    assert torch.equal(jac[0],
                       ns_cell_jacobian_curl_p1(*_cell_args(ts, u, up, p)))


def test_no_pressure_is_pinned(pair):
    """With weak pressures at both ends the initial Jacobian has no
    constant-pressure nullspace, in both packages."""
    js, ts = pair
    assert not js.pin_pressure and not ts.pin_pressure
    assert len(ts.bc_dofs_p) == 0


def test_cpu_tensors_launch_no_kernel(pair):
    """Every call above ran on CPU tensors: no launch was counted."""
    assert kernels.counts() == {name: 0 for name in kernels.COUNTERS}
