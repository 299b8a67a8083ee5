"""The element layer of cfdtpu_torch against cfdtpu (JAX): K3's Jacobian
entry point ns_cell_jacobian_p1 and K7 ns_facet_natural_p1 (residual
and Jacobian), each through its wrapper on CPU tensors (which takes the
plain version), and K3's entry points with the facet block in their
launch (K3 + K7, as the form calls them), on the DFG 2D-1 mesh at
res_scale 1.0 in float64, from random states made with numpy.

Tolerances: 1e-12 relative to the largest magnitude of the reference
where both sides run the same algorithm in float64 (only the order of
the sums differs); 1e-6 relative for the Jacobians against a central
difference of the residuals with step 1e-5 (the residual is cubic in u,
so the truncation error is ~1e-10 and the rounding error ~1e-11 of the
scale). The CUDA kernels take their Jacobians from the residual bodies
on dual numbers, so there is no hand-derived formula to transcribe.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdtpu.scenarios.dfg_1 import DFG1Benchmark as JaxDFG

from cfdtpu_torch import kernels
from cfdtpu_torch.elements import LagrangeElement, quadrature
from cfdtpu_torch.kernels.ns_cell_residual import (MAX_FACET_BLOCKS, CellTabs,
                                                   ns_cell_jacobian_p1,
                                                   ns_cell_residual_p1)
from cfdtpu_torch.kernels.ns_facet import (ns_facet_natural_jac_p1,
                                                   ns_facet_natural_p1)
from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark as TorchDFG

torch.set_num_threads(1)

RTOL = 1e-12
FD_RTOL = 1e-6
FD_STEP = 1e-5
KW = dict(dt=0.05, T=1.0, res_scale=1.0, dtype="float64")


@pytest.fixture(scope="module")
def pair():
    kernels.reset_counts()
    return (JaxDFG("stabilized_schur", **KW).solver,
            TorchDFG("stabilized_schur", device="cpu", **KW).solver)


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
    assert err <= rtol * scale, f"max err {err:.3e} vs scale {scale:.3e}"


def _cell_args(ts, u, up, p):
    f, prm = ts.form, ts.params()
    return (torch.as_tensor(u), torch.as_tensor(up), torch.as_tensor(p),
            f.dofmap_u, f.dofmap_p, f.cell_coords, f.cell_h, f.tabs,
            prm["rho"], prm["mu"], prm["dt"], prm["f"], f.eps)


def _facet_args(ts, u, up, p):
    T = torch.as_tensor
    return ts.form._fused_args(ts.form._facet_blocks[0], T(u), T(p),
                               (T(up),), ts.params())


def _facet_blocks(ts):
    """The form's natural-correction block as K3's entry points take it."""
    return [ts.form._kernel_block(ts.form._facet_blocks[0], ts.params())]


def _jax_jacobians(js, u, up, p):
    return js.form.element_jacobians(jnp.asarray(u), jnp.asarray(p),
                                     (jnp.asarray(up),), js.params())


@pytest.mark.parametrize("seed", [0, 1])
def test_cell_jacobian_matches_cfdtpu(pair, seed):
    js, ts = pair
    u, up, p = _state(ts, seed)
    A_cells, _ = _jax_jacobians(js, u, up, p)
    got = ns_cell_jacobian_p1(*_cell_args(ts, u, up, p))
    assert got.shape == (ts.form.mesh.num_cells, 9, 9)
    _close(got, A_cells)


@pytest.mark.parametrize("seed", [0, 1])
def test_facet_residual_matches_cfdtpu(pair, seed):
    js, ts = pair
    u, up, p = _state(ts, seed)
    (jblock,) = js.form._facet_blocks
    _, ref = js.form._block_residual(jblock, jnp.asarray(u), jnp.asarray(p),
                                     (jnp.asarray(up),), js.params())
    got = ns_facet_natural_p1(*_facet_args(ts, u, up, p))
    _close(got, ref)
    # the form routes the block to the same entry point
    _, via_form = ts.form._block_residual(
        ts.form._facet_blocks[0], torch.as_tensor(u), torch.as_tensor(p),
        (torch.as_tensor(up),), ts.params())
    assert torch.equal(via_form, got)


@pytest.mark.parametrize("seed", [0, 1])
def test_facet_jacobian_matches_cfdtpu(pair, seed):
    js, ts = pair
    u, up, p = _state(ts, seed)
    _, ((_, A_f),) = _jax_jacobians(js, u, up, p)
    got = ns_facet_natural_jac_p1(*_facet_args(ts, u, up, p))
    _close(got, A_f)
    assert not got[:, 6:, :].any()  # no continuity part: zero p rows


def test_form_element_jacobians_match_cfdtpu(pair):
    """StabilizedNSForm.element_jacobians through both entry points."""
    js, ts = pair
    u, up, p = _state(ts, 2)
    A_cells, ((jdmf, A_f),) = _jax_jacobians(js, u, up, p)
    T = torch.as_tensor
    got_c, ((dmf, got_f),) = ts.form.element_jacobians(
        T(u), T(p), (T(up),), ts.params())
    _close(got_c, A_cells)
    _close(got_f, A_f)
    np.testing.assert_array_equal(dmf.numpy(), np.asarray(jdmf))


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_residual_matches_cfdtpu(pair, seed):
    """ns_cell_residual_p1 with the facet block: the cells' residuals as
    K3 alone gives them, the facet block's as cfdtpu's _block_residual
    (1e-12), and the form's assembled residual as cfdtpu's."""
    js, ts = pair
    u, up, p = _state(ts, seed)
    cargs = _cell_args(ts, u, up, p)
    ru_e, rp_e, ru_f = ns_cell_residual_p1(*cargs, facets=_facet_blocks(ts))
    alone = ns_cell_residual_p1(*cargs)
    assert torch.equal(ru_e, alone[0]) and torch.equal(rp_e, alone[1])
    (jblock,) = js.form._facet_blocks
    J = jnp.asarray
    _, ref = js.form._block_residual(jblock, J(u), J(p), (J(up),),
                                     js.params())
    _close(ru_f, ref)
    T = torch.as_tensor
    got = ts.form.residual(T(u), T(p), (T(up),), ts.params())
    for g, r in zip(got, js.form.residual(J(u), J(p), (J(up),),
                                          js.params())):
        _close(g, r)


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_jacobian_matches_cfdtpu(pair, seed):
    """ns_cell_jacobian_p1 with the facet block: (A_cells, A_f) as
    cfdtpu's element_jacobians (1e-12)."""
    js, ts = pair
    u, up, p = _state(ts, seed)
    A_cells, ((_, A_f),) = _jax_jacobians(js, u, up, p)
    got_c, got_f = ns_cell_jacobian_p1(*_cell_args(ts, u, up, p),
                                       facets=_facet_blocks(ts))
    _close(got_c, A_cells)
    _close(got_f, A_f)


def test_second_facet_block_raises(pair, monkeypatch):
    """K3's launch carries up to MAX_FACET_BLOCKS facet blocks: a second
    block is summed after the first (its residual twice the one block's
    facet part), and a form with more blocks than the launch carries
    refuses to split itself, on any device."""
    _, ts = pair
    u, up, p = (torch.as_tensor(a) for a in _state(ts, 7))
    (block,) = ts.form._facet_blocks
    prm = ts.params()
    one = ts.form.residual(u, p, (up,), prm)
    monkeypatch.setattr(ts.form, "_facet_blocks", [block, block])
    two = ts.form.residual(u, p, (up,), prm)
    _, ru_f = ts.form._block_residual(block, u, p, (up,), prm)
    facet = block["scatter_u"](ru_f.reshape(-1, 2).contiguous())
    _close(two[0], one[0] + facet)
    assert torch.equal(two[1], one[1])
    monkeypatch.setattr(ts.form, "_facet_blocks",
                        [block] * (MAX_FACET_BLOCKS + 1))
    for call in (ts.form.residual, ts.form.element_jacobians):
        with pytest.raises(NotImplementedError, match="facet blocks"):
            call(u, p, (up,), prm)


def _flat_direction(dm_u, dm_p, du, dp):
    """A global direction gathered into the flat element layout
    [u(b, i) row-major, then p(b)]."""
    dm_u, dm_p = dm_u.long(), dm_p.long()
    return torch.cat([du[dm_u].reshape(len(dm_u), -1), dp[dm_p]], dim=1)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_cell_jacobian_matches_central_difference(pair, seed):
    """A_cells d against (r(x + e d) - r(x - e d)) / 2e along a random
    direction d: independent of jacfwd."""
    _, ts = pair
    u, up, p = _state(ts, seed)
    rng = np.random.default_rng(100 + seed)
    du, dp = rng.standard_normal(u.shape), rng.standard_normal(p.shape)
    args = _cell_args(ts, u, up, p)
    A = ns_cell_jacobian_p1(*args)

    def flat_residual(sign):
        ru, rp = ns_cell_residual_p1(
            *_cell_args(ts, u + sign * FD_STEP * du, up,
                        p + sign * FD_STEP * dp))
        return torch.cat([ru.reshape(len(ru), -1), rp], dim=1)

    fd = (flat_residual(1.0) - flat_residual(-1.0)) / (2 * FD_STEP)
    d_e = _flat_direction(args[3], args[4], torch.as_tensor(du),
                          torch.as_tensor(dp))
    _close(torch.einsum("cab,cb->ca", A, d_e), fd, FD_RTOL)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_facet_jacobian_matches_central_difference(pair, seed):
    _, ts = pair
    u, up, p = _state(ts, seed)
    rng = np.random.default_rng(200 + seed)
    du, dp = rng.standard_normal(u.shape), rng.standard_normal(p.shape)
    fargs = _facet_args(ts, u, up, p)
    A = ns_facet_natural_jac_p1(*fargs)

    def flat_residual(sign):
        ru = ns_facet_natural_p1(
            *_facet_args(ts, u + sign * FD_STEP * du, up,
                         p + sign * FD_STEP * dp))
        return ru.reshape(len(ru), -1)

    fd = (flat_residual(1.0) - flat_residual(-1.0)) / (2 * FD_STEP)
    d_e = _flat_direction(fargs[3], fargs[4], torch.as_tensor(du),
                          torch.as_tensor(dp))
    _close(torch.einsum("fab,fb->fa", A, d_e)[:, :6], fd, FD_RTOL)


def test_affine_flag(pair):
    """CellTabs.create: affine for P1 triangles (dphi the same at every
    point), not for a basis whose gradients vary (P2), whatever the
    geometry's; and no `p1` (the CUDA kernels take the geometry once a
    cell) without `affine`."""
    _, ts = pair
    assert ts.form.tabs.p1 and ts.form.tabs.affine
    xi, w = quadrature("triangle", 5)
    p1 = LagrangeElement.create("triangle", 1)
    p2 = LagrangeElement.create("triangle", 2)
    phi1, dphi1 = p1.tabulate(xi, nderiv=1)
    phi2, dphi2, d2phi2 = p2.tabulate(xi, nderiv=2)
    assert CellTabs.create(w, phi1, dphi1, None, phi1, dphi1, dphi1, True,
                           "cpu", torch.float64).affine
    tabs2 = CellTabs.create(w, phi2, dphi2, d2phi2, phi2, dphi2, dphi1, True,
                            "cpu", torch.float64)
    assert not tabs2.affine and not tabs2.p1
    bent = dphi1.copy()
    bent[1] *= 1.5  # P1 shapes, but the gradients differ between points
    tabs3 = CellTabs.create(w, phi1, bent, None, phi1, bent, bent, True,
                            "cpu", torch.float64)
    assert not tabs3.affine and not tabs3.p1


def test_form_refuses_a_facet_term_without_a_kernel(pair):
    """The form takes only the facet terms that have a CUDA kernel (K7,
    K12, K13: their `fused` names it), on any device."""
    _, ts = pair

    def other(u_e, p_e, aux_e, coords_e, tabs, prm):
        return u_e

    n_blocks = len(ts.form._facet_blocks)
    with pytest.raises(NotImplementedError):
        ts.form.add_facet_term("other", np.arange(4, dtype=np.int32), other)
    assert len(ts.form._facet_blocks) == n_blocks


def test_cpu_tensors_launch_no_kernel(pair):
    """Every call above ran on CPU tensors: no launch was counted."""
    _, ts = pair
    u, up, p = _state(ts, 6)
    ns_cell_jacobian_p1(*_cell_args(ts, u, up, p))
    ns_facet_natural_jac_p1(*_facet_args(ts, u, up, p))
    assert kernels.counts() == {name: 0 for name in kernels.COUNTERS}
