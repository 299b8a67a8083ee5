"""The facet terms of cfdtpu_torch against cfdtpu (JAX): the viscous
traction (K12), the backflow stabilisation (K13) and the natural
correction (K7), at the Crank-Nicolson midpoint and at u (BDF2's
`implicit_velocity`), each through its wrapper on CPU tensors (which
takes the plain version) against cfdtpu's facet kernel vmapped over the
same block, residual and Jacobian (vmap(jacfwd(.))), on the outlet of
DFG 2D-1 at res 0.01 (14 outlet facets), float64. The dfg_2d_1
solver's form carries two blocks on the outlet (viscous_out, then
backflow_out): its assembled residual and element Jacobians against
cfdtpu's, and facet_flux.

The state is developed and made with numpy from a seed: the inlet
profile less 0.1 plus noise, so that u_prev.n < 0 on 3 of the 14 outlet
facets (at a quadrature point; the test asserts the count) and the
backflow term is not zero there. At rest (u_prev = 0) it would compare
zeros.

Tolerance: 1e-12 relative to the largest magnitude of the reference
(both sides float64, only the order of the sums differs); 1e-6 for the
Jacobians against central differences of the residuals (step 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdtpu.forms import facet_terms as jft
from cfdtpu.scenarios.dfg_2d_1 import DFG2D1Steady as JaxDFG2

from cfdtpu_torch import kernels
from cfdtpu_torch.kernels.ns_cell_residual import ns_cell_residual_p1
from cfdtpu_torch.kernels.ns_facet import (ns_facet_backflow_jac_p1,
                                           ns_facet_backflow_p1,
                                           ns_facet_viscous_jac_p1,
                                           ns_facet_viscous_p1)
from cfdtpu_torch.kernels.ns_facet import (ns_facet_natural_jac_p1,
                                                   ns_facet_natural_p1)
from cfdtpu_torch.scenarios.dfg_2d_1 import DFG2D1Steady as TorchDFG2

torch.set_num_threads(1)

RTOL = 1e-12
FD_RTOL = 1e-6
FD_STEP = 1e-5
KW = dict(dt=0.05, T=1.0, res=0.01, dtype="float64")
OUTLET_FACETS = 14
BACKFLOW_FACETS = 3
VELS = {"midpoint": (jft.midpoint_velocity, False),
        "implicit": (jft.implicit_velocity, True)}


@pytest.fixture(scope="module")
def pair():
    kernels.reset_counts()
    return (JaxDFG2("dfg_2d_1", **KW).solver,
            TorchDFG2("dfg_2d_1", device="cpu", **KW).solver)


def _state(ts, seed):
    """The inlet profile less 0.1 (negative near the walls) plus noise,
    for u and u_prev; p random."""
    rng = np.random.default_rng(seed)
    y = ts.V.dof_coords[:, 1]
    prof = np.stack([1.2 * y * (0.41 - y) / 0.41 ** 2 - 0.1, 0 * y], axis=1)
    n_u, n_p = ts.V.num_dofs, ts.Q.num_dofs
    u, up = (prof + 0.02 * rng.standard_normal((n_u, 2)) for _ in range(2))
    return u, up, 0.1 * rng.standard_normal(n_p)


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert scale > 0
    assert err <= rtol * scale, f"max err {err:.3e} vs scale {scale:.3e}"


def _blocks(js, ts, name):
    jb = next(b for b in js.form._facet_blocks if b["name"] == name)
    tb = next(b for b in ts.form._facet_blocks if b["name"] == name)
    return jb, tb


def _jax_kernel(term, vel):
    if term == "viscous":
        return jft.viscous_traction(vel=vel)
    if term == "backflow":
        return jft.backflow(vel=vel)
    return jft.natural_correction(vel=vel)


def _jax_residual(js, jb, kernel, u, up, p):
    J = jnp.asarray
    _, ref = js.form._block_residual(dict(jb, kernel=kernel), J(u), J(p),
                                     (J(up),), js.params())
    return ref


def _jax_jacobian(js, jb, kernel, u, up, p):
    """vmap(jacfwd(.)) of cfdtpu's flat facet kernel over the block, as
    its element_jacobians takes it."""
    J = jnp.asarray
    dm_u, dm_p = jb["dofmap_u"], jb["dofmap_p"]
    xef = jnp.concatenate([J(u)[dm_u].reshape(len(dm_u), -1), J(p)[dm_p]],
                          axis=1)
    fk = js.form._flat_facet_kernel(kernel)
    return jax.vmap(jax.jacfwd(fk), in_axes=(0, 0, 0, 0, None))(
        xef, (J(up)[dm_u],), jb["coords"], jb["tabs"], js.params())


def _port(term, jacobian, tb, u, up, p, prm, implicit):
    T = torch.as_tensor
    args = (T(u), T(up), T(p), tb["dofmap_u32"], tb["dofmap_p32"],
            tb["coords"], tb["tabs"])
    if term == "viscous":
        fn = ns_facet_viscous_jac_p1 if jacobian else ns_facet_viscous_p1
        return fn(*args, prm["mu"], implicit=implicit)
    if term == "backflow":
        fn = ns_facet_backflow_jac_p1 if jacobian else ns_facet_backflow_p1
        return fn(*args, prm["beta_backflow"], prm["rho"],
                  implicit=implicit)
    fn = ns_facet_natural_jac_p1 if jacobian else ns_facet_natural_p1
    return fn(*args, prm["mu"], implicit=implicit)


def test_state_has_backflow_on_part_of_the_outlet(pair):
    """u_prev.n < 0 at a quadrature point of BACKFLOW_FACETS of the
    OUTLET_FACETS outlet facets: K13 is compared where it is not zero."""
    _, ts = pair
    _, up, _ = _state(ts, 0)
    _, tb = _blocks(*pair, "backflow_out")
    tabs = tb["tabs"]
    up_q = torch.einsum("fqb,fbi->fqi", tabs["phi_u"],
                        torch.as_tensor(up)[tb["dofmap_u"]])
    un = torch.einsum("fqi,fqi->fq", up_q, tabs["normal"])
    assert un.shape[0] == OUTLET_FACETS
    assert int((un < 0).any(dim=1).sum()) == BACKFLOW_FACETS


@pytest.mark.parametrize("vel", list(VELS))
@pytest.mark.parametrize("term", ["viscous", "backflow", "natural"])
def test_facet_residual_matches_cfdtpu(pair, term, vel):
    js, ts = pair
    u, up, p = _state(ts, 0)
    jb, tb = _blocks(js, ts, "backflow_out" if term == "backflow"
                     else "viscous_out")
    jvel, implicit = VELS[vel]
    ref = _jax_residual(js, jb, _jax_kernel(term, jvel), u, up, p)
    got = _port(term, False, tb, u, up, p, ts.params(), implicit)
    _close(got, ref)


@pytest.mark.parametrize("vel", list(VELS))
@pytest.mark.parametrize("term", ["viscous", "backflow", "natural"])
def test_facet_jacobian_matches_cfdtpu(pair, term, vel):
    js, ts = pair
    u, up, p = _state(ts, 1)
    jb, tb = _blocks(js, ts, "backflow_out" if term == "backflow"
                     else "viscous_out")
    jvel, implicit = VELS[vel]
    ref = _jax_jacobian(js, jb, _jax_kernel(term, jvel), u, up, p)
    got = _port(term, True, tb, u, up, p, ts.params(), implicit)
    _close(got, ref)
    assert not got[:, 6:, :].any()  # no continuity part: zero p rows


@pytest.mark.parametrize("term", ["viscous", "backflow"])
def test_facet_jacobian_matches_central_difference(pair, term):
    """A_f d against (r(x + e d) - r(x - e d)) / 2e: independent of
    jacfwd."""
    _, ts = pair
    u, up, p = _state(ts, 2)
    _, tb = _blocks(*pair, f"{term}_out")
    prm = ts.params()
    rng = np.random.default_rng(7)
    du, dp = rng.standard_normal(u.shape), rng.standard_normal(p.shape)
    A = _port(term, True, tb, u, up, p, prm, False)

    def r(sign):
        return _port(term, False, tb, u + sign * FD_STEP * du, up,
                     p + sign * FD_STEP * dp, prm, False).reshape(len(A), -1)

    fd = (r(1.0) - r(-1.0)) / (2 * FD_STEP)
    dm_u, dm_p = tb["dofmap_u"], tb["dofmap_p32"].long()
    d_e = torch.cat([torch.as_tensor(du)[dm_u].reshape(len(A), -1),
                     torch.as_tensor(dp)[dm_p]], dim=1)
    _close(torch.einsum("fab,fb->fa", A, d_e)[:, :6], fd, FD_RTOL)


def test_form_with_two_blocks_on_the_outlet_matches_cfdtpu(pair):
    """The dfg_2d_1 form: cells, then viscous_out, then backflow_out on
    the same facets, summed in that order; the assembled residual and
    every element Jacobian block as cfdtpu's."""
    js, ts = pair
    assert [b["name"] for b in ts.form._facet_blocks] == [
        "viscous_out", "backflow_out"]
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
    assert len(got_blocks) == len(blocks) == 2
    for (gd, ga), (jd, ja) in zip(got_blocks, blocks):
        np.testing.assert_array_equal(gd.numpy(), np.asarray(jd))
        _close(ga, ja)


def test_element_call_carries_both_blocks(pair):
    """K3's entry point with the form's two blocks (as its launch carries
    them): the cells as K3 alone gives them and each block as its own
    entry point, bit for bit on the CPU."""
    _, ts = pair
    u, up, p = (torch.as_tensor(a) for a in _state(ts, 4))
    f, prm = ts.form, ts.params()
    blocks = [f._kernel_block(b, prm) for b in f._facet_blocks]
    cargs = (u, up, p, f.dofmap_u, f.dofmap_p, f.cell_coords, f.cell_h,
             f.tabs, prm["rho"], prm["mu"], prm["dt"], prm["f"], f.eps)
    ru_e, rp_e, r_visc, r_back = ns_cell_residual_p1(*cargs, facets=blocks)
    alone = ns_cell_residual_p1(*cargs)
    assert torch.equal(ru_e, alone[0]) and torch.equal(rp_e, alone[1])
    for got, block in zip((r_visc, r_back), f._facet_blocks):
        _, ref = f._block_residual(block, u, p, (up,), prm)
        assert torch.equal(got, ref)


@pytest.mark.parametrize("name", ["viscous_out", "backflow_out"])
def test_facet_flux_matches_cfdtpu(pair, name):
    js, ts = pair
    u, _, _ = _state(ts, 5)
    ref = float(js.form.facet_flux(jnp.asarray(u), name))
    got = float(ts.form.facet_flux(torch.as_tensor(u), name))
    assert abs(got - ref) <= RTOL * abs(ref)
    with pytest.raises(KeyError):
        ts.form.facet_flux(torch.as_tensor(u), "no_such_block")


def test_cpu_tensors_launch_no_kernel(pair):
    """Every call above ran on CPU tensors: no launch was counted."""
    assert kernels.counts() == {name: 0 for name in kernels.COUNTERS}
