"""The weak-pressure family's facet terms of cfdtpu_torch against cfdtpu
(JAX): the weak pressure (K16), symmetric Nitsche u_T = 0 in the sigma
and curl forms (K17), the convective outlet and the directional
do-nothing outlet (K18), each through its wrapper (facet_call) on CPU
tensors, which takes the plain version, against cfdtpu's facet kernel
vmapped over the same block, residual and Jacobian (vmap(jacfwd(.))),
on the inlet (18 facets) and the outlet (6) of pipe_cylinder_pressurebc
at res_scale 2.0 (2,520 DOF), float64. The
five-block form of stabilized_schur_pressure_backflow (weak pressure
and Nitsche on the inlet; resistance pressure, viscous traction and
backflow on the outlet) against cfdtpu's, in its `.at[].add` order;
the resistance pressure p_c changed between two calls with nothing
rebuilt; eight blocks in one launch, nine refused.

The state is made with numpy from a seed: the inlet profile less 0.1
plus noise, so that u_prev.n < 0 on part of each end (asserted) and
the convective and do-nothing terms are not zero there.

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
from cfdtpu.scenarios.pipe_cylinder_pressurebc import (
    PipeCylinderPressureBC as JaxPipe)

from cfdtpu_torch import kernels
from cfdtpu_torch.forms import facet_terms as tft
from cfdtpu_torch.kernels.ns_cell_residual import MAX_FACET_BLOCKS
from cfdtpu_torch.kernels.ns_facet import FacetTerm, facet_call
from cfdtpu_torch.scenarios.pipe_cylinder_pressurebc import (
    PipeCylinderPressureBC as TorchPipe)

torch.set_num_threads(1)

RTOL = 1e-12
FD_RTOL = 1e-6
FD_STEP = 1e-5
SOLVER = "stabilized_schur_pressure_backflow"
KW = dict(dt=0.05, T=1.0, res_scale=2.0, p_inlet=0.15, p_outlet=0.0,
          dtype="float64", R_resistance=1.0)
BLOCKS = ["weak_pressure_in", "nitsche_in", "resistance_out", "viscous_out",
          "backflow_out"]
# term: (cfdtpu's per-facet kernel, the port's)
TERMS = {
    "weakp": (jft.weak_pressure("p_inlet"), tft.weak_pressure("p_inlet")),
    "nitsche": (jft.nitsche_tangential("beta_nitsche"),
                tft.nitsche_tangential("beta_nitsche")),
    "nitsche_curl": (jft.nitsche_tangential_curl("beta_nitsche"),
                     tft.nitsche_tangential_curl("beta_nitsche")),
    "cbc": (jft.cbc(), tft.cbc()),
    "ddn": (jft.directional_do_nothing(), tft.directional_do_nothing()),
}
SIDES = {"inlet": "weak_pressure_in", "outlet": "backflow_out"}


@pytest.fixture(scope="module")
def pair():
    kernels.reset_counts()
    js = JaxPipe(SOLVER, **KW).solver
    ts = TorchPipe(SOLVER, device="cpu", **KW).solver
    js.p_c = ts.p_c = 0.04  # a resistance pressure that is not zero
    return js, ts


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


def _jax_residual(js, jb, kernel, u, up, p):
    J = jnp.asarray
    _, ref = js.form._block_residual(dict(jb, kernel=kernel), J(u), J(p),
                                     (J(up),), js.params())
    return ref


def _jax_jacobian(js, jb, kernel, u, up, p):
    J = jnp.asarray
    dm_u, dm_p = jb["dofmap_u"], jb["dofmap_p"]
    xef = jnp.concatenate([J(u)[dm_u].reshape(len(dm_u), -1), J(p)[dm_p]],
                          axis=1)
    fk = js.form._flat_facet_kernel(kernel)
    return jax.vmap(jax.jacfwd(fk), in_axes=(0, 0, 0, 0, None))(
        xef, (J(up)[dm_u],), jb["coords"], jb["tabs"], js.params())


def _port(term, jacobian, tb, u, up, p, prm):
    T = torch.as_tensor
    return facet_call(term, term.scalars(prm), jacobian, T(u), T(up), T(p),
                      tb["dofmap_u32"], tb["dofmap_p32"], tb["coords"],
                      tb["tabs"])


def test_state_has_reverse_flow_at_both_ends(pair):
    """u_prev.n < 0 at a quadrature point of some, not all, facets of
    the inlet and the outlet: K18 compares no zeros."""
    _, ts = pair
    _, up, _ = _state(ts, 0)
    for name in SIDES.values():
        _, tb = _blocks(*pair, name)
        tabs = tb["tabs"]
        up_q = torch.einsum("fqb,fbi->fqi", tabs["phi_u"],
                            torch.as_tensor(up)[tb["dofmap_u"]])
        un = torch.einsum("fqi,fqi->fq", up_q, tabs["normal"])
        back = int((un < 0).any(dim=1).sum())
        assert 0 < back < un.shape[0], (name, back)


@pytest.mark.parametrize("side", list(SIDES))
@pytest.mark.parametrize("term", list(TERMS))
def test_facet_residual_matches_cfdtpu(pair, term, side):
    js, ts = pair
    u, up, p = _state(ts, 0)
    jb, tb = _blocks(js, ts, SIDES[side])
    jk, tk = TERMS[term]
    ref = _jax_residual(js, jb, jk, u, up, p)
    got = _port(tk.fused, False, tb, u, up, p, ts.params())
    _close(got, ref)


@pytest.mark.parametrize("side", list(SIDES))
@pytest.mark.parametrize("term", list(TERMS))
def test_facet_jacobian_matches_cfdtpu(pair, term, side):
    js, ts = pair
    u, up, p = _state(ts, 1)
    jb, tb = _blocks(js, ts, SIDES[side])
    jk, tk = TERMS[term]
    ref = np.asarray(_jax_jacobian(js, jb, jk, u, up, p))
    got = _port(tk.fused, True, tb, u, up, p, ts.params())
    assert not got[:, 6:, :].any()  # no continuity part: zero p rows
    if term == "weakp":
        # it reads no state: its Jacobian is zero, in both packages
        assert not ref.any() and not got.any()
        assert got.shape == ref.shape
    else:
        _close(got, ref)


@pytest.mark.parametrize("term", ["nitsche", "nitsche_curl", "cbc", "ddn"])
def test_facet_jacobian_matches_central_difference(pair, term):
    """A_f d against (r(x + e d) - r(x - e d)) / 2e on the outlet:
    independent of jacfwd."""
    _, ts = pair
    u, up, p = _state(ts, 2)
    _, tb = _blocks(*pair, "backflow_out")
    prm = ts.params()
    ft = TERMS[term][1].fused
    rng = np.random.default_rng(7)
    du, dp = rng.standard_normal(u.shape), rng.standard_normal(p.shape)
    A = _port(ft, True, tb, u, up, p, prm)

    def r(sign):
        return _port(ft, False, tb, u + sign * FD_STEP * du, up,
                     p + sign * FD_STEP * dp, prm).reshape(len(A), -1)

    fd = (r(1.0) - r(-1.0)) / (2 * FD_STEP)
    dm_u, dm_p = tb["dofmap_u"], tb["dofmap_p32"].long()
    d_e = torch.cat([torch.as_tensor(du)[dm_u].reshape(len(A), -1),
                     torch.as_tensor(dp)[dm_p]], dim=1)
    _close(torch.einsum("fab,fb->fa", A, d_e)[:, :6], fd, FD_RTOL)


def test_ddn_is_the_backflow_body_at_minus_half(pair):
    """min(a, 0) and (a - |a|) / 2 are equal in floating point, so the
    directional do-nothing term is K13's body with -1/2 in place of
    -beta rho: bit for bit on the CPU, and cfdtpu's
    directional_do_nothing within 1e-12."""
    js, ts = pair
    a = np.random.default_rng(3).standard_normal(10_000)
    a[::7] = 0.0
    assert np.array_equal(np.minimum(a, 0.0), 0.5 * (a - np.abs(a)))
    u, up, p = _state(ts, 4)
    jb, tb = _blocks(js, ts, "backflow_out")
    ddn = FacetTerm("ddn")
    back = FacetTerm("backflow", beta_key="beta_half")
    prm = dict(ts.params(), beta_half=0.5, rho=1.0)
    assert ddn.coefs(ddn.scalars(prm)) == back.coefs(back.scalars(prm))
    for jac in (False, True):
        assert torch.equal(_port(ddn, jac, tb, u, up, p, prm),
                           _port(back, jac, tb, u, up, p, prm))
    _close(_port(ddn, False, tb, u, up, p, prm),
           _jax_residual(js, jb, jft.directional_do_nothing(), u, up, p))


def test_five_block_form_matches_cfdtpu(pair):
    """stabilized_schur_pressure_backflow's form: the cells, then the five
    blocks in the order they were added (cfdtpu's .at[dm_u].add order):
    the assembled residual and every element Jacobian block."""
    js, ts = pair
    assert [b["name"] for b in ts.form._facet_blocks] == BLOCKS
    assert [b["term"].term for b in ts.form._facet_blocks] == [
        "weakp", "nitsche", "weakp", "viscous", "backflow"]
    u, up, p = _state(ts, 5)
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
    assert len(got_blocks) == len(blocks) == 5
    for name, (gd, ga), (jd, ja) in zip(BLOCKS, got_blocks, blocks):
        np.testing.assert_array_equal(gd.numpy(), np.asarray(jd))
        if name.startswith(("weak", "resistance")):
            assert not ga.any() and not np.asarray(ja).any()
        else:
            _close(ga, ja)


def test_p_c_change_reaches_the_next_call(pair):
    """p_c is read from prm at every call: a new value between two
    residual calls moves the outlet rows by 0.5 dp_c int phi n, with
    nothing rebuilt, as cfdtpu's do; the Jacobian does not move."""
    js, ts = pair
    u, up, p = _state(ts, 6)
    J, T = jnp.asarray, torch.as_tensor
    form = ts.form
    before = dict(vars(form))
    out = {}
    for p_c in (0.0, 0.04, 0.08):
        js.p_c = ts.p_c = p_c
        out[p_c] = (ts.form.residual(T(u), T(p), (T(up),), ts.params()),
                    js.form.residual(J(u), J(p), (J(up),), js.params()))
        _close(out[p_c][0][0], out[p_c][1][0])
        _close(out[p_c][0][1], out[p_c][1][1])
    js.p_c = ts.p_c = 0.04
    d1 = out[0.04][0][0] - out[0.0][0][0]
    d2 = out[0.08][0][0] - out[0.04][0][0]
    assert d1.abs().max() > 0
    _close(d2, d1, 1e-9)
    assert torch.equal(out[0.04][0][1], out[0.0][0][1])  # no p rows
    _, tb = _blocks(js, ts, "resistance_out")
    wp = _port(tft.weak_pressure("p_c", 0.5).fused, False, tb, u, up, p,
               dict(ts.params(), p_c=1.0))
    _close(d1, 0.04 * tb["scatter_u"](wp.reshape(-1, 2).contiguous()),
           1e-9)
    assert vars(form).keys() == before.keys()
    assert all(vars(form)[k] is v for k, v in before.items())


def test_eight_blocks_in_a_launch_nine_refused(pair, monkeypatch):
    """The element kernel's launch carries up to MAX_FACET_BLOCKS = 8
    blocks: eight (the five, then three of them again) sum as the five
    plus the three repeated; a ninth is refused, on any device."""
    _, ts = pair
    assert MAX_FACET_BLOCKS == 8
    u, up, p = (torch.as_tensor(a) for a in _state(ts, 8))
    prm = ts.params()
    form = ts.form
    five = list(form._facet_blocks)
    base = form.residual(u, p, (up,), prm)
    extra = five[1:4]
    monkeypatch.setattr(form, "_facet_blocks", five + extra)
    eight = form.residual(u, p, (up,), prm)
    want = base[0]
    for block in extra:
        _, ru_f = form._block_residual(block, u, p, (up,), prm)
        want = want + block["scatter_u"](ru_f.reshape(-1, 2).contiguous())
    _close(eight[0], want, 1e-13)
    assert torch.equal(eight[1], base[1])
    A_c, A_b = form.element_jacobians(u, p, (up,), prm)
    assert len(A_b) == 8
    monkeypatch.setattr(form, "_facet_blocks", five + extra + five[:1])
    for call in (form.residual, form.element_jacobians):
        with pytest.raises(NotImplementedError, match="facet blocks"):
            call(u, p, (up,), prm)


def test_cpu_tensors_launch_no_kernel(pair):
    """Every call above ran on CPU tensors: no launch was counted."""
    assert kernels.counts() == {name: 0 for name in kernels.COUNTERS}
