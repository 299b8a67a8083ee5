"""K1's node-block mode (bsr_spmv) and NodeBSR's layout choice, on the
CPU.

On the DFG 3D channel's extruded tetrahedra (the benchmark's mesh at
res_scale 6.0 in 2 layers, as tests/test_torch_dfg3d_slice.py builds
it; 375 nodes, 4,165 node blocks of 4 x 4), every NodeBSR apply at
g = 1 (the outer operator, the uu / up / pu / pp views and the SELFP
p column), with every epilogue its callers pass (la/schur.py,
solvers/stabilized_schur.py), against the same apply at g = 4 (K1's
plain version on the 16 x 16 supernode layout) and, for the products
alone, against cfdtpu's g = 1 branch (its `_ell_gather` einsums on
vals["ell"]). Tolerance 1e-12 relative in float64 and 1e-5 in float32:
the same products, summed in another order. Then the layout rule
(g = 1 on 4 x 4 blocks, g = 4 on 3 x 3, an explicit g honoured, g = 1
on triangles refused), the wrapper's refusals, and that CPU tensors
launch nothing.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfdtpu  # noqa: F401  (JAX in float64 at highest precision)
from benchmark import cell as cellmod
from benchmark.meshes import dfg3d
from cfdtpu_torch import kernels
from cfdtpu_torch.kernels.bsr_spmv import bsr_spmv, bsr_spmv_plain
from cfdtpu_torch.la.nodebsr import NodeBSR, resolve_supernode_g

torch.set_num_threads(1)

PATCH = {"dtype": "float64", "mesh": {"res_scale": 6.0, "layers": 2}}
RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}

# the NodeBSR applies and the epilogues their callers pass
SITES = ("outer", "outer + mask", "Auu + mask", "Auu cheby + scale + mask",
         "Auu cheby + add", "Aup zero rows", "Apu", "r_p - Apu z_u",
         "S: Apu residual + scale + p rows", "Apu residual + 0/1 scale",
         "App", "p column")


@pytest.fixture(scope="module")
def op3d(tmp_path_factory):
    _, _, cell, config = cellmod.resolve("dfg3d1z_developed",
                                         config_patch=PATCH)
    mesh = dfg3d.make(config, cache_dir=str(tmp_path_factory.mktemp("m")))
    s = cellmod.build_scenario(config, cell, mesh, None, "cpu").solver
    rng = np.random.default_rng(0)
    n = s.V.num_dofs
    u = s.tensor(0.3 * rng.standard_normal((n, 3)))
    up = s.tensor(0.3 * rng.standard_normal((n, 3)))
    p = s.tensor(rng.standard_normal(n))
    A = s.form.element_jacobians(u, p, (up,), s.params())
    nb1, nb4 = s._nodebsr, NodeBSR(s.form, supernode_g=4)
    return SimpleNamespace(s=s, A=A, nb1=nb1, nb4=nb4, v1=nb1.assemble(*A),
                           v4=nb4.assemble(*A))


def _cast(vals, dtype):
    return {k: v.to(dtype) for k, v in vals.items()}


def _site(nb, site, dtype, seed=1):
    """(apply, x, kw): the NodeBSR apply of `site` as its caller makes
    it, its input and its epilogue options, made with numpy."""
    rng = np.random.default_rng(seed)
    n, n_u = nb.n_nodes, nb.n_u_flat

    def vec(m):
        return torch.as_tensor(rng.standard_normal(m), dtype=dtype)

    def rows(m, frac=0.1):
        return torch.as_tensor(rng.random(m) < frac)

    full, vu, vp = vec(n_u + n), vec(n_u), vec(n)
    mask_u, mask_p = rows(n_u), rows(n, 0.05)

    def sub(which):
        return lambda vals, x, **kw: nb.apply_sub_block(vals, (), x, which,
                                                        **kw)

    outer = (lambda vals, x, **kw: nb.apply_element_matrices(vals, (), x,
                                                             **kw))
    scale_u = torch.where(mask_u, 0.0, 1.0 + vec(n_u).abs())
    cheb = (1.0 + vec(n_u).abs(), vec(n_u), 0.4, 1.7)
    return {
        "outer": (outer, full, {}),
        "outer + mask": (outer, full, dict(
            mask=torch.cat([mask_u, mask_p]), mask_value=full)),
        "Auu + mask": (sub("uu"), vu, dict(mask=mask_u, mask_value=vu)),
        "Auu cheby + scale + mask": (sub("uu"), vu, dict(
            mode="cheby", b=vec(n_u), scale=scale_u, mask=mask_u,
            cheb=(cheb[0], None, 0.4, 1.7),
            d_out=torch.empty(n_u, dtype=dtype))),
        "Auu cheby + add": (sub("uu"), vu, dict(
            mode="cheby", b=vec(n_u), cheb=cheb, add=vec(n_u))),
        "Aup zero rows": (sub("up"), vp, dict(mask=mask_u)),
        "Apu": (sub("pu"), vu, {}),
        "r_p - Apu z_u": (sub("pu"), vu, dict(mode="residual", b=vec(n))),
        "S: Apu residual + scale + p rows": (sub("pu"), vu, dict(
            mode="residual", b=vec(n), scale=scale_u, mask=mask_p,
            mask_value=vp)),
        "Apu residual + 0/1 scale": (sub("pu"), vu, dict(
            mode="residual", b=vec(n), scale=(~mask_u).to(dtype))),
        "App": (sub("pp"), vp, {}),
        "p column": (lambda vals, x: torch.cat(nb.apply_p_coupled(vals, x)),
                     vp, {}),
    }[site]


def _rel(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("site", SITES)
def test_node_blocks_match_the_supernode_layout(op3d, site, dtype):
    """Each apply at g = 1 (bsr_spmv's plain version) against the same
    apply at g = 4 (sup_spmv's), epilogue included; d_out too."""
    got_out, ref_out = [], []
    for nb, vals, outs in ((op3d.nb1, op3d.v1, got_out),
                           (op3d.nb4, op3d.v4, ref_out)):
        apply, x, kw = _site(nb, site, dtype)
        outs.append(apply(_cast(vals, dtype), x, **kw))
        if "d_out" in kw:
            outs.append(kw["d_out"])
    assert len(got_out) == len(ref_out)
    for g, r in zip(got_out, ref_out):
        assert g.dtype == dtype and g.shape == r.shape
        assert _rel(g, r) <= RTOL[dtype]


def _jax_nodebsr(s):
    """cfdtpu's NodeBSR at g = 1 on the port's form's dofmaps and facet
    blocks."""
    from cfdtpu.la.nodebsr import NodeBSR as JaxNodeBSR

    f = s.form
    space = SimpleNamespace(dofmap=np.asarray(f.V.dofmap),
                            num_dofs=f.V.num_dofs)
    stub = SimpleNamespace(
        V=space, Q=space, dim=f.dim, dtype=np.float64, n_u_flat=f.n_u_flat,
        _facet_blocks=[{"dofmap_flat": b["dofmap_flat_np"]}
                       for b in f._facet_blocks])
    return JaxNodeBSR(stub, supernode_g=1)


@pytest.mark.parametrize("view", ["outer", "uu", "up", "pu", "pp",
                                  "p column"])
def test_node_blocks_match_cfdtpu_per_node_branch(op3d, view):
    """The products alone against cfdtpu's per-node (g = 1) applies: its
    assembly of the same element Jacobians into vals["ell"] and its
    _ell_gather einsums, 1e-12 in float64."""
    jb = _jax_nodebsr(op3d.s)
    nb = op3d.nb1
    np.testing.assert_array_equal(np.asarray(jb.block_row),
                                  nb.block_row_np)
    np.testing.assert_array_equal(np.asarray(jb.block_col),
                                  nb.block_col_np)
    A_cells, A_blocks = op3d.A
    jv = jb.assemble(jnp.asarray(A_cells.numpy()),
                     [(None, jnp.asarray(A_f.numpy()))
                      for _, A_f in A_blocks])
    assert "ell" in jv
    rng = np.random.default_rng(7)
    width = {"u": nb.n_u_flat, "p": nb.n_nodes}
    if view == "outer":
        x = rng.standard_normal(nb.n_u_flat + nb.n_nodes)
        got = nb.apply_element_matrices(op3d.v1, (), torch.as_tensor(x))
        ref = jb.apply_element_matrices(jv, (), jnp.asarray(x))
    elif view == "p column":
        x = rng.standard_normal(nb.n_nodes)
        got = torch.cat(nb.apply_p_coupled(op3d.v1, torch.as_tensor(x)))
        ref = jnp.concatenate(jb.apply_p_coupled(jv, jnp.asarray(x)))
    else:
        x = rng.standard_normal(width[view[1]])
        got = nb.apply_sub_block(op3d.v1, (), torch.as_tensor(x), view)
        ref = jb.apply_sub_block(jv, (), jnp.asarray(x), view)
    assert _rel(got, torch.as_tensor(np.array(ref))) <= 1e-12


def test_layout_follows_the_node_block(op3d):
    """g = 1 on 4 x 4 blocks by default (no supernode array assembled or
    placed), g = 4 on request; resolve_supernode_g's rule."""
    assert (op3d.nb1.g, op3d.nb1.bs) == (1, 4)
    assert set(op3d.v1) == {"coo"} and op3d.nb1._sup is None
    assert op3d.nb4.g == 4 and set(op3d.v4) == {"coo", "sup"}
    assert torch.equal(op3d.v1["coo"], op3d.v4["coo"])
    assert NodeBSR(op3d.s.form, supernode_g=1).g == 1
    assert NodeBSR(op3d.s.form, supernode_g=8).g == 8
    assert resolve_supernode_g(3) == 1 and resolve_supernode_g(2) == 4
    assert resolve_supernode_g(3, 0) == 1
    assert resolve_supernode_g(2, 2) == 2
    nb = op3d.nb1
    rp = nb._bsr_rowptr.numpy()
    assert rp[0] == 0 and rp[-1] == nb.n_blocks and (np.diff(rp) > 0).all()
    assert nb._bsr_rowptr.dtype == nb._bsr_cols.dtype == torch.int32


@pytest.fixture(scope="module")
def form2d():
    from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark

    return DFG1Benchmark("stabilized_schur", dt=0.05, T=0.05, res_scale=2.5,
                         dtype="float64", device="cpu").solver


def test_triangles_keep_supernodes_and_refuse_node_blocks(form2d):
    """d = 2 resolves to g = 4 (the solver's default too), an explicit
    g > 1 is honoured, and g = 1 raises, naming the 16-byte chunks."""
    assert form2d._nodebsr.g == 4 and form2d.supernode_g is None
    assert NodeBSR(form2d.form, supernode_g=2).g == 2
    with pytest.raises(NotImplementedError, match="16-byte"):
        NodeBSR(form2d.form, supernode_g=1)
    with pytest.raises(NotImplementedError, match="16-byte"):
        resolve_supernode_g(2, 1)


def test_cpu_tensors_launch_nothing(op3d):
    kernels.reset_counts()
    for site in SITES:
        apply, x, kw = _site(op3d.nb1, site, torch.float64)
        apply(op3d.v1, x, **kw)
    assert kernels.counts()["bsr_spmv"] == 0


def test_plain_version_is_the_dense_product():
    """The plain version on a random block pattern (every node coupled to
    itself) against the dense matrix it stands for, in the flat [u; p]
    layout."""
    rng = np.random.default_rng(5)
    n, bs = 6, 4
    dense = (rng.random((n, n)) < 0.5) | np.eye(n, dtype=bool)
    row, col = np.nonzero(dense)
    vals = torch.as_tensor(rng.standard_normal((len(row), bs, bs)))
    rowptr = torch.as_tensor(np.searchsorted(row, np.arange(n + 1))
                             .astype(np.int32))
    cols = torch.as_tensor(col.astype(np.int32))
    M = np.zeros((n, bs, n, bs))
    M[row, :, col, :] = vals.numpy()
    # node-major to the flat [u; p] layout
    perm = np.concatenate([(np.arange(n)[:, None] * bs + np.arange(bs - 1))
                           .reshape(-1), np.arange(n) * bs + bs - 1])
    M = M.reshape(n * bs, n * bs)[np.ix_(perm, perm)]
    x = rng.standard_normal(n * bs)
    got = bsr_spmv(vals, rowptr, cols, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), M @ x, rtol=1e-13, atol=1e-13)
    assert torch.equal(got, bsr_spmv_plain(vals, rowptr, cols,
                                           torch.as_tensor(x)))


@pytest.mark.parametrize("bad", ["jacobi", "cheby non-square", "add no cheby",
                                 "add + mask", "mask_value no mask",
                                 "short x", "int64 cols", "view",
                                 "3x3 blocks"])
def test_refuses_what_the_kernel_is_not_built_for(op3d, bad):
    nb, vals = op3d.nb1, op3d.v1
    n, n_u = nb.n_nodes, nb.n_u_flat
    coo, rp, cols = vals["coo"], nb._bsr_rowptr, nb._bsr_cols
    u, p = torch.zeros(n_u, dtype=coo.dtype), torch.zeros(n, dtype=coo.dtype)
    mask = torch.zeros(n_u, dtype=torch.bool)
    cheb = (u, None, 0.4, 1.7)
    call = {
        "jacobi": lambda: bsr_spmv(coo, rp, cols, u, "u", "u",
                                   mode="jacobi", b=u),
        "cheby non-square": lambda: bsr_spmv(coo, rp, cols, p, "u", "p",
                                             mode="cheby", b=u, cheb=cheb),
        "add no cheby": lambda: bsr_spmv(coo, rp, cols, u, "u", "u", add=u),
        "add + mask": lambda: bsr_spmv(coo, rp, cols, u, "u", "u",
                                       mode="cheby", b=u, cheb=cheb,
                                       mask=mask, add=u),
        "mask_value no mask": lambda: bsr_spmv(coo, rp, cols, u, "u", "u",
                                               mask_value=u),
        "short x": lambda: bsr_spmv(coo, rp, cols, u[:-1], "u", "u"),
        "int64 cols": lambda: bsr_spmv(coo, rp, cols.long(), u, "u", "u"),
        "view": lambda: bsr_spmv(coo, rp, cols, u, "v", "u"),
        "3x3 blocks": lambda: bsr_spmv(coo[:, :3, :3].contiguous(), rp, cols,
                                       u, "u", "u"),
    }[bad]
    with pytest.raises(ValueError):
        call()
