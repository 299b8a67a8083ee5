"""K2 in CSR form against cfdtpu (JAX): the plain version of ell_sum over
each SortedScatter's (row_ptr, pos) layout, on every map of the
rasamg_sup solver (the residual's u and p scatters, the facet scatter,
the node-BSR assembly, the SELFP product scatter, and the SELFP AMG and
velocity block-AMG restricts and Galerkin coarsens at every level),
against cfdtpu's SortedScatter, AMGLevel segment sums and the facet
term's .at[].add. DFG 2D-1 at res_scale 1.0, float64, inputs made with
numpy. Also the host plans of K2 (lanes per output, loads per round)
and K6 (rows per block, blocks, bulk copies).

Tolerance 1e-12 relative: float64 on both sides, each destination sums
the same contributions in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdtpu.scenarios.dfg_1 import DFG1Benchmark as JaxDFG

from cfdtpu_torch import kernels
from cfdtpu_torch.kernels.ell_sum import ell_plan, ell_sum_plain
from cfdtpu_torch.kernels.ras_apply import MAX_SMEM, ras_plan, ras_smem
from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark as TorchDFG

torch.set_num_threads(1)

RTOL = 1e-12
KW = dict(dt=0.05, T=1.0, res_scale=1.0, dtype="float64",
          pc_inner_method="rasamg_sup", pc_inner_u=0, pc_inner_p=5,
          pc_ras_size=32, snes_lag_jacobian=True, pc_lag_steps=4,
          ksp_restart=20)
RAS = (32, 4)


@pytest.fixture(scope="module")
def pair():
    js = JaxDFG("stabilized_schur", **KW).solver
    ts = TorchDFG("stabilized_schur", device="cpu", **KW).solver
    kernels.reset_counts()
    return js, ts


def _close(got, ref):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= RTOL * max(np.abs(ref).max(), 1e-300)


def _maps(js, ts, name):
    """[(port SortedScatter, row shape, cfdtpu reference function)] of one
    family of maps, every level of the AMG ones."""
    jf, tf = js.form, ts.form
    jb, tb = js._nodebsr, ts._nodebsr
    if name in ("residual_u", "residual_p", "assembly", "selfp"):
        jsc, tsc, shape = {
            "residual_u": (jf._scatter_u, tf._scatter_u, (2,)),
            "residual_p": (jf._scatter_p, tf._scatter_p, ()),
            "assembly": (jb._assemble_scatter, tb._assemble_scatter, (9,)),
            "selfp": (jb._sp_scatter, tb._sp_scatter, ()),
        }[name]
        return [(tsc, shape, jsc)]
    if name == "facet_u":
        (jblock,), (tblock,) = jf._facet_blocks, tf._facet_blocks
        dm = jnp.asarray(np.asarray(jblock["dofmap_u"]).reshape(-1))
        n = ts.V.num_dofs
        return [(tblock["scatter_u"], (2,),
                 lambda v: jnp.zeros((n, 2)).at[dm].add(v))]
    if name.startswith("amg"):
        jl, tl = jb.sp_amg().levels, tb.sp_amg().levels
        shape = ()
    else:
        jl = jb.uu_amg(fine_smoother=jb.uu_ras(*RAS)).levels
        tl = tb.uu_amg(fine_smoother=tb.uu_ras(*RAS)).levels
        shape = (2,) if name.endswith("restrict") else (2, 2)
    assert len(jl) == len(tl) >= 1
    out = []
    for j, t in zip(jl, tl):
        if name == "amg_restrict":
            out.append((t._restrict, shape, j.restrict))
        elif name == "amg_coarsen":
            out.append((t._coarsen, shape, j.coarsen_vals))
        elif name == "block_restrict":
            out.append((t._restrict, shape,
                        lambda v, j=j: j.restrict_block(v.reshape(-1), 2)
                        .reshape(-1, 2)))
        else:
            out.append((t._coarsen, shape, j.coarsen_block_vals))
    return out


MAPS = ["residual_u", "residual_p", "facet_u", "assembly", "selfp",
        "amg_restrict", "amg_coarsen", "block_restrict", "block_coarsen"]


@pytest.mark.parametrize("name", MAPS)
def test_plain_csr_sum_matches_cfdtpu(pair, name):
    js, ts = pair
    rng = np.random.default_rng(MAPS.index(name))
    for tsc, shape, ref_fn in _maps(js, ts, name):
        n_out = tsc.row_ptr.shape[0] - 1
        assert n_out == tsc.n_out and tsc.pos.shape[0] == tsc.n_in
        # a permutation of the sources, offsets from 0 to n_in
        assert torch.equal(torch.sort(tsc.pos.long()).values,
                           torch.arange(tsc.n_in))
        assert int(tsc.row_ptr[0]) == 0 and int(tsc.row_ptr[-1]) == tsc.n_in
        vals = rng.standard_normal((tsc.n_in,) + shape)
        got = ell_sum_plain(torch.as_tensor(vals), tsc.row_ptr, tsc.pos,
                            tsc.K)
        _close(got, ref_fn(jnp.asarray(vals)))
        _close(tsc(torch.as_tensor(vals)), ref_fn(jnp.asarray(vals)))
    assert kernels.counts()["ell_sum"] == 0  # CPU tensors: plain versions


@pytest.mark.parametrize("n_out,F,nnz,K,plan", [
    (35425, 2, 210285, 9, (2, 4)),     # residual u: two rounds of 4
    (35425, 1, 210285, 9, (2, 4)),     # residual p
    (35425, 2, 2265, 3, (1, 4)),       # facet: one round
    (246465, 9, 637650, 10, (1, 4)),   # assembly: F not a power of two
    (693117, 1, 1745305, 10, (1, 4)),  # SELFP: the card is full at G=1
    (3869, 1, 35425, 23, (8, 4)),      # restrict L0: small, one round
    (55, 2, 431, 15, (4, 4)),          # block restrict L2
    (33395, 1, 693117, 249, (8, 4)),   # SELFP coarsen L0: thread cap
    (26535, 4, 246465, 115, (4, 4)),   # block coarsen L0: thread cap
    (2332, 1, 33395, 134, (32, 4)),    # coarsen L1: a warp per output
    (309, 4, 2825, 71, (8, 16)),       # block coarsen L2: G*F = 32
    (2000, 1, 6000, 250, (32, 4)),     # one long row: a warp, 2 rounds
    (600, 2, 9000, 200, (16, 16)),     # G*F = 32 and still 4 rounds
])
def test_ell_plan(n_out, F, nnz, K, plan):
    G, loads = ell_plan(n_out, F, nnz, K)
    assert (G, loads) == plan
    assert G == 1 or 32 % (G * F) == 0


@pytest.mark.parametrize("nd,sd,m,size,ptr,plan", [
    (70850, 64, 80, 4, 0, (537, 132, 1)),    # the bench's windows, float32
    (70850, 64, 80, 8, 256, (355, 200, 1)),  # float64: runs fit the smem
    (6574, 64, 80, 4, 0, (50, 132, 1)),      # res 1.0: 103 windows
    (54, 64, 80, 4, 0, (1, 54, 1)),          # one window, fewer rows than SMs
    (2000, 14, 26, 4, 0, (16, 125, 0)),      # s=7, o=3: rows of 104 bytes
    (2000, 7, 13, 8, 0, (16, 125, 0)),       # d=1: rows of 104 bytes
    (70850, 64, 80, 4, 8, (537, 132, 0)),    # an array off 16-byte alignment
])
def test_ras_plan(nd, sd, m, size, ptr, plan):
    per_block, blocks, bulk = ras_plan(nd, sd, m, size, ptr, 132)
    assert (per_block, blocks, bulk) == plan
    assert (blocks - 1) * per_block < nd <= blocks * per_block
    assert ras_smem(per_block, sd, m, size) <= MAX_SMEM


def test_ras_plan_refuses_a_window_beyond_shared_memory():
    with pytest.raises(ValueError, match="exceeds shared memory"):
        ras_plan(100000, 256, 16000, 8, 0, 132)
