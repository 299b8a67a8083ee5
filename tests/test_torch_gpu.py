"""cfdtpu_torch CUDA kernels against their plain versions, on the card.

Marked `gpu`: each test skips where torch has no CUDA device (the
kernels are CUDA C++ with no interpret mode). On a machine with a card:

    python -m pytest tests/test_torch_gpu.py -m gpu -q

Inputs are the DFG 2D-1 maps at res_scale 2.5 in float64 (the cycle
tests: 1.0, where both hierarchies have levels) and a random state made
with numpy. Tolerance 1e-12 relative: float64 on both sides, only the
order of the sums differs.
"""

import time

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

RTOL = 1e-12


@pytest.fixture(scope="module")
def sc():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark

    return DFG1Benchmark("stabilized_schur", dt=0.05, T=1.0,
                         res_scale=2.5, dtype="float64", device="cuda",
                         pc_lag_steps=4, snes_lag_jacobian=True)


def _close(got, ref):
    err = float((got - ref).abs().max())
    assert err <= RTOL * float(ref.abs().max()), err


def _state(s, seed=0):
    rng = np.random.default_rng(seed)
    n_u, n_p = s.V.num_dofs, s.Q.num_dofs
    return (s.tensor(0.3 * rng.standard_normal((n_u, 2))),
            s.tensor(0.3 * rng.standard_normal((n_u, 2))),
            s.tensor(rng.standard_normal(n_p)))


def test_kernels_match_plain_and_count(sc):
    from cfdtpu_torch import kernels
    from cfdtpu_torch.kernels.ell_sum import ell_sum, ell_sum_plain
    from cfdtpu_torch.kernels.ns_cell_residual import (
        ns_cell_residual_p1, ns_cell_residual_plain)
    from cfdtpu_torch.kernels.selfp_triple import (selfp_triple,
                                                   selfp_triple_plain)
    from cfdtpu_torch.kernels.sup_spmv import sup_spmv, sup_spmv_plain

    s = sc.solver
    f, nb = s.form, s._nodebsr
    u, up, p = _state(s)
    prm = s.params()
    kernels.reset_counts()
    args = (u, up, p, f.dofmap_u, f.dofmap_p, f.cell_coords, f.cell_h,
            f.tabs, prm["rho"], prm["mu"], prm["dt"], prm["f"], f.eps)
    for g, r in zip(ns_cell_residual_p1(*args),
                    ns_cell_residual_plain(*args)):
        _close(g, r)
    vals = nb.assemble(*f.element_jacobians(u, p, (up,), prm))
    v = s.tensor(np.ones(nb.n_u_flat + nb.n_nodes))
    cols = nb._sup.sup_cols
    split = (nb.n_u_flat, nb.g * nb.dim)
    _close(sup_spmv(vals["sup"], cols, v, v.shape[0], x_split=split,
                    y_split=split),
           sup_spmv_plain(vals["sup"], cols, v, v.shape[0], x_split=split,
                          y_split=split))
    scat = nb._assemble_scatter
    src = s.tensor(np.arange(scat.n_in * 9.0).reshape(-1, 9))
    csr = (scat.row_ptr, scat.pos, scat.K)
    _close(ell_sum(src, *csr), ell_sum_plain(src, *csr))
    inv = s.tensor(np.ones((nb.n_nodes, 2)))
    sargs = (vals["coo"], nb._sp_e1, nb._sp_e2, nb._sp_K, inv)
    _close(selfp_triple(*sargs), selfp_triple_plain(*sargs))
    torch.cuda.synchronize()
    n = kernels.counts()
    assert all(n[k] > 0 for k in ("ns_cell_residual_p1", "sup_spmv",
                                  "ell_sum", "selfp_triple"))


def test_step_on_card_matches_cpu(sc):
    """One float64 step through the kernels equals the plain versions
    (CPU) in iteration counts and state."""
    from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark

    cpu = DFG1Benchmark("stabilized_schur", dt=0.05, T=1.0, res_scale=2.5,
                        dtype="float64", device="cpu", pc_lag_steps=4,
                        snes_lag_jacobian=True)
    out = []
    for scen in (sc, cpu):
        s = scen.solver
        s.solveStep()
        out.append((s.last_stats["newton_iters"], s.last_stats["ksp_iters"],
                    s.u_sol.cpu().numpy()))
    assert out[0][:2] == out[1][:2]
    rel = np.linalg.norm(out[0][2] - out[1][2]) / np.linalg.norm(out[1][2])
    assert rel < 1e-9


def test_new_kernels_match_plain_and_count(sc):
    """K5 patch_spmv and K6 ras_apply (plain and with its add epilogue)
    against their plain versions, in float64 and float32."""
    from cfdtpu_torch import kernels
    from cfdtpu_torch.kernels.patch_spmv import patch_spmv, patch_spmv_plain
    from cfdtpu_torch.kernels.ras_apply import ras_apply, ras_apply_plain

    s = sc.solver
    nb = s._nodebsr
    rng = np.random.default_rng(1)
    kernels.reset_counts()
    for dt, tol in ((torch.float64, RTOL), (torch.float32, 1e-5)):
        x = torch.as_tensor(rng.standard_normal((64, 128)), dtype=dt,
                            device="cuda")
        vals = torch.as_tensor(rng.standard_normal((64, 128, 8)), dtype=dt,
                               device="cuda")
        idx = torch.as_tensor(rng.integers(0, 128, (64, 128, 8)),
                              dtype=torch.int32, device="cuda")
        got, ref = patch_spmv(x, vals, idx), patch_spmv_plain(x, vals, idx)
        assert float((got - ref).abs().max()) <= tol * float(
            ref.abs().max())
        for so in ((32, 4), (16, 4), (7, 3)):
            ras = nb.uu_ras(*so)
            inv = torch.as_tensor(rng.standard_normal(
                (ras.n_sub, ras.m, ras.m)), dtype=dt, device="cuda")
            v = torch.as_tensor(rng.standard_normal(nb.n_u_flat), dtype=dt,
                                device="cuda")
            inv = inv[:, ras.o * ras.d:(ras.o + ras.s) * ras.d].contiguous()
            for base in (None, v * 0.5):
                got = ras_apply(inv, v, ras.s, ras.o, ras.d, base)
                ref = ras_apply_plain(inv, v, ras.s, ras.o, ras.d, base)
                assert float((got - ref).abs().max()) <= tol * float(
                    ref.abs().max())
    torch.cuda.synchronize()
    assert kernels.counts()["patch_spmv"] == 2
    assert kernels.counts()["ras_apply"] == 12


# K1's shape classes: name -> (parent width, rows, columns, x split width,
# output split row), as in tests/test_torch_sup_spmv.py
K1_CASES = {
    "full 12x12 two segments": (12, slice(None), slice(None), 8, 8),
    "12x12 one segment": (12, slice(None), slice(None), None, None),
    "uu 8x8 view of 12": (12, slice(0, 8), slice(0, 8), None, None),
    "up 8x4 view": (12, slice(0, 8), slice(8, None), None, None),
    "pu 4x8 view": (12, slice(8, None), slice(0, 8), None, None),
    "pp 4x4 view": (12, slice(8, None), slice(8, None), None, None),
    "p-coupled 12x4 view": (12, slice(None), slice(8, None), None, 8),
    "amg 8x8": (8, slice(None), slice(None), None, None),
    "block-amg 16x16": (16, slice(None), slice(None), None, None),
    "width 1": (1, slice(None), slice(None), None, None),
}


@pytest.mark.parametrize("ns", [600, 6000])
@pytest.mark.parametrize("name", list(K1_CASES))
def test_k1_shape_grid_matches_plain_and_repeats(name, ns):
    """K1 against its plain version at every shape class, in float64
    (1e-12) and float32 (1e-5), in each mode the class takes; two calls
    are bitwise equal. 600 supernodes take the small levels' plans (the
    blocks split over lanes), 6000 the large sites' (two rows per lane);
    padded slots, short vectors and short outputs are in every case."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cfdtpu_torch import kernels
    from cfdtpu_torch.kernels.sup_spmv import sup_spmv, sup_spmv_plain

    g, rs, cs, xs, ys = K1_CASES[name]
    kg = 9
    rng = np.random.default_rng(11)
    kernels.reset_counts()
    n_calls = 0
    for dt, tol in ((torch.float64, RTOL), (torch.float32, 1e-5)):
        def dev(a):
            return torch.as_tensor(a, dtype=dt, device="cuda")

        A = dev(rng.standard_normal((ns, kg, g, g)))[:, :, rs, cs]
        R, C = A.shape[2], A.shape[3]
        c = rng.integers(0, ns, (ns, kg))
        c[:, -2:] = ns
        cols = torch.as_tensor(c, dtype=torch.int32, device="cuda")
        xsplit = None if xs is None else (ns * xs - 5, xs)
        ysplit = None if ys is None else (ns * ys - 5, ys)
        m = ns * C - 7 if xs is None else ns * C - 12
        n_out = ns * R - 7 if ys is None else ns * R - 12
        square = xs is None and ys is None and R == C
        if square:
            m = n_out
        x, b = dev(rng.standard_normal(m)), dev(rng.standard_normal(n_out))
        d = dev(1.0 + rng.random(n_out))
        for mode in ("y", "residual", "jacobi") if square else ("y",):
            kw = dict(mode=mode, b=b, d=d, omega=0.67, x_split=xsplit,
                      y_split=ysplit)
            got = sup_spmv(A, cols, x, n_out, **kw)
            again = sup_spmv(A, cols, x, n_out, **kw)
            ref = sup_spmv_plain(A, cols, x, n_out, **kw)
            n_calls += 2
            _close_tol(got, ref, tol)
            assert torch.equal(got, again)
    torch.cuda.synchronize()
    assert kernels.counts()["sup_spmv"] == n_calls


@pytest.mark.parametrize("ns", [600, 6000])
@pytest.mark.parametrize("name", list(K1_CASES))
def test_k1_options_match_plain_and_repeat(name, ns):
    """K1's input scale (one flat x only), row mask (with and without
    mask values) and the residual mode with b from any vector, alone and
    together, in each mode the class takes, with x at a 16-byte and at a
    4-byte offset: within the tolerance of the plain version, two calls
    bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cfdtpu_torch.kernels.sup_spmv import sup_spmv, sup_spmv_plain

    g, rs, cs, xs, ys = K1_CASES[name]
    kg = 9
    rng = np.random.default_rng(12)
    for dt, tol in ((torch.float64, RTOL), (torch.float32, 1e-5)):
        def dev(a):
            return torch.as_tensor(a, dtype=dt, device="cuda")

        A = dev(rng.standard_normal((ns, kg, g, g)))[:, :, rs, cs]
        R, C = A.shape[2], A.shape[3]
        cols = torch.as_tensor(rng.integers(0, ns + 1, (ns, kg)),
                               dtype=torch.int32, device="cuda")
        xsplit = None if xs is None else (ns * xs - 5, xs)
        ysplit = None if ys is None else (ns * ys - 5, ys)
        n_out = ns * R - 7 if ys is None else ns * R - 12
        square = xs is None and ys is None and R == C
        m = n_out if square else (ns * C - 7 if xs is None else ns * C - 12)
        b = dev(rng.standard_normal(n_out))
        mv = dev(rng.standard_normal(n_out))
        d = dev(1.0 + rng.random(n_out))
        mask = torch.as_tensor(rng.random(n_out) < 0.1, device="cuda")
        for off in (0, 1):  # aligned, and one value past it
            x = dev(rng.standard_normal(m + 1))[off: off + m]
            sc = (None if xs is not None
                  else dev(rng.standard_normal(m + 1))[off: off + m])
            modes = ("y", "residual", "jacobi") if square else ("y",
                                                                "residual")
            for mode in modes:
                for opts in ({"scale": sc}, {"mask": mask},
                             {"mask": mask, "mask_value": mv},
                             {"scale": sc, "mask": mask, "mask_value": mv}):
                    if "scale" in opts and sc is None:
                        continue
                    kw = dict(mode=mode, b=b, d=d, omega=0.67,
                              x_split=xsplit, y_split=ysplit, **opts)
                    got = sup_spmv(A, cols, x, n_out, **kw)
                    _close_tol(got, sup_spmv_plain(A, cols, x, n_out, **kw),
                               tol)
                    assert torch.equal(got, sup_spmv(A, cols, x, n_out,
                                                     **kw))
    torch.cuda.synchronize()


def _close_tol(got, ref, tol):
    err = float((got - ref).abs().max())
    assert err <= tol * float(ref.abs().max()), err


def test_apply_is_one_device_kernel(sc):
    """NodeBSR.apply_element_matrices issues exactly one device kernel,
    K1: no fill, copy or concatenation around it (torch.profiler)."""
    from cfdtpu_torch.utils.cudatime import device_kernels

    s = sc.solver
    nb = s._nodebsr
    u, up, p = _state(s, seed=4)
    vals = nb.assemble(*s.form.element_jacobians(u, p, (up,), s.params()))
    v = s.tensor(np.random.default_rng(4).standard_normal(
        nb.n_u_flat + nb.n_nodes))
    names = device_kernels(lambda: nb.apply_element_matrices(vals, (), v))
    assert len(names) == 1 and "sup_spmv" in names[0], names


def test_residual_bitwise_repeatable():
    """Two float32 residual calls on one state are bitwise equal (the
    facet term is a K2 reduction, not an atomic index_add)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark

    s = DFG1Benchmark("stabilized_schur", dt=0.05, T=1.0, res_scale=1.0,
                      dtype="float32", device="cuda").solver
    u, up, p = _state(s, seed=3)
    a = s.form.residual(u, p, (up,), s.params())
    b = s.form.residual(u, p, (up,), s.params())
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _dev_tol(dt):
    return torch.float64 if dt == "f64" else torch.float32, (
        RTOL if dt == "f64" else 1e-5)


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("n_sub", [1, 37, 1108])
def test_k6_grid_matches_plain_and_repeats(n_sub, dt):
    """K6 at the bench's window shape (s=32, o=4, d=2), at an odd one
    (s=7, o=3: rows of 26 values) and at d=1 (rows of 13), whose rows
    are no multiple of 16 bytes, so the block copies them with its
    threads instead of bulk copies; the last window padded (n = n_sub*s
    - 5 nodes), in both modes: within the tolerance of its plain
    version, two calls bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cfdtpu_torch import kernels
    from cfdtpu_torch.kernels.ras_apply import ras_apply, ras_apply_plain

    dtype, tol = _dev_tol(dt)
    rng = np.random.default_rng(n_sub)
    kernels.reset_counts()
    calls = 0
    for s, o, d in ((32, 4, 2), (7, 3, 2), (7, 3, 1)):
        n = max(n_sub * s - 5, 1)
        m = (s + 2 * o) * d

        def dev(*shape):
            return torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                                   device="cuda")

        inv, x, base = dev(n_sub, s * d, m), dev(n * d), dev(n * d)
        for b in (None, base):
            got = ras_apply(inv, x, s, o, d, b)
            again = ras_apply(inv, x, s, o, d, b)
            calls += 2
            _close_tol(got, ras_apply_plain(inv, x, s, o, d, b), tol)
            assert torch.equal(got, again)
    torch.cuda.synchronize()
    assert kernels.counts()["ras_apply"] == calls


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("F", [1, 2, 4])
@pytest.mark.parametrize("K", [1, 9, 33, 250])
def test_k2_grid_matches_plain_and_repeats(K, F, dt):
    """K2 on a random map whose largest row has K contributions (one row
    of K, the rest 0..min(K, 12), some empty), F features per row: the
    short-row plan (K <= 16) and the lane-split plans, against the plain
    version; two calls bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cfdtpu_torch import kernels
    from cfdtpu_torch.kernels.ell_sum import ell_sum, ell_sum_plain
    from cfdtpu_torch.utils.geometry import SortedScatter

    dtype, tol = _dev_tol(dt)
    rng = np.random.default_rng(K * 10 + F)
    n_out = 5000
    cnt = rng.integers(0, min(K, 12) + 1, n_out)
    cnt[rng.integers(n_out)] = K
    flat = rng.permutation(np.repeat(np.arange(n_out), cnt))
    scat = SortedScatter(flat, n_out, device="cuda")
    assert scat.K == K
    src = torch.as_tensor(rng.standard_normal((len(flat),) + (F,) * (F > 1)),
                          dtype=dtype, device="cuda")
    kernels.reset_counts()
    csr = (scat.row_ptr, scat.pos, scat.K)
    got, again = ell_sum(src, *csr), ell_sum(src, *csr)
    _close_tol(got, ell_sum_plain(src, *csr), tol)
    assert torch.equal(got, again)
    torch.cuda.synchronize()
    assert kernels.counts()["ell_sum"] == 2


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_k2_k6_call_sites_match_plain_and_repeat(sc, dt):
    """K2 at every SortedScatter of the rasamg_sup solver (residual u and
    p, facet, assembly, SELFP, the AMG and block-AMG restricts and
    coarsens at every level) and K6 on the RAS windows of the bench
    (s=32, o=4), in both modes: within the tolerance of the plain
    version, two calls bitwise equal."""
    from cfdtpu_torch.kernels.ell_sum import ell_sum, ell_sum_plain
    from cfdtpu_torch.kernels.ras_apply import ras_apply, ras_apply_plain

    dtype, tol = _dev_tol(dt)
    s = sc.solver
    f, nb = s.form, s._nodebsr
    ras = nb.uu_ras(32, 4)
    amg, bamg = nb.sp_amg(), nb.uu_amg(fine_smoother=ras)
    scats = [(f._scatter_u, (2,)), (f._scatter_p, ()),
             (f._facet_blocks[0]["scatter_u"], (2,)),
             (nb._assemble_scatter, (9,)), (nb._sp_scatter, ())]
    scats += [(getattr(lv, a), ()) for lv in amg.levels
              for a in ("_restrict", "_coarsen")]
    scats += [(lv._restrict, (2,)) for lv in bamg.levels]
    scats += [(lv._coarsen, (2, 2)) for lv in bamg.levels]
    rng = np.random.default_rng(5)

    def dev(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                               device="cuda")

    for scat, shape in scats:
        src = dev(scat.n_in, *shape)
        csr = (scat.row_ptr, scat.pos, scat.K)
        got, again = ell_sum(src, *csr), ell_sum(src, *csr)
        _close_tol(got, ell_sum_plain(src, *csr), tol)
        assert torch.equal(got, again)
    inv = dev(ras.n_sub, ras.s * ras.d, ras.m)
    x = dev(nb.n_u_flat)
    for b in (None, x * 0.5):
        got = ras_apply(inv, x, ras.s, ras.o, ras.d, b)
        _close_tol(got, ras_apply_plain(inv, x, ras.s, ras.o, ras.d, b), tol)
        assert torch.equal(got, ras_apply(inv, x, ras.s, ras.o, ras.d, b))


def _element_args(s, dtype, seed):
    """(K3's arguments, K7's arguments) at a random state in `dtype`."""
    f, prm = s.form, s.params()
    u, up, p = (t.to(dtype) for t in _state(s, seed))
    up[: len(up) // 3] = 0  # cells at rest: tau's eps guard
    cast = (lambda t: t.to(dtype).contiguous())
    tabs = type(f.tabs)(**{
        k: (cast(v) if torch.is_tensor(v) else v)
        for k, v in vars(f.tabs).items()})
    cargs = (u, up, p, f.dofmap_u, f.dofmap_p, cast(f.cell_coords),
             cast(f.cell_h), tabs, prm["rho"], prm["mu"], prm["dt"],
             prm["f"], float(np.finfo(np.dtype(str(dtype)[6:])).resolution))
    fb = f._facet_blocks[0]
    fargs = (u, up, p, fb["dofmap_u32"], fb["dofmap_p32"],
             cast(fb["coords"]), {k: cast(v) for k, v in fb["tabs"].items()},
             prm["mu"])
    return cargs, fargs


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("entry", ["cell residual", "cell jacobian",
                                   "facet residual", "facet jacobian"])
def test_element_kernels_match_plain_and_repeat(sc, entry, dt):
    """K3 (residual and Jacobian) and K7 (residual and Jacobian) against
    their plain versions, two calls bitwise equal, one launch counted
    per call."""
    from cfdtpu_torch import kernels
    from cfdtpu_torch.kernels import ns_cell_residual as k3
    from cfdtpu_torch.kernels import ns_facet as k7

    dtype, tol = _dev_tol(dt)
    cargs, fargs = _element_args(sc.solver, dtype, seed=8)
    kern, plain, args, name = {
        "cell residual": (k3.ns_cell_residual_p1, k3.ns_cell_residual_plain,
                          cargs, "ns_cell_residual_p1"),
        "cell jacobian": (k3.ns_cell_jacobian_p1, k3.ns_cell_jacobian_plain,
                          cargs, "ns_cell_jacobian_p1"),
        "facet residual": (k7.ns_facet_natural_p1, k7.ns_facet_natural_plain,
                           fargs, "ns_facet_natural_p1"),
        "facet jacobian": (k7.ns_facet_natural_jac_p1,
                           k7.ns_facet_natural_jac_plain, fargs,
                           "ns_facet_natural_jac_p1"),
    }[entry]
    kernels.reset_counts()
    got, again, ref = kern(*args), kern(*args), plain(*args)
    torch.cuda.synchronize()
    as_tuple = (lambda o: o if isinstance(o, tuple) else (o,))
    for g, a, r in zip(as_tuple(got), as_tuple(again), as_tuple(ref)):
        assert g.shape == r.shape and g.dtype == r.dtype
        _close_tol(g, r, tol)
        assert torch.equal(g, a)
    assert kernels.counts()[name] == 2


def test_element_kernels_reject_other_forms(sc):
    """On CUDA tensors a form that is not P1 raises: no fallback."""
    import dataclasses

    from cfdtpu_torch.kernels import ns_cell_residual as k3
    from cfdtpu_torch.kernels import ns_facet as k7

    cargs, fargs = _element_args(sc.solver, torch.float64, seed=1)
    other = cargs[:7] + (dataclasses.replace(cargs[7], p1=False),) + cargs[8:]
    for kern in (k3.ns_cell_residual_p1, k3.ns_cell_jacobian_p1):
        with pytest.raises(NotImplementedError):
            kern(*other)
    p2 = fargs[:3] + (fargs[3].repeat(1, 2), fargs[4]) + fargs[5:]
    for kern in (k7.ns_facet_natural_p1, k7.ns_facet_natural_jac_p1):
        with pytest.raises(NotImplementedError):
            kern(*p2)


def test_form_calls_issue_only_the_fused_kernels(sc):
    """form.residual issues 5 device kernels: K3 once with the facet
    block in its launch (K7's body), K2 three times and the add;
    form.element_jacobians exactly one, K3's Jacobian with the facet
    block's (torch.profiler)."""
    from cfdtpu_torch.utils.cudatime import device_kernels

    s = sc.solver
    u, up, p = _state(s, seed=6)
    prm = s.params()
    res = device_kernels(lambda: s.form.residual(u, p, (up,), prm))
    jac = device_kernels(lambda: s.form.element_jacobians(u, p, (up,), prm))

    def count(names, key):
        return sum(key + "_kernel" in n for n in names)

    assert len(res) == 5, res
    assert count(res, "ns_cell_residual_p1_facet") == 1, res
    assert count(res, "ns_facet_natural_p1") == 0, res
    assert count(res, "ell_sum") == 3, res
    assert len(jac) == 1, jac
    assert count(jac, "ns_cell_jacobian_p1_facet") == 1, jac


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("kind", ["residual", "jacobian"])
def test_k3_with_facet_block_matches_k3_and_k7(sc, kind, dt):
    """K3's launch with the facet block against K3 and K7 launched
    apart on the same inputs: bitwise equal, within the tolerance of the
    plain versions, two calls bitwise equal, one launch counted."""
    from cfdtpu_torch import kernels
    from cfdtpu_torch.kernels import ns_cell_residual as k3
    from cfdtpu_torch.kernels import ns_facet as k7

    dtype, tol = _dev_tol(dt)
    cargs, fargs = _element_args(sc.solver, dtype, seed=9)
    cell, facet, plain_c, plain_f = {
        "residual": (k3.ns_cell_residual_p1, k7.ns_facet_natural_p1,
                     k3.ns_cell_residual_plain, k7.ns_facet_natural_plain),
        "jacobian": (k3.ns_cell_jacobian_p1, k7.ns_facet_natural_jac_p1,
                     k3.ns_cell_jacobian_plain,
                     k7.ns_facet_natural_jac_plain),
    }[kind]
    from cfdtpu_torch.kernels.ns_facet import FacetBlock, FacetTerm

    blocks = [FacetBlock(FacetTerm("natural"), *fargs[3:7],
                         {"mu": fargs[7]})]
    kernels.reset_counts()
    got = cell(*cargs, facets=blocks)
    again = cell(*cargs, facets=blocks)
    name = f"ns_cell_{kind}_p1_facet"
    assert kernels.counts()[name] == 2
    assert kernels.counts()["ns_facet_natural_p1"] == 0
    assert kernels.counts()["ns_facet_natural_jac_p1"] == 0
    apart = cell(*cargs)
    apart = (apart if isinstance(apart, tuple) else (apart,)) + (
        facet(*fargs),)
    ref = plain_c(*cargs)
    ref = (ref if isinstance(ref, tuple) else (ref,)) + (plain_f(*fargs),)
    torch.cuda.synchronize()
    assert len(got) == len(apart) == len(ref)
    for g, a, b, r in zip(got, again, apart, ref):
        assert torch.equal(g, a) and torch.equal(g, b)
        _close_tol(g, r, tol)


def _k1_prolong_sites(dtype, rng):
    """(label, A, cols, prolong, n) for every level of both hierarchies
    of a small DFG mesh (coarse size 40, so it has levels), plus a level
    whose x ends 3 nodes short of its last supernode."""
    from cfdtpu_torch.la.amg import AMG, BlockAMG
    from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark

    nb = DFG1Benchmark("stabilized_schur", dt=0.05, T=1.0, res_scale=2.5,
                       dtype="float64", device="cuda").solver._nodebsr
    sp_row, sp_col, _ = nb.sp_structure()
    hs = {1: AMG(sp_row, sp_col, nb.n_nodes, coarse_size=40,
                 agg_row=nb.block_row_np, agg_col=nb.block_col_np,
                 device="cuda"),
          nb.dim: BlockAMG(nb.block_row_np, nb.block_col_np, nb.n_nodes,
                           d=nb.dim, coarse_size=40, device="cuda")}

    def dev(shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                               device="cuda")

    out = []
    for w, h in hs.items():
        for k, lvl in enumerate(h.levels):
            maps = h.sup[k][0]
            g = maps.g * w
            out.append((f"w={w} L{k}", dev((maps.ns, maps.Kg, g, g)),
                        maps.sup_cols, (dev(lvl.n_coarse * w), lvl.agg, w),
                        lvl.n * w))
        ns, kg, n = 37, 9, 37 * 8 - 3
        cols = rng.integers(0, ns, (ns, kg))
        cols[:, -2:] = ns
        agg = torch.as_tensor(rng.integers(0, 5, n), dtype=torch.int32,
                              device="cuda")
        out.append((f"w={w} short", dev((ns, kg, 8 * w, 8 * w)),
                    torch.as_tensor(cols, dtype=torch.int32, device="cuda"),
                    (dev(5 * w), agg, w), n * w))
    return out


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_k1_prolong_matches_k8_then_k1(dt):
    """K1 with the coarse-grid correction in its gather against K8 then
    K1 on K8's output, at every level of both hierarchies (w = 1 and 2),
    with the base x and s * x, in modes jacobi and residual, and x-hat
    stored: bitwise equal, within the tolerance of the plain version,
    two calls bitwise equal; one K1 launch counted a call and no K8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cfdtpu_torch import kernels
    from cfdtpu_torch.kernels.amg_prolong import amg_prolong
    from cfdtpu_torch.kernels.sup_spmv import sup_spmv, sup_spmv_plain

    dtype, tol = _dev_tol(dt)
    rng = np.random.default_rng(21)
    for label, A, cols, pro, n in _k1_prolong_sites(dtype, rng):
        def dev(a):
            return torch.as_tensor(a, dtype=dtype, device="cuda")

        x, b = dev(rng.standard_normal(n)), dev(rng.standard_normal(n))
        d, s = dev(1.0 + rng.random(n)), dev(0.5 + rng.random(n))
        for scale in (None, s):
            for mode in ("jacobi", "residual"):
                kw = dict(mode=mode, b=b, d=d, omega=0.67)
                xhat = (torch.empty_like(x) if mode == "residual" and
                        scale is None else None)
                kernels.reset_counts()
                got = sup_spmv(A, cols, x, n, scale=scale, prolong=pro,
                               xhat_out=xhat, **kw)
                again = sup_spmv(A, cols, x, n, scale=scale, prolong=pro,
                                 **kw)
                c = kernels.counts()
                assert c["sup_spmv_prolong"] == c["sup_spmv"] == 2, label
                assert c["amg_prolong"] == 0
                pair_x = amg_prolong(*pro, x, scale)
                pair = sup_spmv(A, cols, pair_x, n, **kw)
                ref = sup_spmv_plain(A, cols, x, n, scale=scale,
                                     prolong=pro, **kw)
                torch.cuda.synchronize()
                assert torch.equal(got, again), label
                assert torch.equal(got, pair), (label, mode, scale is None)
                _close_tol(got, ref, tol)
                if xhat is not None:
                    assert torch.equal(xhat, pair_x), label


@pytest.mark.parametrize("method", ["amg_p", "rasamg_sup"])
def test_captured_vcycle_has_no_k8(sc, method):
    """One captured preconditioner application holds no amg_prolong
    kernel: each V-cycle level's correction is read by a fused K1
    (sup_spmv_prolong) launch (torch.profiler over a replay). At this
    mesh the SELFP AMG has one level only (amg_p: no correction at all);
    rasamg_sup's BlockAMG has more."""
    from cfdtpu_torch.la.schur import (_uu_amg, build_schur_state,
                                       make_schur_precond_from_state)
    from cfdtpu_torch.utils.cudatime import device_kernels

    s = sc.solver
    nb = s._nodebsr
    u, up, p = _state(s, seed=5)
    vals = nb.assemble(*s.form.element_jacobians(u, p, (up,), s.params()))
    n_uf = nb.n_u_flat
    mask = torch.zeros(n_uf, dtype=torch.bool, device="cuda")
    kw = dict(m_u=0 if method == "rasamg_sup" else 6,
              m_p=5 if method == "rasamg_sup" else 10,
              inner_method=method, ras_opts=(32, 4))
    state = build_schur_state(nb, vals, mask, False, **kw)
    pc = make_schur_precond_from_state(nb, state, mask, False, **kw)
    v = s.tensor(np.random.default_rng(5).standard_normal(n_uf + nb.n_nodes))
    names = device_kernels(lambda: pc(v))
    levels = len(nb.sp_amg().levels)
    if method == "rasamg_sup":
        levels += len(_uu_amg(nb, method, kw["ras_opts"]).levels)
    assert not any("amg_prolong" in n for n in names), names
    fused = sum("sup_spmv_prolong" in n for n in names)
    assert (fused > 0) == (levels > 0), (levels, names)
    assert method == "amg_p" or fused > 0


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("kind", ["amg", "block"])
def test_k8_matches_plain_and_repeats(sc, kind, dt):
    """K8 at every level of the SELFP AMG (width 1) and of BlockAMG
    (width d), with the base x and with the scaled base s * x; coarse
    size 40, so this small mesh has levels."""
    from cfdtpu_torch import kernels
    from cfdtpu_torch.kernels.amg_prolong import (amg_prolong,
                                                  amg_prolong_plain)
    from cfdtpu_torch.la.amg import AMG, BlockAMG

    dtype, tol = _dev_tol(dt)
    nb = sc.solver._nodebsr
    if kind == "amg":
        sp_row, sp_col, _ = nb.sp_structure()
        amg, w = AMG(sp_row, sp_col, nb.n_nodes, coarse_size=40,
                     agg_row=nb.block_row_np, agg_col=nb.block_col_np,
                     device="cuda"), 1
    else:
        amg, w = BlockAMG(nb.block_row_np, nb.block_col_np, nb.n_nodes,
                          d=nb.dim, coarse_size=40, device="cuda"), nb.dim
    rng = np.random.default_rng(8)
    kernels.reset_counts()
    calls = 0
    for lvl in amg.levels:
        def dev(n):
            return torch.as_tensor(rng.standard_normal(n), dtype=dtype,
                                   device="cuda")

        xc, x, s = dev(lvl.n_coarse * w), dev(lvl.n * w), dev(lvl.n * w)
        for scale in (None, s):
            got = amg_prolong(xc, lvl.agg, w, x, scale)
            again = amg_prolong(xc, lvl.agg, w, x, scale)
            calls += 2
            _close_tol(got, amg_prolong_plain(xc, lvl.agg, w, x, scale), tol)
            assert torch.equal(got, again)
    torch.cuda.synchronize()
    assert calls > 0 and kernels.counts()["amg_prolong"] == calls


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("reorth", [False, True])
@pytest.mark.parametrize("j", [-1, 0, 4, 19, 40])
def test_k9_cgs_matches_plain_and_repeats(j, reorth, dt):
    """krylov_cgs on an orthonormal basis of 61 rows (restart 60) at the
    S stage's length, j past one 32-row set included: V[j+1] and the H
    column within the tolerance of the plain version, bitwise equal over
    two calls, and nothing else of V or h written."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cfdtpu_torch.kernels.krylov import krylov_cgs, krylov_cgs_plain

    dtype, tol = _dev_tol(dt)
    rng = np.random.default_rng(j + 2)
    n, rows = 35425, 61
    q, _ = np.linalg.qr(rng.standard_normal((n, rows)))
    V0 = torch.as_tensor(q.T.copy(), dtype=dtype, device="cuda")
    w = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device="cuda")
    H0 = torch.full((rows, rows - 1), -3.0, dtype=dtype, device="cuda")
    col = max(j, 0)
    out = []
    for fn in (krylov_cgs, krylov_cgs, krylov_cgs_plain):
        V, H = V0.clone(), H0.clone()
        fn(V, w, j, H[:, col], reorth)
        out.append((V, H))
    (V1, H1), (V2, H2), (Vp, Hp) = out
    assert torch.equal(V1, V2) and torch.equal(H1, H2)
    _close_tol(V1[j + 1], Vp[j + 1], tol)
    _close_tol(H1[: j + 2, col], Hp[: j + 2, col], tol)
    rest = torch.ones(rows, dtype=torch.bool, device="cuda")
    rest[j + 1] = False
    assert torch.equal(V1[rest], V0[rest])
    assert bool((H1[j + 2:, col] == -3.0).all())


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("m", [1, 5, 20, 64])
def test_k9_lsq_matches_plain_and_repeats(m, dt):
    """krylov_lsq on a well conditioned Hessenberg H, and a zero beta
    (exactly zero out)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cfdtpu_torch.kernels.krylov import krylov_lsq, krylov_lsq_plain

    dtype, tol = _dev_tol(dt)
    rng = np.random.default_rng(m)
    H = np.triu(rng.standard_normal((m + 1, m)), -1) + 4.0 * np.eye(m + 1, m)

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device="cuda")

    H, Z = dev(H), dev(rng.standard_normal((m, 35425)))
    beta = dev([1.3])
    got = krylov_lsq(H, beta, Z)
    assert torch.equal(got, krylov_lsq(H, beta, Z))
    _close_tol(got, krylov_lsq_plain(H, beta, Z), tol)
    zero = krylov_lsq(H, dev([0.0]), Z)
    assert torch.equal(zero, torch.zeros_like(zero))


def _givens(m, seed):
    """A Givens state on the card with unit rotations, a random g and
    tol 0.25 (R and stat filled with -5)."""
    from cfdtpu_torch.kernels.krylov import Givens

    rng = np.random.default_rng(seed)
    G = Givens(m, 0.25, "cuda")
    th = rng.uniform(0.0, 2.0 * np.pi, m)
    G.cs.copy_(torch.as_tensor(np.cos(th)))
    G.sn.copy_(torch.as_tensor(np.sin(th)))
    G.g.copy_(torch.as_tensor(rng.standard_normal(m + 1)))
    G.R.fill_(-5.0)
    G.stat.fill_(-5.0)
    return G


def _givens_copy(G, into=None):
    from cfdtpu_torch.kernels.krylov import Givens

    out = into if into is not None else Givens(G.m, 0.0, "cuda")
    for k in ("R", "cs", "sn", "g", "stat", "tol"):
        getattr(out, k).copy_(getattr(G, k))
    return out


def _k9_step_inputs(n, rows, dtype, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, rows)))
    return (torch.as_tensor(q.T.copy(), dtype=dtype, device="cuda"),
            torch.as_tensor(rng.standard_normal(n), dtype=dtype,
                            device="cuda"))


def _k9_outputs(V, h, G, j):
    out = [V[j + 1].clone(), h[: j + 2].clone()]
    if G is not None:
        out += [G.R[j].clone(), G.cs[j:j + 1].clone(),
                G.sn[j:j + 1].clone(), G.g[j:j + 2].clone(),
                G.stat[j + 1].clone()]
    return out


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("rows", [6, 21, 61])
def test_k9_cgs_resident_and_streamed(rows, dt, tail):
    """The one-launch CGS2 step at the FGMRES site's length (106,275) at
    j = rows - 2, with and without the Givens tail: rows 6 and 21 keep
    their slices in shared memory, 61 too in float32 and streams them in
    float64 (cgs_plan, on a 132-multiprocessor card). V[j+1], the H
    column and the Givens state within the tolerance of the plain
    version, and bitwise equal over two calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cfdtpu_torch.kernels.krylov import (cgs_plan, krylov_cgs,
                                             krylov_cgs_plain)

    dtype, tol = _dev_tol(dt)
    n, j = 106275, rows - 2
    V0, w = _k9_step_inputs(n, rows, dtype, rows)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if sms == 132:
        assert (cgs_plan(n, j, V0.element_size(), sms)[2] > 0) == (
            rows < 61 or dt == "f32")
    G0 = _givens(rows - 1, rows) if tail else None
    out = []
    for fn in (krylov_cgs, krylov_cgs, krylov_cgs_plain):
        V = V0.clone()
        h = torch.full((rows,), -3.0, dtype=dtype, device="cuda")
        G = _givens_copy(G0) if tail else None
        fn(V, w, j, h, True, G)
        out.append(_k9_outputs(V, h, G, j))
        assert torch.equal(V[: j + 1], V0[: j + 1])
        assert bool((h[j + 2:] == -3.0).all())
    torch.cuda.synchronize()
    for a, b, p in zip(*out):
        assert torch.equal(a, b)
        _close_tol(a, p, tol)


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("j,reorth,tail", [(19, True, True),
                                           (4, False, False)])
def test_k9_cgs_graph_capture_replays_bitwise(j, reorth, tail, dt):
    """One krylov_cgs call captured into a CUDA graph (the cooperative
    launch under stream capture, as inside the preconditioner's graph):
    every replay, from the same state, bitwise equal to the eager call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cfdtpu_torch.kernels.krylov import krylov_cgs

    dtype, _ = _dev_tol(dt)
    n, rows = (106275, 21) if tail else (35425, 6)
    V0, w = _k9_step_inputs(n, rows, dtype, j)
    G0 = _givens(rows - 1, j) if tail else None
    h = torch.zeros(rows, dtype=dtype, device="cuda")

    def reset(V, G):
        V.copy_(V0)
        h.zero_()
        if tail:
            _givens_copy(G0, G)

    V, G = V0.clone(), _givens_copy(G0) if tail else None
    krylov_cgs(V, w, j, h, reorth, G)
    ref = _k9_outputs(V, h, G, j)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        reset(V, G)
        krylov_cgs(V, w, j, h, reorth, G)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        krylov_cgs(V, w, j, h, reorth, G)
    for _ in range(2):
        reset(V, G)
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b)
                   for a, b in zip(_k9_outputs(V, h, G, j), ref))


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("j", [1, 5, 20])
def test_k9_lsq_tri_matches_plain_and_repeats(j, dt):
    """The triangular mode (fgmres's end of a cycle) at the FGMRES
    site's length: x + Z[:j]^T y, R[:j,:j] y = g[:j], within the
    tolerance of the plain version and bitwise over two calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cfdtpu_torch import kernels
    from cfdtpu_torch.kernels.krylov import (krylov_lsq_tri,
                                             krylov_lsq_tri_plain)

    dtype, tol = _dev_tol(dt)
    rng = np.random.default_rng(j)
    m, n = 20, 106275
    R = np.zeros((m, m + 1))
    R[:, :m] = (np.triu(rng.standard_normal((m, m))) + 4.0 * np.eye(m)).T
    f64 = dict(dtype=torch.float64, device="cuda")
    R, g = torch.as_tensor(R, **f64), torch.as_tensor(
        rng.standard_normal(m + 1), **f64)
    Z, x = (torch.as_tensor(rng.standard_normal(sh), dtype=dtype,
                            device="cuda") for sh in ((m, n), (n,)))
    kernels.reset_counts()
    got = krylov_lsq_tri(R, g, Z, x, j)
    assert torch.equal(got, krylov_lsq_tri(R, g, Z, x, j))
    _close_tol(got, krylov_lsq_tri_plain(R, g, Z, x, j), tol)
    torch.cuda.synchronize()
    assert kernels.counts()["krylov_lsq"] == 2


@pytest.mark.parametrize("restart", [5, 30])
def test_fgmres_on_card_matches_cpu(restart):
    """fgmres with its cycle on the card (Givens tail, lookahead,
    triangular solve) on a dense float64 system: the iterations, the
    discarded lookahead iterations and x (1e-10) as the CPU's plain run;
    K9's launches one a step and one triangular solve a cycle."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cfdtpu_torch import kernels
    from cfdtpu_torch.la.gmres import fgmres

    rng = np.random.default_rng(restart)
    N = 400
    A = rng.standard_normal((N, N)) / np.sqrt(N) + 3.0 * np.eye(N)
    dinv = 1.0 / (np.diag(A) + 0.1 * rng.standard_normal(N))
    b = rng.standard_normal(N)
    out = {}
    for dev in ("cuda", "cpu"):
        tA, td, tb = (torch.as_tensor(a, device=dev) for a in (A, dinv, b))
        kernels.reset_counts()
        x, info = fgmres(lambda v: tA @ v, tb, precond=lambda v: v * td,
                         restart=restart, maxiter=200, rtol=1e-10)
        out[dev] = (x.cpu(), info, kernels.counts())
    (xg, ig, cg), (xc, ic, _) = out["cuda"], out["cpu"]
    assert ig["iters"] == ic["iters"] and ig["converged"]
    assert ig["discarded"] == ic["discarded"] <= 1
    _close_tol(xg, xc, 1e-10)
    cycles = -(-ig["iters"] // restart)
    assert cg["krylov_cgs"] == ig["iters"] + ig["discarded"] + cycles
    assert cg["krylov_lsq"] == cycles


def _pc_case(s, method):
    """The node-BSR operator of the sc fixture, its masks, the slices'
    arguments of `method`, and state(seed): a preconditioner state at a
    seeded random velocity."""
    from cfdtpu_torch.la.schur import build_schur_state

    nb = s._nodebsr
    n_uf = nb.n_u_flat
    mask = torch.zeros(n_uf + nb.n_nodes, dtype=torch.bool, device="cuda")
    for d0 in range(2):
        mask[torch.as_tensor(s.bc_dofs_u.astype(np.int64) * 2 + d0)] = True
    mask[n_uf + torch.as_tensor(s.bc_dofs_p.astype(np.int64))] = True
    kw = dict(m_u=0 if method == "rasamg_sup" else 6,
              m_p=5 if method == "rasamg_sup" else 10,
              bc_mask_p=mask[n_uf:], inner_method=method, ras_opts=(32, 4))

    def state(seed):
        u, up, p = _state(s, seed=seed)
        vals = nb.assemble(*s.form.element_jacobians(u, p, (up,),
                                                     s.params()))
        return build_schur_state(nb, vals, mask[:n_uf], False, **kw)

    return nb, mask[:n_uf], kw, state


@pytest.mark.parametrize("method", ["amg_p", "rasamg_sup"])
def test_graph_replay_matches_eager(sc, method):
    """One preconditioner application as a CUDA graph: captured at the
    first call, held in a PrecondSlot (the same state loaded again hands
    back the same graph), and every replay bitwise equal to the eager
    application of the same closure on the same input."""
    from cfdtpu_torch.la.schur import (CapturedPrecond, PrecondSlot,
                                       make_schur_precond_from_state)

    s = sc.solver
    nb, mask_u, kw, build = _pc_case(s, method)
    state = build(6)
    pc = make_schur_precond_from_state(nb, state, mask_u, False, **kw)
    assert isinstance(pc, CapturedPrecond)
    slot = PrecondSlot()
    held = slot.load(nb, state, mask_u, False, **kw)[0]
    assert slot.load(nb, state, mask_u, False, **kw)[0] is held
    rng = np.random.default_rng(7)
    for _ in range(2):
        v = s.tensor(rng.standard_normal(mask_u.numel() + nb.n_nodes))
        got = pc(v).clone()
        assert torch.equal(got, pc.eager(v))
        assert torch.isfinite(got).all()


@pytest.mark.parametrize("method", ["amg_p", "rasamg_sup"])
def test_graph_refit_matches_a_fresh_closure(sc, method):
    """One graph, refitted in place: after 3 refits its replay is bitwise
    equal to the eager application of a closure freshly made of the
    newest state, with one capture and three pc_refits. Past the first
    refit, whose build is the first to free a state to the caching
    allocator, the refits make it retry no allocation and add no
    segment."""
    from cfdtpu_torch.la.schur import (CapturedPrecond, PrecondSlot,
                                       make_schur_precond_from_state)
    from cfdtpu_torch.utils.trace import counter

    s = sc.solver
    nb, mask_u, kw, build = _pc_case(s, method)
    v = s.tensor(np.random.default_rng(8).standard_normal(
        mask_u.numel() + nb.n_nodes))
    captures, refits = counter("pc_captures").n, counter("pc_refits").n
    slot = PrecondSlot()
    pc = slot.load(nb, build(20), mask_u, False, **kw)[0]
    assert isinstance(pc, CapturedPrecond)
    first = pc(v).clone()
    mem, newest = [], None
    for seed in (21, 22, 23):
        # the previous state goes before the next build, as the solver's
        # transient state does
        del newest
        newest = build(seed)
        assert slot.load(nb, newest, mask_u, False, **kw)[0] is pc
        pc(v)
        torch.cuda.synchronize()
        st = torch.cuda.memory_stats()
        mem.append((st["num_alloc_retries"], st["segment.all.current"]))
    assert counter("pc_captures").n == captures + 1
    assert counter("pc_refits").n == refits + 3
    assert mem[0] == mem[-1], mem
    fresh = make_schur_precond_from_state(nb, newest, mask_u, False, **kw)
    got = pc(v).clone()
    assert torch.equal(got, fresh.eager(v))
    assert torch.isfinite(got).all() and not torch.equal(got, first)


# -- the AMG cycle family and the non-AMG inner methods --------------------
def _cycle_hierarchies(dtype):
    """The SELFP AMG and the BlockAMG (with the RAS fine smoother) of a
    small DFG mesh at coarse size 40 (three levels), with their input
    values in `dtype`, on the card."""
    from cfdtpu_torch.la.amg import AMG, BlockAMG
    from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark

    s = DFG1Benchmark("stabilized_schur", dt=0.05, T=1.0, res_scale=1.0,
                      dtype="float64", device="cuda").solver
    nb = s._nodebsr
    u, up, p = _state(s, seed=9)
    vals = nb.assemble(*s.form.element_jacobians(u, p, (up,), s.params()))
    mask = torch.zeros(nb.n_u_flat, dtype=torch.bool, device="cuda")
    for d0 in range(2):
        mask[torch.as_tensor(s.bc_dofs_u.astype(np.int64) * 2 + d0)] = True
    sp_row, sp_col, _ = nb.sp_structure()
    amg = AMG(sp_row, sp_col, nb.n_nodes, coarse_size=40,
              agg_row=nb.block_row_np, agg_col=nb.block_col_np,
              device="cuda")
    bamg = BlockAMG(nb.block_row_np, nb.block_col_np, nb.n_nodes, d=2,
                    coarse_size=40, fine_smoother=nb.uu_ras(32, 4),
                    device="cuda")
    return [(amg, nb.sp_vals(vals).to(dtype)),
            (bamg, nb.uu_vals(vals, mask).to(dtype))]


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_k1_cheby_matches_plain_and_repeats(dt):
    """K1's cheby mode at every Chebyshev level of both hierarchies: from
    s * b (the first step), with dprev and d stored, with the correction
    in its gather (the first post-smoothing step) and with the W-cycle's
    add; within the tolerance of the plain version, two calls bitwise
    equal, one launch counted under sup_spmv_cheby."""
    from cfdtpu_torch import kernels
    from cfdtpu_torch.kernels.sup_spmv import sup_spmv, sup_spmv_plain

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dtype, tol = _dev_tol(dt)
    rng = np.random.default_rng(31)
    for h, vals in _cycle_hierarchies(dtype):
        h.set_cycle(cheby=2)
        built = h.build(vals)
        for k, (ev, d, s, cheb) in enumerate(built[0]):
            if cheb is None:
                continue
            n, w = d.shape[0], cheb[1]
            cols = h.sup[k][0].sup_cols

            def dev(a):
                return torch.as_tensor(a, dtype=dtype, device="cuda")

            x, b = dev(rng.standard_normal(n)), dev(rng.standard_normal(n))
            dp, add = dev(rng.standard_normal(n)), dev(rng.standard_normal(n))
            xc = dev(rng.standard_normal(h.levels[k].n_coarse * h.width))
            cases = [dict(x=b, scale=w, dprev=None),
                     dict(x=x, scale=None, dprev=dp, d_out=True),
                     dict(x=x, scale=None, dprev=None, add=add,
                          prolong=(xc, h.levels[k].agg, h.width))]
            for c in cases:
                kw = dict(mode="cheby", b=b, scale=c["scale"],
                          cheb=(w, c["dprev"], 0.7, 1.3),
                          add=c.get("add"), prolong=c.get("prolong"))
                dk = torch.empty_like(b) if c.get("d_out") else None
                dp_ = torch.empty_like(b) if c.get("d_out") else None
                kernels.reset_counts()
                got = sup_spmv(ev, cols, c["x"], n, d_out=dk, **kw)
                again = sup_spmv(ev, cols, c["x"], n, **kw)
                assert kernels.counts()["sup_spmv_cheby"] == 2
                ref = sup_spmv_plain(ev, cols, c["x"], n, d_out=dp_, **kw)
                torch.cuda.synchronize()
                assert torch.equal(got, again)
                _close_tol(got, ref, tol)
                if dk is not None:
                    _close_tol(dk, dp_, tol)
        h.set_cycle(cheby=0)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_k1_cheby_auu_mask_and_cheby_update(sc, dt):
    """The chebyshev inner method's Auu step (K1's cheby mode with the
    Dirichlet rows as identity rows) and cheby_update after another
    operator, against their plain versions; two calls bitwise equal."""
    from cfdtpu_torch.kernels.sup_spmv import (cheby_update,
                                               cheby_update_plain, sup_spmv,
                                               sup_spmv_plain)

    dtype, tol = _dev_tol(dt)
    s = sc.solver
    nb = s._nodebsr
    u, up, p = _state(s, seed=10)
    vals = nb.assemble(*s.form.element_jacobians(u, p, (up,), s.params()))
    A = vals["sup"].to(dtype)
    gd, n = nb.g * nb.dim, nb.n_u_flat
    rng = np.random.default_rng(11)

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device="cuda")

    mask = torch.as_tensor(rng.random(n) < 0.1, device="cuda")
    x, b, w, dp = (dev(rng.standard_normal(n)) for _ in range(4))
    kw = dict(mode="cheby", b=b, mask=mask, cheb=(w, dp, 0.4, 1.7))
    Auu = A[:, :, :gd, :gd]
    got = sup_spmv(Auu, nb._sup.sup_cols, x, n, **kw)
    again = sup_spmv(Auu, nb._sup.sup_cols, x, n, **kw)
    ref = sup_spmv_plain(Auu, nb._sup.sup_cols, x, n, **kw)
    y = dev(rng.standard_normal(n))
    d_k, d_p = torch.empty_like(x), torch.empty_like(x)
    got_u = cheby_update(x, y, b, w, dp, 0.4, 1.7, d_k)
    ref_u = cheby_update_plain(x, y, b, w, dp, 0.4, 1.7, d_p)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close_tol(got, ref, tol)
    _close_tol(got_u, ref_u, tol)
    _close_tol(d_k, d_p, tol)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_k9_scaled_normalisation_and_lambda(dt):
    """K9's normalisation with an elementwise scale against its plain
    version, and estimate_lambda_max on the card against the CPU."""
    from cfdtpu_torch.kernels.krylov import krylov_cgs, krylov_cgs_plain
    from cfdtpu_torch.la.chebyshev import estimate_lambda_max

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dtype, tol = _dev_tol(dt)
    rng = np.random.default_rng(12)
    for n in (35425, 106275):
        w, sc_ = (torch.as_tensor(rng.standard_normal(n), dtype=dtype,
                                  device="cuda") for _ in range(2))
        Vk, Vp = (torch.empty((1, n), dtype=dtype, device="cuda")
                  for _ in range(2))
        hk, hp = (torch.empty(1, dtype=dtype, device="cuda")
                  for _ in range(2))
        krylov_cgs(Vk, w, -1, hk, False, scale=sc_)
        got = (Vk.clone(), hk.clone())
        krylov_cgs(Vk, w, -1, hk, False, scale=sc_)
        krylov_cgs_plain(Vp, w, -1, hp, False, scale=sc_)
        torch.cuda.synchronize()
        assert torch.equal(got[0], Vk) and torch.equal(got[1], hk)
        _close_tol(Vk, Vp, tol)
        _close_tol(hk, hp, tol)
    Ad = rng.standard_normal((200, 200))
    Ad = Ad @ Ad.T + 200 * np.eye(200)
    inv = 1.0 / np.diag(Ad)
    lam = {}
    for dev in ("cuda", "cpu"):
        A = torch.as_tensor(Ad, dtype=dtype, device=dev)
        lam[dev] = estimate_lambda_max(lambda v: A @ v, torch.as_tensor(
            inv, dtype=dtype, device=dev)).cpu()
    _close_tol(lam["cuda"], lam["cpu"], 10 * tol)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_k10_matches_plain_and_repeats(sc, dt):
    """K10's inverses (the masked diagonal velocity blocks) and applies
    at d = 2, 1 and 1 with divide against their plain versions."""
    from cfdtpu_torch.kernels.block_jacobi import (block_jacobi,
                                                   block_jacobi_inv,
                                                   block_jacobi_inv_plain,
                                                   block_jacobi_plain)

    dtype, tol = _dev_tol(dt)
    s = sc.solver
    nb = s._nodebsr
    u, up, p = _state(s, seed=13)
    coo = nb.assemble(*s.form.element_jacobians(u, p, (up,), s.params()))[
        "coo"].to(dtype)
    rng = np.random.default_rng(14)
    mask = torch.as_tensor(rng.random(nb.n_u_flat) < 0.1, device="cuda")
    inv = block_jacobi_inv(coo, nb._diag_pos, mask, 2)
    _close_tol(inv, block_jacobi_inv_plain(coo, nb._diag_pos, mask, 2), tol)
    v = torch.as_tensor(rng.standard_normal(nb.n_u_flat), dtype=dtype,
                        device="cuda")
    dg = torch.as_tensor(0.5 + rng.random((nb.n_nodes, 1, 1)), dtype=dtype,
                         device="cuda")
    vp = v[:nb.n_nodes].contiguous()
    for args in ((inv, v), (dg, vp), (dg, vp, True)):
        got = block_jacobi(*args)
        again = block_jacobi(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        _close_tol(got, block_jacobi_plain(*args), tol)


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("n", [37, 5000, 15476])
def test_k11_matches_plain_and_repeats(n, dt):
    """K11's two launches against their plain versions; bitwise
    repeatable; the coefficients stay on the card."""
    from cfdtpu_torch.kernels.amg_gcr2 import (gcr2_first, gcr2_first_plain,
                                               gcr2_second,
                                               gcr2_second_plain)

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dtype, tol = _dev_tol(dt)
    rng = np.random.default_rng(n)
    q1, b, q2, z1, z2 = (torch.as_tensor(rng.standard_normal(n),
                                         dtype=dtype, device="cuda")
                         for _ in range(5))
    r, coef = gcr2_first(q1, b)
    r2, coef2 = gcr2_first(q1, b)
    rp, cp = gcr2_first_plain(q1, b)
    x = gcr2_second(q1, q2, z1, z2, r, coef)
    x2 = gcr2_second(q1, q2, z1, z2, r, coef)
    xp = gcr2_second_plain(q1, q2, z1, z2, rp, cp)
    torch.cuda.synchronize()
    assert torch.equal(r, r2) and torch.equal(coef, coef2)
    assert torch.equal(x, x2)
    _close_tol(r, rp, tol)
    _close_tol(coef, cp, tol)
    _close_tol(x, xp, 10 * tol)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_cycles_on_card(dt):
    """W + K + Chebyshev cycles of both hierarchies on the card against
    the CPU plain versions, two calls bitwise equal, and the W-cycle's
    sum in K1's epilogue bitwise equal to K1 then a separate add."""
    from cfdtpu_torch.la import amg as amg_module

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dtype, tol = _dev_tol(dt)
    rng = np.random.default_rng(15)
    for h, vals in _cycle_hierarchies(dtype):
        n = h.coo[0][2] * h.width
        r = torch.as_tensor(rng.standard_normal(n), dtype=dtype,
                            device="cuda")
        h.set_cycle(kcycle=True, wcycle=True, cheby=2)
        built = h.build(vals)
        got = h.v_cycle(built, r)
        assert torch.equal(got, h.v_cycle(built, r))
        h.set_cycle(kcycle=False)
        wsum = h.v_cycle(built, r)
        spmv = amg_module.sup_spmv

        def apart(*a, add=None, **kw):
            y = spmv(*a, **kw)
            return y if add is None else add + y

        amg_module.sup_spmv = apart
        try:
            assert torch.equal(h.v_cycle(built, r), wsum)
        finally:
            amg_module.sup_spmv = spmv
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        h.set_cycle(kcycle=False, wcycle=False, cheby=0)
    # the CPU side: the same hierarchies on the host's plain versions
    # are tests/test_torch_cycles.py's; here, one f64 comparison
    if dt == "f64":
        h, vals = _cycle_hierarchies(dtype)[1]
        h.set_cycle(kcycle=True, wcycle=True, cheby=2)
        r = torch.as_tensor(rng.standard_normal(h.coo[0][2] * 2),
                            dtype=dtype, device="cuda")
        got = h.v_cycle(h.build(vals), r).cpu()
        from cfdtpu_torch.la.amg import BlockAMG
        from cfdtpu_torch.la.ras import RASPrecond

        ras = h.fine_smoother
        hc = BlockAMG(h.coo[0][0], h.coo[0][1], h.coo[0][2], d=2,
                      coarse_size=40, cheby_degree=2, kcycle=True,
                      wcycle=True, device="cpu",
                      fine_smoother=RASPrecond(h.coo[0][0], h.coo[0][1],
                                               h.coo[0][2], d=2, s=ras.s,
                                               overlap=ras.o, device="cpu"))
        ref = hc.v_cycle(hc.build(vals.cpu()), r.cpu())
        _close_tol(got, ref, 1e-11)


@pytest.fixture(scope="module")
def sc_cpu():
    """The sc fixture's scenario on the host (plain versions)."""
    from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark

    return DFG1Benchmark("stabilized_schur", dt=0.05, T=1.0,
                         res_scale=2.5, dtype="float64", device="cpu",
                         pc_lag_steps=4, snes_lag_jacobian=True)


@pytest.mark.parametrize("method,kw", [
    ("gmres", dict(m_u=6, m_p=30)), ("chebyshev_p", dict(m_u=6, m_p=30)),
    ("chebyshev", dict(m_u=6, m_p=30)),
    ("rasamg_sup", dict(m_u=0, m_p=5, cycle=True))])
def test_new_methods_graph_replay(sc, sc_cpu, method, kw):
    """The new inner methods and rasamg_sup with W + K + Chebyshev: one
    application is one CUDA graph, its replay bitwise equal to the eager
    application, and within 1e-11 of the same application on the host
    (gmres: 1e-9; its 30 GMRES steps on S, one Gram-Schmidt pass each,
    grow the card's other sum order in K9 to 1.5e-10 on an H100)."""
    from cfdtpu_torch.la.schur import (CapturedPrecond, build_schur_state,
                                       make_schur_precond_from_state)

    kw = dict(kw)
    flags = dict(kcycle=True, wcycle=True, cheby=2) if kw.pop(
        "cycle", False) else None
    out = {}
    for scn in (sc, sc_cpu):
        s = scn.solver
        nb = s._nodebsr
        u, up, p = _state(s, seed=16)
        vals = nb.assemble(*s.form.element_jacobians(u, p, (up,),
                                                     s.params()))
        n_uf = nb.n_u_flat
        mask = np.zeros(n_uf + nb.n_nodes, dtype=bool)
        for d0 in range(2):
            mask[s.bc_dofs_u.astype(np.int64) * 2 + d0] = True
        mask[n_uf + s.bc_dofs_p.astype(np.int64)] = True
        mask = torch.as_tensor(mask, device=s.device)
        pkw = dict(kw, bc_mask_p=mask[n_uf:], inner_method=method,
                   ras_opts=(32, 4))
        if flags:
            nb.sp_amg(**flags)
            nb.uu_amg(fine_smoother=nb.uu_ras(32, 4), **flags)
        v = s.tensor(np.random.default_rng(17).standard_normal(
            n_uf + nb.n_nodes))
        state = build_schur_state(nb, vals, mask[:n_uf], False, **pkw)
        pc = make_schur_precond_from_state(nb, state, mask[:n_uf], False,
                                           **pkw)
        if s.device.type == "cuda":
            assert isinstance(pc, CapturedPrecond)
            got = pc(v).clone()
            assert torch.equal(got, pc.eager(v))
        else:
            got = pc(v)
        assert torch.isfinite(got).all()
        out[s.device.type] = got.cpu()
        if flags:
            off = dict(kcycle=False, wcycle=False, cheby=0)
            nb.sp_amg(**off)
            nb.uu_amg(fine_smoother=nb.uu_ras(32, 4), **off)
    _close_tol(out["cuda"], out["cpu"], 1e-9 if method == "gmres" else 1e-11)


# ---------------------------------------------------------------------
# K12, K13, K14 and K7's implicit mode
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def sc2():
    """DFG 2D-1 with the dfg_2d_1 solver (viscous_out and backflow_out
    on the outlet), res 0.02, float64, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cfdtpu_torch.scenarios.dfg_2d_1 import DFG2D1Steady

    return DFG2D1Steady("dfg_2d_1", dt=0.05, T=1.0, res=0.02,
                        dtype="float64", device="cuda")


@pytest.fixture(scope="module")
def sc_bdf2():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark

    return DFG1Benchmark("stabilized_schur_bdf2", dt=0.05, T=1.0,
                         res_scale=2.5, dtype="float64", device="cuda")


def _developed(s, dtype, seed):
    """The inlet profile less 0.1 plus noise (u_prev.n < 0 near the
    outlet's walls: backflow there), u_prev2 and p random."""
    rng = np.random.default_rng(seed)
    y = s.V.dof_coords[:, 1]
    prof = np.stack([1.2 * y * (0.41 - y) / 0.41 ** 2 - 0.1, 0 * y], axis=1)
    n_u, n_p = s.V.num_dofs, s.Q.num_dofs
    u, up, up2 = (s.tensor(prof + 0.02 * rng.standard_normal((n_u, 2)))
                  .to(dtype) for _ in range(3))
    return u, up, up2, s.tensor(0.1 * rng.standard_normal(n_p)).to(dtype)


def _cast_form(f, dtype):
    cast = (lambda t: t.to(dtype).contiguous())
    tabs = type(f.tabs)(**{k: (cast(v) if torch.is_tensor(v) else v)
                           for k, v in vars(f.tabs).items()})
    return cast, (f.dofmap_u, f.dofmap_p, cast(f.cell_coords),
                  cast(f.cell_h), tabs)


def _facet_block(f, name, dtype, prm):
    from cfdtpu_torch.kernels.ns_facet import FacetBlock

    cast, _ = _cast_form(f, dtype)
    b = next(b for b in f._facet_blocks if b["name"] == name)
    return FacetBlock(b["term"], b["dofmap_u32"], b["dofmap_p32"],
                      cast(b["coords"]),
                      {k: cast(v) for k, v in b["tabs"].items()},
                      b["term"].scalars(prm))


def _on_cpu(args):
    """Element-kernel arguments with every tensor (and the CellTabs'
    tensors) moved to the CPU, where the wrappers take the plain
    versions."""
    def cpu(a):
        if torch.is_tensor(a):
            return a.cpu()
        if hasattr(a, "qw"):  # CellTabs
            return type(a)(**{k: cpu(v) for k, v in vars(a).items()})
        return a
    return tuple(cpu(a) for a in args)


def _blocks_on_cpu(blocks):
    if blocks is None:
        return None
    return [type(b)(b.term, *(t.cpu() for t in b.args()[:3]),
                    {k: v.cpu() for k, v in b.tabs.items()}, b.scalars)
            for b in blocks]


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("kind", ["residual", "jacobian"])
@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("term", ["natural", "viscous", "backflow"])
def test_facet_terms_match_plain_and_repeat(sc2, term, implicit, kind, dt):
    """K7 (both modes), K12 and K13 alone on the outlet at a state with
    backflow: within the tolerance of the plain versions, two calls
    bitwise equal, one launch counted (and K7's implicit mode under its
    own name too)."""
    from cfdtpu_torch import kernels
    from cfdtpu_torch.kernels.ns_facet import (FacetTerm, facet_call,
                                               facet_jac_plain, facet_plain)

    dtype, tol = _dev_tol(dt)
    s = sc2.solver
    prm = s.params()
    u, up, _, p = _developed(s, dtype, seed=11)
    blk = _facet_block(s.form, "viscous_out", dtype, prm)
    ft = FacetTerm(term, implicit)
    sc_ = ft.scalars(prm)
    jac = kind == "jacobian"
    args = (u, up, p, *blk.args())
    kernels.reset_counts()
    got, again = facet_call(ft, sc_, jac, *args), facet_call(ft, sc_, jac,
                                                            *args)
    ref = (facet_jac_plain if jac else facet_plain)(ft, sc_, *args)
    torch.cuda.synchronize()
    _close_tol(got, ref, tol)
    assert torch.equal(got, again)
    assert float(ref.abs().max()) > 0
    assert kernels.counts()[ft.counter(jac)] == 2


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("kind", ["residual", "jacobian"])
def test_element_launch_with_two_outlet_blocks(sc2, kind, dt):
    """K3 with the dfg_2d_1 form's two blocks (K12 then K13 on the same
    facets) in its launch: bitwise equal to K3, K12 and K13 launched
    apart, within the tolerance of the plain versions, one element
    launch counted with each block's _fused count."""
    from cfdtpu_torch import kernels
    from cfdtpu_torch.kernels import ns_cell_residual as k3
    from cfdtpu_torch.kernels.ns_facet import facet_call

    dtype, tol = _dev_tol(dt)
    s = sc2.solver
    f, prm = s.form, s.params()
    u, up, _, p = _developed(s, dtype, seed=12)
    _, (dmu, dmp, coords, h, tabs) = _cast_form(f, dtype)
    cargs = (u, up, p, dmu, dmp, coords, h, tabs, prm["rho"], prm["mu"],
             prm["dt"], prm["f"], float(np.finfo(str(dtype)[6:]).resolution))
    blocks = [_facet_block(f, n, dtype, prm)
              for n in ("viscous_out", "backflow_out")]
    jac = kind == "jacobian"
    fn = k3.ns_cell_jacobian_p1 if jac else k3.ns_cell_residual_p1
    kernels.reset_counts()
    got = fn(*cargs, facets=blocks)
    c = kernels.counts()
    assert c[f"ns_cell_{kind}_p1_facet"] == 1
    assert c[blocks[0].term.counter(jac, fused=True)] == 1
    assert c[blocks[1].term.counter(jac, fused=True)] == 1
    assert c[blocks[0].term.counter(jac)] == 0
    apart = fn(*cargs)
    apart = (apart if isinstance(apart, tuple) else (apart,)) + tuple(
        facet_call(b.term, b.scalars, jac, u, up, p, *b.args())
        for b in blocks)
    ref = fn(*_on_cpu(cargs), facets=_blocks_on_cpu(blocks))
    assert len(got) == len(apart) == len(ref) == (3 if jac else 4)
    for g, a, r in zip(got, apart, ref):
        assert torch.equal(g, a)
        _close_tol(g.cpu(), r, tol)


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("facet", [False, True])
@pytest.mark.parametrize("kind", ["residual", "jacobian"])
def test_k14_matches_plain_and_repeats(sc_bdf2, kind, facet, dt):
    """K14 (the BDF2 cell body), alone and with the natural correction
    at u in its launch (K7's implicit mode), under BDF2's coefficients:
    within the tolerance of the plain versions, bitwise repeatable, one
    launch counted."""
    from cfdtpu_torch import kernels
    from cfdtpu_torch.kernels import ns_cell_residual as k3

    dtype, tol = _dev_tol(dt)
    s = sc_bdf2.solver
    s._bdf = (1.5, -2.0, 0.5)
    f, prm = s.form, s.params()
    u, up, p = _state(s, 13)
    u, up, up2, p = (t.to(dtype) for t in (u, up, _state(s, 14)[0], p))
    up[: len(up) // 3] = 0  # cells at rest: tau's eps guard
    _, (dmu, dmp, coords, h, tabs) = _cast_form(f, dtype)
    a = (prm["bdf_a0"], prm["bdf_a1"], prm["bdf_a2"])
    cargs = (u, up, up2, p, dmu, dmp, coords, h, tabs, prm["rho"],
             prm["mu"], prm["dt"], prm["f"],
             float(np.finfo(str(dtype)[6:]).resolution), a)
    blocks = ([_facet_block(f, "natural_correction", dtype, prm)]
              if facet else None)
    jac = kind == "jacobian"
    fn = k3.ns_cell_jacobian_bdf2_p1 if jac else k3.ns_cell_residual_bdf2_p1
    kernels.reset_counts()
    got, again = fn(*cargs, facets=blocks), fn(*cargs, facets=blocks)
    c = kernels.counts()
    assert c[f"ns_cell_{kind}_bdf2_p1"] == 2
    assert c[f"ns_cell_{kind}_bdf2_p1_facet"] == (2 if facet else 0)
    if facet:
        assert c[f"ns_facet_natural{'_jac' if jac else ''}_p1_fused"] == 2
    as_tuple = (lambda o: o if isinstance(o, tuple) else (o,))
    ref = fn(*_on_cpu(cargs), facets=_blocks_on_cpu(blocks))
    for g, r, x in zip(as_tuple(got), as_tuple(ref), as_tuple(again)):
        _close_tol(g.cpu(), r, tol)
        assert torch.equal(g, x)


@pytest.mark.parametrize("which", ["dfg_2d_1", "bdf2"])
def test_forms_with_new_blocks_issue_the_fused_kernels(sc2, sc_bdf2, which):
    """form.residual launches one element kernel with every facet block
    in its launch and K2 twice for the cells and once per block (the
    wrappers' counts), and its trace holds those and one add per block
    and nothing else (dfg_2d_1: at most 7 device kernels; BDF2 with its
    natural correction: 5), the element kernel once; form.element_jacobians
    one launch, which its trace holds. A trace may lose records, never
    gain one (torch.profiler): it is padded and taken again, up to ten
    times a second apart, until one holds them all."""
    from cfdtpu_torch import kernels
    from cfdtpu_torch.utils.cudatime import device_kernels

    s = (sc2 if which == "dfg_2d_1" else sc_bdf2).solver
    u, up, up2, p = _developed(s, s.dtype, seed=15)
    aux = (up,) if which == "dfg_2d_1" else (up, up2)
    prm = s.params()
    nblocks = len(s.form._facet_blocks)
    key = "p1" if which == "dfg_2d_1" else "bdf2_p1"
    for name, fn, want in (
            ("residual", lambda: s.form.residual(u, p, aux, prm),
             {f"ns_cell_residual_{key}": 1,
              f"ns_cell_residual_{key}_facet": 1, "ell_sum": 2 + nblocks}),
            ("jacobian", lambda: s.form.element_jacobians(u, p, aux, prm),
             {f"ns_cell_jacobian_{key}": 1,
              f"ns_cell_jacobian_{key}_facet": 1})):
        kernels.reset_counts()
        fn()
        got = {k: n for k, n in kernels.counts().items()
               if n and not k.endswith("_fused")}
        assert got == want, (name, got)

    def fullest(fn, full):
        best = []
        for _ in range(10):
            names = device_kernels(fn, pad=4)
            best = names if len(names) > len(best) else best
            if len(best) >= full:
                break
            time.sleep(1.0)
        return best

    res = fullest(lambda: s.form.residual(u, p, aux, prm), 3 + 2 * nblocks)
    jac = fullest(lambda: s.form.element_jacobians(u, p, aux, prm), 1)
    kinds = (f"ns_cell_residual_{key}_facet_kernel", "ell_sum_kernel",
             "CUDAFunctor_add")
    assert len(res) <= 3 + 2 * nblocks, res
    assert all(any(k in n for k in kinds) for n in res), res
    assert sum(kinds[0] in n for n in res) == 1, res
    assert len(jac) == 1, jac
    assert f"ns_cell_jacobian_{key}_facet_kernel" in jac[0], jac


@pytest.mark.parametrize("solver", ["dfg_2d_1", "stabilized_schur_bdf2"])
def test_new_solvers_on_card_match_cpu(solver):
    """Two float64 steps through the kernels equal the plain versions
    (CPU): counts, state and (dfg_2d_1) c_D and c_L within 1e-9."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark
    from cfdtpu_torch.scenarios.dfg_2d_1 import DFG2D1Steady

    out = []
    for dev in ("cuda", "cpu"):
        if solver == "dfg_2d_1":
            scen = DFG2D1Steady(solver, dt=0.05, T=1.0, res=0.04,
                                dtype="float64", device=dev)
        else:
            scen = DFG1Benchmark(solver, dt=0.05, T=1.0, res_scale=2.5,
                                 dtype="float64", device=dev)
        s = scen.solver
        rec = []
        for _ in range(2):
            s.solveStep()
            rec.append((s.last_stats["newton_iters"],
                        s.last_stats["ksp_iters"]))
            s.u_prev, s.p_prev = s.u_sol, s.p_sol
        out.append((rec, s.u_sol.cpu().numpy(), s.p_sol.cpu().numpy(),
                    np.array([getattr(s, "cd", 1.0), getattr(s, "cl", 1.0)])))
    (ca, ua, pa, fa), (cb, ub, pb, fb) = out
    assert ca == cb
    for a, b in ((ua, ub), (pa, pb)):
        assert np.linalg.norm(a - b) / np.linalg.norm(b) < 1e-9
    np.testing.assert_allclose(fa, fb, rtol=1e-9, atol=0)


# ---------------------------------------------------------------------
# K15 (the curl-curl cell body), K16 (weak pressure), K17 (Nitsche,
# sigma and curl forms), K18 (CBC and directional do-nothing)
# ---------------------------------------------------------------------
PIPE_KW = dict(dt=0.05, T=1.0, res_scale=2.0, p_inlet=0.15, p_outlet=0.02,
               dtype="float64", device="cuda")


@pytest.fixture(scope="module")
def sc_pbf():
    """pipe_cylinder_pressurebc under stabilized_schur_pressure_backflow
    (five blocks: weak pressure and Nitsche on the inlet; resistance
    pressure, viscous traction and backflow on the outlet), res_scale
    2.0, float64, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cfdtpu_torch.scenarios.pipe_cylinder_pressurebc import (
        PipeCylinderPressureBC)

    sc_ = PipeCylinderPressureBC("stabilized_schur_pressure_backflow",
                                 R_resistance=1.0, **PIPE_KW)
    sc_.solver.p_c = 0.04
    return sc_


@pytest.fixture(scope="module")
def sc_pbc():
    """pipe_cylinder_pressurebc under stabilized_schur_pressurebc (the
    curl-curl form, four blocks), res_scale 2.0, float64, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cfdtpu_torch.scenarios.pipe_cylinder_pressurebc import (
        PipeCylinderPressureBC)

    return PipeCylinderPressureBC("stabilized_schur_pressurebc", **PIPE_KW)


def _new_term(term):
    from cfdtpu_torch.kernels.ns_facet import FacetTerm

    if term == "weakp":
        return FacetTerm("weakp", pressure_key="p_inlet")
    if term.startswith("nitsche"):
        return FacetTerm(term, beta_key="beta_nitsche")
    return FacetTerm(term)


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("kind", ["residual", "jacobian"])
@pytest.mark.parametrize("side", ["nitsche_in", "backflow_out"])
@pytest.mark.parametrize("term", ["weakp", "nitsche", "nitsche_curl", "cbc",
                                  "ddn"])
def test_k16_k18_match_plain_and_repeat(sc_pbf, term, side, kind, dt):
    """K16, K17 (both forms) and K18 (both modes) alone on the inlet and
    the outlet at a state with reverse flow on part of each: within the
    tolerance of the plain versions, two calls bitwise equal, one launch
    counted; the weak pressure's Jacobian zero."""
    from cfdtpu_torch import kernels
    from cfdtpu_torch.kernels.ns_facet import (facet_call, facet_jac_plain,
                                               facet_plain)

    dtype, tol = _dev_tol(dt)
    s = sc_pbf.solver
    prm = s.params()
    u, up, _, p = _developed(s, dtype, seed=21)
    blk = _facet_block(s.form, side, dtype, prm)
    ft = _new_term(term)
    sc_ = ft.scalars(prm)
    jac = kind == "jacobian"
    args = (u, up, p, *blk.args())
    kernels.reset_counts()
    got, again = (facet_call(ft, sc_, jac, *args),
                  facet_call(ft, sc_, jac, *args))
    ref = (facet_jac_plain if jac else facet_plain)(ft, sc_, *args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert kernels.counts()[ft.counter(jac)] == 2
    if term == "weakp" and jac:
        assert not got.any() and not ref.any()
        return
    assert float(ref.abs().max()) > 0
    _close_tol(got, ref, tol)


@pytest.mark.parametrize("kind", ["residual", "jacobian"])
def test_ddn_is_k13_at_minus_half_on_card(sc_pbf, kind):
    """K18's DDN mode and K13 with beta rho = 1/2: bit for bit."""
    from cfdtpu_torch.kernels.ns_facet import FacetTerm, facet_call

    s = sc_pbf.solver
    prm = dict(s.params(), beta_half=0.5, rho=1.0)
    u, up, _, p = _developed(s, torch.float64, seed=22)
    blk = _facet_block(s.form, "backflow_out", torch.float64, prm)
    jac = kind == "jacobian"
    ddn, back = FacetTerm("ddn"), FacetTerm("backflow", beta_key="beta_half")
    a = facet_call(ddn, ddn.scalars(prm), jac, u, up, p, *blk.args())
    b = facet_call(back, back.scalars(prm), jac, u, up, p, *blk.args())
    assert torch.equal(a, b) and float(a.abs().max()) > 0


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("facet", [False, True])
@pytest.mark.parametrize("kind", ["residual", "jacobian"])
def test_k15_matches_plain_and_repeats(sc_pbc, kind, facet, dt):
    """K15 (the curl-curl cell body), alone and with the
    stabilized_schur_pressurebc form's four blocks (K16 twice, K17's
    curl form twice) in its launch: within the tolerance of the plain
    versions, bitwise repeatable, with the blocks bitwise equal to K15,
    K16 and K17 launched apart, one launch counted."""
    from cfdtpu_torch import kernels
    from cfdtpu_torch.kernels import ns_cell_residual as k3
    from cfdtpu_torch.kernels.ns_facet import facet_call

    dtype, tol = _dev_tol(dt)
    s = sc_pbc.solver
    f, prm = s.form, s.params()
    u, up, p = _state(s, 23)
    u, up, p = (t.to(dtype) for t in (u, up, p))
    up[: len(up) // 3] = 0  # cells at rest: tau's eps guard
    _, (dmu, dmp, coords, h, tabs) = _cast_form(f, dtype)
    cargs = (u, up, p, dmu, dmp, coords, h, tabs, prm["rho"], prm["mu"],
             prm["dt"], prm["f"], float(np.finfo(str(dtype)[6:]).resolution))
    blocks = ([_facet_block(f, b["name"], dtype, prm)
               for b in f._facet_blocks] if facet else None)
    jac = kind == "jacobian"
    fn = k3.ns_cell_jacobian_curl_p1 if jac else k3.ns_cell_residual_curl_p1
    kernels.reset_counts()
    got, again = fn(*cargs, facets=blocks), fn(*cargs, facets=blocks)
    c = kernels.counts()
    assert c[f"ns_cell_{kind}_curl_p1"] == 2
    assert c[f"ns_cell_{kind}_curl_p1_facet"] == (2 if facet else 0)
    as_tuple = (lambda o: o if isinstance(o, tuple) else (o,))
    ref = fn(*_on_cpu(cargs), facets=_blocks_on_cpu(blocks))
    for g, r, x in zip(as_tuple(got), as_tuple(ref), as_tuple(again)):
        assert torch.equal(g, x)
        if float(r.abs().max()) > 0:
            _close_tol(g.cpu(), r, tol)
        else:
            assert not g.any()
    if facet:
        apart = as_tuple(fn(*cargs)) + tuple(
            facet_call(b.term, b.scalars, jac, u, up, p, *b.args())
            for b in blocks)
        assert len(apart) == len(as_tuple(got))
        for g, a in zip(as_tuple(got), apart):
            assert torch.equal(g, a)


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("kind", ["residual", "jacobian"])
def test_element_launch_with_five_and_eight_blocks(sc_pbf, kind, dt):
    """K3 with the pressure_backflow form's five blocks in its launch,
    and with eight (three of them again): bitwise equal to the launches
    apart, within the tolerance of the plain versions; nine refused."""
    from cfdtpu_torch import kernels
    from cfdtpu_torch.kernels import ns_cell_residual as k3
    from cfdtpu_torch.kernels.ns_facet import facet_call

    dtype, tol = _dev_tol(dt)
    s = sc_pbf.solver
    f, prm = s.form, s.params()
    u, up, _, p = _developed(s, dtype, seed=24)
    _, (dmu, dmp, coords, h, tabs) = _cast_form(f, dtype)
    cargs = (u, up, p, dmu, dmp, coords, h, tabs, prm["rho"], prm["mu"],
             prm["dt"], prm["f"], float(np.finfo(str(dtype)[6:]).resolution))
    five = [_facet_block(f, b["name"], dtype, prm) for b in f._facet_blocks]
    assert [b.term.term for b in five] == ["weakp", "nitsche", "weakp",
                                           "viscous", "backflow"]
    jac = kind == "jacobian"
    fn = k3.ns_cell_jacobian_p1 if jac else k3.ns_cell_residual_p1
    as_tuple = (lambda o: o if isinstance(o, tuple) else (o,))
    for blocks in (five, five + five[1:4]):
        kernels.reset_counts()
        got = fn(*cargs, facets=blocks)
        assert kernels.counts()[f"ns_cell_{kind}_p1_facet"] == 1
        apart = as_tuple(fn(*cargs)) + tuple(
            facet_call(b.term, b.scalars, jac, u, up, p, *b.args())
            for b in blocks)
        ref = fn(*_on_cpu(cargs), facets=_blocks_on_cpu(blocks))
        assert len(got) == len(apart) == len(ref)
        for g, a, r in zip(got, apart, ref):
            assert torch.equal(g, a)
            if float(r.abs().max()) > 0:
                _close_tol(g.cpu(), r, tol)
    with pytest.raises(NotImplementedError, match="facet blocks"):
        fn(*cargs, facets=five + five[:4])


@pytest.mark.parametrize("solver", ["stabilized_schur_pressurebc",
                                    "stabilized_schur_pressure_backflow"])
def test_weak_pressure_forms_issue_one_element_launch(sc_pbc, sc_pbf,
                                                      solver):
    """form.residual launches the element kernel once with every block
    in it and K2 twice for the cells and once per block; a Jacobian
    build one launch (the wrappers' counts)."""
    from cfdtpu_torch import kernels

    scn = sc_pbc if solver.endswith("pressurebc") else sc_pbf
    s = scn.solver
    key = "curl_p1" if solver.endswith("pressurebc") else "p1"
    u, up, _, p = _developed(s, s.dtype, seed=25)
    prm = s.params()
    nblocks = len(s.form._facet_blocks)
    for name, fn, want in (
            ("residual", lambda: s.form.residual(u, p, (up,), prm),
             {f"ns_cell_residual_{key}": 1,
              f"ns_cell_residual_{key}_facet": 1, "ell_sum": 2 + nblocks}),
            ("jacobian", lambda: s.form.element_jacobians(u, p, (up,), prm),
             {f"ns_cell_jacobian_{key}": 1,
              f"ns_cell_jacobian_{key}_facet": 1})):
        kernels.reset_counts()
        fn()
        got = {k: n for k, n in kernels.counts().items()
               if n and not k.endswith("_fused")}
        assert got == want, (name, got)


@pytest.mark.parametrize("solver", ["stabilized_schur_pressurebc",
                                    "stabilized_schur_pressure_backflow"])
def test_weak_pressure_solvers_on_card_match_cpu(solver):
    """Two float64 steps of pipe_cylinder_pressurebc through the kernels
    equal the plain versions (CPU): counts, state within 1e-9 and (path
    H) p_c."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cfdtpu_torch.scenarios.pipe_cylinder_pressurebc import (
        PipeCylinderPressureBC)

    out = []
    for dev in ("cuda", "cpu"):
        kw = dict(PIPE_KW, device=dev, p_outlet=0.0)
        if solver.endswith("backflow"):
            kw["R_resistance"] = 1.0
        s = PipeCylinderPressureBC(solver, **kw).solver
        rec = []
        for _ in range(2):
            s.solveStep()
            rec.append((s.last_stats["newton_iters"],
                        s.last_stats["ksp_iters"], getattr(s, "p_c", 0.0)))
            s.u_prev, s.p_prev = s.u_sol, s.p_sol
        out.append((rec, s.u_sol.cpu().numpy(), s.p_sol.cpu().numpy()))
    (ca, ua, pa), (cb, ub, pb) = out
    assert [c[:2] for c in ca] == [c[:2] for c in cb]
    np.testing.assert_allclose([c[2] for c in ca], [c[2] for c in cb],
                               rtol=1e-9, atol=0)
    for a, b in ((ua, ub), (pa, pb)):
        assert np.linalg.norm(a - b) / np.linalg.norm(b) < 1e-9


def _launched(*names):
    from cfdtpu_torch import kernels

    got = kernels.counts()
    missing = [n for n in names if not got[n]]
    assert not missing, (missing, got)


def test_ghia_path_j_on_card_matches_cpu():
    """Path J small: validate_ghia's march at Re 100, nx 8, 3 steps,
    float64, through the kernels (K14 among them) and the plain
    versions: equal counts, Ghia deviation and centerline within 1e-9."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cfdtpu_torch import kernels
    from cfdtpu_torch.scripts.validate_ghia import solve_case

    kernels.reset_counts()
    a = solve_case(100, nx=8, n_steps=3, quiet=True, device="cuda",
                   dtype="float64")
    _launched("ns_cell_residual_bdf2_p1", "ns_cell_jacobian_bdf2_p1",
              "sup_spmv", "ell_sum")
    b = solve_case(100, nx=8, n_steps=3, quiet=True, device="cpu",
                   dtype="float64")
    assert a["counts"] == b["counts"]
    assert abs(a["max_err"] - b["max_err"]) <= 1e-9 * b["max_err"]
    np.testing.assert_allclose(a["u"], b["u"], rtol=1e-9,
                               atol=1e-9 * np.abs(b["u"]).max())


def test_dfg2d2_path_k_on_card_matches_cpu(tmp_path):
    """Path K small: PipeCylinder2D2Simulation at res_scale 3.0, two
    float64 steps under the rasamg_sup settings: the force rows within
    1e-9 of the plain versions', read once, at the end."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cfdtpu_torch import kernels
    from cfdtpu_torch.scenarios.pipe_cylinder import (
        PipeCylinder2D2Simulation)

    rows = {}
    for dev in ("cuda", "cpu"):
        kernels.reset_counts()
        sc = PipeCylinder2D2Simulation(
            "stabilized_schur", dt=0.0025, T=0.004, res_scale=3.0,
            dtype="float64", device=dev, pc_inner_method="rasamg_sup",
            pc_inner_u=0, pc_inner_p=3, pc_ras_size=32)
        sc.solve(str(tmp_path / dev))
        if dev == "cuda":
            # no ras_apply: at 386 nodes the velocity hierarchy is its
            # coarsest level alone, solved directly
            _launched("sup_spmv", "ell_sum", "ns_cell_residual_p1",
                      "krylov_cgs")
        rows[dev] = np.loadtxt(tmp_path / dev / "bdforces.txt", ndmin=2)
    a, b = rows["cuda"], rows["cpu"]
    assert a.shape == b.shape == (2, 4)
    np.testing.assert_array_equal(a[:, :2], b[:, :2])
    for col in (2, 3):
        assert np.abs(a[:, col] - b[:, col]).max() \
            <= 1e-9 * np.abs(b[:, col]).max()


def test_stenosis_path_l_on_card_matches_cpu(tmp_path):
    """Path L small: the stenosis at res 0.6, two float64 steps under
    stabilized_schur_pressurebc (K15 with K16 and K17 in its launch),
    card against host: counts, state and FFR within 1e-9; the tree
    scenario at res 1.0, one step, its Reynolds field within 1e-9."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cfdtpu_torch import kernels
    from cfdtpu_torch.scenarios.stenosis import StenosisSimulation
    from cfdtpu_torch.scenarios.stenosis_with_tree_2d_pressure import (
        StenosisWithTree2DPressureSimulation)

    out = {}
    for dev in ("cuda", "cpu"):
        kernels.reset_counts()
        sc = StenosisSimulation("stabilized_schur_pressurebc", dt=0.005,
                                T=0.0075, res=0.6, dtype="float64",
                                device=dev, output_every=10)
        counts = []
        sc.solve(str(tmp_path / f"st_{dev}"), afterStepCallback=lambda t: (
            counts.append((sc.solver.last_stats["newton_iters"],
                           sc.solver.last_stats["ksp_iters"]))))
        if dev == "cuda":
            _launched("ns_cell_residual_curl_p1_facet",
                      "ns_cell_jacobian_curl_p1_facet", "block_jacobi",
                      "ns_facet_weakp_p1_fused",
                      "ns_facet_nitsche_curl_p1_fused")
        ffr = sc._compute_ffr(str(tmp_path / f"st_{dev}"))
        tree = StenosisWithTree2DPressureSimulation(
            "stabilized_schur_pressurebc", dt=0.005, T=0.0025, res=1.0,
            dtype="float64", device=dev, output_every=10)
        tree.solve(str(tmp_path / f"tree_{dev}"))
        out[dev] = (counts, sc.solver.u_sol.cpu().numpy(),
                    sc.solver.p_sol.cpu().numpy(), ffr, tree.reynolds)
    (ca, ua, pa, fa, ra), (cb, ub, pb, fb, rb) = out["cuda"], out["cpu"]
    assert ca == cb and len(ca) == 2
    assert 0 < fa < 1 and abs(fa - fb) <= 1e-9 * fb
    for a, b in ((ua, ub), (pa, pb), (ra, rb)):
        assert np.linalg.norm(a - b) / np.linalg.norm(b) < 1e-9


# ---------------------------------------------------------------------
# P1 tetrahedra (the DFG 3D-1Z path): the tetrahedral K3 with K7 in its
# launch (csrc/ns_cell_tet.cu), and the node-block kernels at 4 x 4
# node blocks (g bs = 16: K1 on the outer operator and its sub-blocks,
# K2's assembly, K4, K6 and K10 at d = 3, K1's prolong at width 3),
# against their plain versions in float64 (1e-12) and float32 (1e-5),
# two calls bitwise equal. The mesh: the benchmark's extruded DFG
# cross-section at res_scale 2.0 in 4 layers.
@pytest.fixture(scope="module", params=["f64", "f32"])
def sc3d(request, tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from benchmark import cell as cellmod
    from benchmark.meshes import dfg3d

    dtype = "float64" if request.param == "f64" else "float32"
    _, _, cell, config = cellmod.resolve(
        "dfg3d1z_developed",
        config_patch={"dtype": dtype, "mesh": {"res_scale": 2.0,
                                               "layers": 4}})
    mesh = dfg3d.make(config, cache_dir=str(tmp_path_factory.mktemp("m")))
    sc = cellmod.build_scenario(config, cell, mesh, None, "cuda")
    return request.param, sc


def _state3d(s, seed=0):
    rng = np.random.default_rng(seed)
    n = s.V.num_dofs
    return (s.tensor(0.3 * rng.standard_normal((n, 3))),
            s.tensor(0.3 * rng.standard_normal((n, 3))),
            s.tensor(rng.standard_normal(n)))


def _to_cpu_args(args):
    from cfdtpu_torch.kernels.ns_cell_residual import CellTabs

    out = []
    for a in args:
        if isinstance(a, CellTabs):
            a = CellTabs(*(None if t is None else t.cpu() for t in (
                a.qw, a.phi_u, a.dphi_u, a.d2phi_u, a.phi_p, a.dphi_p,
                a.gdphi)), a.p1, a.affine)
        elif torch.is_tensor(a):
            a = a.cpu()
        out.append(a)
    return out


@pytest.mark.parametrize("entry", ["residual", "jacobian"])
def test_tet_element_kernel_matches_plain_and_repeats(sc3d, entry):
    """The tetrahedral K3 with the natural-correction block in its
    launch against the plain cell and facet kernels (the CPU), and two
    launches bitwise equal; one launch a call, K7 never alone."""
    from cfdtpu_torch import kernels
    from cfdtpu_torch.kernels.ns_cell_residual import (ns_cell_jacobian_p1,
                                                       ns_cell_residual_p1)
    from cfdtpu_torch.kernels.ns_facet import FacetBlock

    dt, sc = sc3d
    _, tol = _dev_tol(dt)
    s = sc.solver
    f = s.form
    prm = s.params()
    u, up, p = _state3d(s)
    fn = ns_cell_residual_p1 if entry == "residual" else ns_cell_jacobian_p1
    blocks = [f._kernel_block(b, prm) for b in f._facet_blocks]
    args = (u, up, p, f.dofmap_u, f.dofmap_p, f.cell_coords, f.cell_h,
            f.tabs, prm["rho"], prm["mu"], prm["dt"], prm["f"], f.eps)
    kernels.reset_counts()
    got = fn(*args, facets=blocks)
    again = fn(*args, facets=blocks)
    torch.cuda.synchronize()
    cblocks = [FacetBlock(b.term, b.dofmap_u.cpu(), b.dofmap_p.cpu(),
                          b.coords.cpu(),
                          {k: v.cpu() for k, v in b.tabs.items()},
                          b.scalars) for b in blocks]
    ref = fn(*_to_cpu_args(args), facets=cblocks)
    assert len(got) == len(ref) == (3 if entry == "residual" else 2)
    for g, a, r in zip(got, again, ref):
        _close_tol(g.cpu(), r, tol)
        assert torch.equal(g, a)
    name = f"ns_cell_{entry}_p1"
    n = kernels.counts()
    assert n[name] == n[name + "_tet"] == n[name + "_facet"] == 2
    jac = "_jac" if entry == "jacobian" else ""
    assert n[f"ns_facet_natural{jac}_p1_fused"] == 2
    assert n[f"ns_facet_natural{jac}_p1"] == 0


def test_tet_form_calls_launch_the_tet_kernels(sc3d):
    """form.residual and form.element_jacobians run the tetrahedral
    element kernel (its facet variant), and the step's plain CPU path
    is never taken on the card."""
    from cfdtpu_torch.utils.cudatime import launches

    _, sc = sc3d
    s = sc.solver
    u, up, p = _state3d(s, 1)
    prm = s.params()
    _, names = launches(lambda: s.form.residual(u, p, (up,), prm))
    assert any("ns_cell_residual_tet_facet_kernel" in k for k in names)
    _, names = launches(lambda: s.form.element_jacobians(u, p, (up,), prm))
    assert any("ns_cell_jacobian_tet_facet_kernel" in k for k in names)


@pytest.mark.parametrize("site", ["K1 outer", "K1 uu", "K1 pu", "K2 assemble",
                                  "K4 selfp", "K6 ras", "K10 inverses",
                                  "K10 apply"])
def test_node_block_kernels_4x4_match_plain_and_repeat(sc3d, site):
    """The node-block kernels on the 3D operator (4 x 4 node blocks,
    supernodes of g = 4, asked for: 16 x 16 blocks; the velocity block
    at d = 3) against their plain versions, two calls bitwise equal."""
    from cfdtpu_torch.kernels.block_jacobi import (block_jacobi,
                                                   block_jacobi_inv,
                                                   block_jacobi_inv_plain,
                                                   block_jacobi_plain)
    from cfdtpu_torch.kernels.ell_sum import ell_sum, ell_sum_plain
    from cfdtpu_torch.kernels.ras_apply import ras_apply, ras_apply_plain
    from cfdtpu_torch.kernels.selfp_triple import (selfp_triple,
                                                   selfp_triple_plain)
    from cfdtpu_torch.kernels.sup_spmv import sup_spmv, sup_spmv_plain
    from cfdtpu_torch.la.nodebsr import NodeBSR

    dt, sc = sc3d
    dtype, tol = _dev_tol(dt)
    s = sc.solver
    # the supernode layout on request: tetrahedra default to node blocks
    f, nb = s.form, NodeBSR(s.form, supernode_g=4)
    assert (nb.bs, nb.g, nb.dim) == (4, 4, 3)
    u, up, p = _state3d(s, 2)
    vals = nb.assemble(*f.element_jacobians(u, p, (up,), s.params()))
    assert tuple(vals["coo"].shape[1:]) == (4, 4)
    rng = np.random.default_rng(3)

    def dev(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                               device="cuda")

    n_u = nb.n_u_flat
    cols = nb._sup.sup_cols
    sup = vals["sup"]
    gd = nb.g * nb.dim
    if site == "K1 outer":
        v = dev(n_u + nb.n_nodes)
        split = (n_u, gd)
        call = (lambda k: k(sup, cols, v, v.shape[0], x_split=split,
                            y_split=split))
        pair = (sup_spmv, sup_spmv_plain)
    elif site == "K1 uu":
        v = dev(n_u)
        call = (lambda k: k(sup[:, :, :gd, :gd], cols, v, n_u))
        pair = (sup_spmv, sup_spmv_plain)
    elif site == "K1 pu":
        v = dev(n_u)
        call = (lambda k: k(sup[:, :, gd:, :gd], cols, v, nb.n_nodes))
        pair = (sup_spmv, sup_spmv_plain)
    elif site == "K2 assemble":
        scat = nb._assemble_scatter
        src = dev(scat.n_in, 16)
        csr = (scat.row_ptr, scat.pos, scat.K)
        call = (lambda k: k(src, *csr))
        pair = (ell_sum, ell_sum_plain)
    elif site == "K4 selfp":
        nb.sp_structure()
        inv = dev(nb.n_nodes, 3)
        sargs = (vals["coo"], nb._sp_e1, nb._sp_e2, nb._sp_K, inv)
        call = (lambda k: k(*sargs))
        pair = (selfp_triple, selfp_triple_plain)
    elif site == "K6 ras":
        ras = nb.uu_ras(32, 4)
        assert ras.d == 3
        inv = dev(ras.n_sub, ras.s * ras.d, ras.m)
        v = dev(n_u)
        call = (lambda k: k(inv, v, ras.s, ras.o, ras.d, 0.5 * v))
        pair = (ras_apply, ras_apply_plain)
    elif site == "K10 inverses":
        mask = torch.as_tensor(rng.random(n_u) < 0.1, device="cuda")
        diag = nb._diag_pos
        call = (lambda k: k(vals["coo"].contiguous(), diag, mask, 3))
        pair = (block_jacobi_inv, block_jacobi_inv_plain)
    else:
        inv = dev(nb.n_nodes, 3, 3)
        v = dev(n_u)
        call = (lambda k: k(inv, v))
        pair = (block_jacobi, block_jacobi_plain)
    got, again = call(pair[0]), call(pair[0])
    ref = call(pair[1])
    torch.cuda.synchronize()
    _close_tol(got, ref, tol)
    assert torch.equal(got, again)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_k1_prolong_width_3_matches_k8_then_k1(dt):
    """K1 with the coarse-grid correction in its gather at width 3
    (BlockAMG's levels in 3D: 8 nodes of 3 values a supernode) against
    K8's plain version then K1's, with and without the input scale, in
    modes residual (xhat stored) and jacobi."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cfdtpu_torch.kernels.amg_prolong import amg_prolong_plain
    from cfdtpu_torch.kernels.sup_spmv import sup_spmv, sup_spmv_plain

    dtype, tol = _dev_tol(dt)
    rng = np.random.default_rng(11)
    ns, kg, C, w, nco = 600, 5, 24, 3, 40

    def dev(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                               device="cuda")

    A = dev(ns, kg, C, C)
    cols = torch.as_tensor(rng.integers(0, ns, (ns, kg)).astype(np.int32),
                           device="cuda")
    m = ns * C - 3 * w
    x, b, xc = dev(m), dev(m), dev(nco * w)
    d = 1.0 + torch.rand(m, dtype=dtype, device="cuda")
    sc = 0.5 + torch.rand(m, dtype=dtype, device="cuda")
    agg = torch.as_tensor(rng.integers(0, nco, m // w).astype(np.int32),
                          device="cuda")
    for mode in ("residual", "jacobi"):
        for scale in (None, sc):
            kw = dict(mode=mode, b=b, d=d, omega=0.67)
            xh = torch.empty(m, dtype=dtype, device="cuda")
            extra = {"xhat_out": xh} if mode == "residual" else {}
            got = sup_spmv(A, cols, x, m, scale=scale,
                           prolong=(xc, agg, w), **kw, **extra)
            again = sup_spmv(A, cols, x, m, scale=scale,
                             prolong=(xc, agg, w), **kw)
            xhat = amg_prolong_plain(xc, agg, w, x, scale)
            _close_tol(got, sup_spmv_plain(A, cols, xhat, m, **kw), tol)
            assert torch.equal(got, again)
            if extra:
                _close_tol(xh, xhat, tol)


# ---------------------------------------------------------------------
# K1's node-block mode (csrc/bsr_spmv.cu): NodeBSR's applies on the 4 x
# 4 node blocks of tetrahedra, the layout they resolve to, with every
# epilogue their callers pass, against bsr_spmv's plain version.
BSR_SITES = ("outer", "outer + mask", "Auu + mask", "Auu cheby + scale + mask",
             "Auu cheby + add", "Aup zero rows", "Apu", "r_p - Apu z_u",
             "S: Apu residual + scale + p rows", "App", "p column")


def _bsr_case(nb, site, dtype, rng):
    """(x, rows, xcols, kw) of a NodeBSR apply's bsr_spmv call."""
    n, n_u = nb.n_nodes, nb.n_u_flat

    def vec(m):
        return torch.as_tensor(rng.standard_normal(m), dtype=dtype,
                               device="cuda")

    def rows(m, frac=0.1):
        return torch.as_tensor(rng.random(m) < frac, device="cuda")

    full, vu, vp = vec(n_u + n), vec(n_u), vec(n)
    mask_u, mask_p = rows(n_u), rows(n, 0.05)
    scale_u = torch.where(mask_u, 0.0, 1.0 + vec(n_u).abs())
    w = 1.0 + vec(n_u).abs()
    return {
        "outer": (full, "all", "all", {}),
        "outer + mask": (full, "all", "all", dict(
            mask=torch.cat([mask_u, mask_p]), mask_value=full)),
        "Auu + mask": (vu, "u", "u", dict(mask=mask_u, mask_value=vu)),
        "Auu cheby + scale + mask": (vu, "u", "u", dict(
            mode="cheby", b=vec(n_u), scale=scale_u, mask=mask_u,
            cheb=(w, None, 0.4, 1.7), d_out=True)),
        "Auu cheby + add": (vu, "u", "u", dict(
            mode="cheby", b=vec(n_u), cheb=(w, vec(n_u), 0.4, 1.7),
            add=vec(n_u), d_out=True)),
        "Aup zero rows": (vp, "u", "p", dict(mask=mask_u)),
        "Apu": (vu, "p", "u", {}),
        "r_p - Apu z_u": (vu, "p", "u", dict(mode="residual", b=vec(n))),
        "S: Apu residual + scale + p rows": (vu, "p", "u", dict(
            mode="residual", b=vec(n), scale=scale_u, mask=mask_p,
            mask_value=vp)),
        "App": (vp, "p", "p", {}),
        "p column": (vp, "all", "p", {}),
    }[site]


@pytest.mark.parametrize("site", BSR_SITES)
def test_bsr_spmv_matches_plain_and_repeats(sc3d, site):
    """bsr_spmv at every NodeBSR site on the 3D operator against its plain
    version (1e-12 in float64, 1e-5 in float32; d_out too), two calls
    bitwise equal, one launch a call on its counter and none of K1's on
    the supernode layout."""
    from cfdtpu_torch import kernels
    from cfdtpu_torch.kernels.bsr_spmv import bsr_spmv, bsr_spmv_plain

    dt, sc = sc3d
    dtype, tol = _dev_tol(dt)
    s = sc.solver
    nb = s._nodebsr
    assert (nb.g, nb.bs) == (1, 4)
    u, up, p = _state3d(s, 5)
    vals = nb.assemble(*s.form.element_jacobians(u, p, (up,), s.params()))
    assert set(vals) == {"coo"}
    coo = vals["coo"].to(dtype)
    x, rows, xcols, kw = _bsr_case(nb, site, dtype,
                                   np.random.default_rng(6))
    outs = []

    def call(fn):
        k = dict(kw)
        if k.pop("d_out", None):
            k["d_out"] = torch.empty_like(k["b"])
        y = fn(coo, nb._bsr_rowptr, nb._bsr_cols, x, rows, xcols, **k)
        outs.append((y, k.get("d_out")))
        return y

    kernels.reset_counts()
    call(bsr_spmv)
    call(bsr_spmv)
    n = kernels.counts()
    call(bsr_spmv_plain)
    torch.cuda.synchronize()
    (got, d_got), (again, d_again), (ref, d_ref) = outs
    assert n["bsr_spmv"] == 2 and n["sup_spmv"] == 0
    _close_tol(got, ref, tol)
    assert torch.equal(got, again)
    if d_ref is not None:
        _close_tol(d_got, d_ref, tol)
        assert torch.equal(d_got, d_again)


def _scenario3d(tmp_path, dtype="float32"):
    from benchmark import cell as cellmod
    from benchmark.meshes import dfg3d

    _, _, cell, config = cellmod.resolve(
        "dfg3d1z_developed",
        config_patch={"dtype": dtype, "mesh": {"res_scale": 2.0,
                                               "layers": 4}})
    # every step checked, so that last_stats says whether it converged
    config["solver_kw"] = {**config["solver_kw"], "stats_every": 1}
    mesh = dfg3d.make(config, cache_dir=str(tmp_path))
    return cellmod.build_scenario(config, cell, mesh, None, "cuda")


def test_3d_step_runs_no_sup_spmv_on_node_blocks(tmp_path, monkeypatch):
    """A 3D stabilized_schur step under amg_p (the configuration's
    solver) applies its operator only through the node-block mode: no
    NodeBSR apply calls sup_spmv, and the only K1 launches on the
    supernode layout are the SELFP AMG levels'."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cfdtpu_torch import kernels
    from cfdtpu_torch.la import nodebsr

    sc = _scenario3d(tmp_path)
    s = sc.solver
    assert s.pc_inner_method == "amg_p" and s._nodebsr.g == 1
    via_nodebsr, sup_spmv = [], nodebsr.sup_spmv

    def spy(*a, **k):
        via_nodebsr.append(1)
        return sup_spmv(*a, **k)

    monkeypatch.setattr(nodebsr, "sup_spmv", spy)
    kernels.reset_counts()
    s.solveStep()
    torch.cuda.synchronize()
    n = kernels.counts()
    assert s.last_stats["converged"]
    assert not via_nodebsr
    assert n["bsr_spmv"] > 0 and n["sup_spmv"] > 0


def test_2d_step_launches_no_node_block_mode():
    """On triangles the layout stays the supernodes' (g = 4): a step
    launches K1 there and never its node-block mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cfdtpu_torch import kernels
    from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark

    s = DFG1Benchmark("stabilized_schur", dt=0.05, T=1.0, res_scale=2.5,
                      dtype="float32", device="cuda").solver
    assert s._nodebsr.g == 4
    kernels.reset_counts()
    s.solveStep()
    torch.cuda.synchronize()
    n = kernels.counts()
    assert s.last_stats["converged"]
    assert n["sup_spmv"] > 0 and n["bsr_spmv"] == 0
