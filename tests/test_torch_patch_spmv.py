"""K5 patch_spmv (the port of scripts/gather_micro.py pallas_patch_spmv)
and the cfdtpu_torch gather_micro entry point, on the CPU.

The reference is the repo's one Pallas kernel itself, run by its own
script in Pallas interpret mode (pl.pallas_call with interpret=True) at
a small size, P=16 patches, K=4. Its inputs are drawn from
numpy.random.default_rng(0) as the port's are.

Tolerance 1e-6 relative: both sides are float32 and sum K products in
the same order; the interpreter and torch may still round the products
differently (fused or not).
"""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from jax.experimental import pallas as pl

from cfdtpu_torch import kernels
from cfdtpu_torch.kernels.patch_spmv import patch_spmv, patch_spmv_plain
from cfdtpu_torch.scripts import gather_micro

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-6


def _load_reference_script():
    spec = importlib.util.spec_from_file_location(
        "ref_gather_micro", os.path.join(REPO, "scripts", "gather_micro.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def pallas_run():
    """Run gather_micro.pallas_patch_spmv(16, 4) in interpret mode and
    capture its inputs and its kernel's output (its timing loop is cut
    to the one call that is captured)."""
    ref = _load_reference_script()
    got = {}

    def capture(fn, *args, reps=50):
        got["y"] = np.asarray(fn(*args))
        got["args"] = [np.array(a) for a in args]
        return 1.0

    mp = pytest.MonkeyPatch()
    mp.setattr(pl, "pallas_call",
               functools.partial(pl.pallas_call, interpret=True))
    mp.setattr(ref, "bench", capture)
    try:
        ref.pallas_patch_spmv(16, 4)
    finally:
        mp.undo()
    return got


def test_plain_matches_pallas_interpret(pallas_run):
    x, vals, idx = (torch.as_tensor(a) for a in pallas_run["args"])
    assert x.shape == (16, 128) and vals.shape == (16, 128, 4)
    got = patch_spmv(x, vals, idx)  # CPU tensors: the plain version
    ref = pallas_run["y"]
    err = np.abs(got.numpy() - ref).max()
    assert err <= RTOL * np.abs(ref).max(), err


def test_port_inputs_are_the_originals(pallas_run):
    """gather_micro's inputs are drawn as the original draws them."""
    for a, b in zip(gather_micro.patch_inputs(16, 4, "cpu"),
                    pallas_run["args"]):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("P,K", [(4, 8), (3, 16)])
def test_k1_width1_equals_plain_k5(P, K):
    """The same product through K1 (sup_spmv) at width 1, columns
    p*128 + idx: float32, sums in the same k order."""
    x, vals, idx = gather_micro.patch_inputs(P, K, "cpu")
    ref = patch_spmv_plain(x, vals, idx)
    got = gather_micro.patch_spmv_k1(x, vals, idx)
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)


def test_float64_and_counts():
    """float64 inputs take the same plain path; CPU tensors launch no
    kernel and count nothing."""
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((5, 128)))
    vals = torch.as_tensor(rng.standard_normal((5, 128, 3)))
    idx = torch.as_tensor(rng.integers(0, 128, (5, 128, 3)).astype(np.int32))
    kernels.reset_counts()
    got = patch_spmv(x, vals, idx)
    ref = np.einsum("pjk,pjk->pj", vals.numpy(),
                    np.take_along_axis(x.numpy()[:, :, None].repeat(3, 2),
                                       idx.numpy().astype(np.int64), axis=1))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-13, atol=1e-13)
    assert kernels.counts()["patch_spmv"] == 0


@pytest.mark.parametrize("bad", ["idx_dtype", "shape", "mixed_dtype"])
def test_wrapper_rejects_bad_input(bad):
    x, vals, idx = gather_micro.patch_inputs(2, 4, "cpu")
    if bad == "idx_dtype":
        idx = idx.long()
    elif bad == "shape":
        vals = vals[:, :64]
    else:
        vals = vals.double()
    with pytest.raises(ValueError):
        patch_spmv(x, vals, idx)


def test_gather_micro_raises_on_cpu():
    """The script measures the card: a CPU device is an error, not a
    fallback."""
    with pytest.raises(RuntimeError, match="CUDA card"):
        gather_micro.main(["--device", "cpu"])
