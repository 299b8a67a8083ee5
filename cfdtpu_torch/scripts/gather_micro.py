"""Microbenchmark: a flat gather and the patch-local SpMV on a CUDA card.

The counterpart of scripts/gather_micro.py, at its shapes:

- flat gather x[idx] of n float32 values at n in (262,144; 1,048,576;
  4,194,304) (the original times XLA's gather; here torch's indexing);
- the in-patch scalar ELL SpMV
      y[p, j] = sum_{k<K} vals[p, j, k] * x[p, idx[p, j, k]]
  at (P, K) in ((2048, 8), (2048, 16), (8192, 8)), L = 128 slots per
  patch, inputs made with numpy.random.default_rng(0) as in the
  original. It runs through kernel K5 (kernels/patch_spmv.py, the port
  of pallas_patch_spmv), is checked against its plain version within
  1e-5 relative, and the same product runs through K1 (sup_spmv) at
  width 1 with columns p*L + idx, to show whether staging the patch on
  chip pays.

    python -m cfdtpu_torch.scripts.gather_micro --device cuda

Times are median CUDA-event device times (utils/cudatime.py); bytes
are counted as in the original (vals, idx, x and y once each). The last
line is one JSON object with every number. Any device other than a
CUDA card raises: the script measures the card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

L = 128
FLAT_SIZES = (262144, 1048576, 4194304)
PATCH_SHAPES = ((2048, 8), (2048, 16), (8192, 8))
RTOL = 1e-5  # float32 on both sides; the sums run in another order


def patch_inputs(P, K, device):
    """x (P, L), vals (P, L, K) float32 and idx (P, L, K) int32, drawn in
    the original's order from numpy.random.default_rng(0)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((P, L)).astype(np.float32)
    vals = rng.standard_normal((P, L, K)).astype(np.float32)
    idx = rng.integers(0, L, (P, L, K)).astype(np.int32)
    return tuple(torch.as_tensor(a, device=device) for a in (x, vals, idx))


def k1_operands(x, vals, idx):
    """The patch SpMV as a K1 (sup_spmv) operand set at width 1:
    A (P*L, K, 1, 1), cols (P*L, K) = p*L + idx, and x flat (P*L,)."""
    P, Lp, K = vals.shape
    cols = (torch.arange(P, dtype=torch.int32, device=idx.device)[:, None,
                                                                   None]
            * Lp + idx).reshape(P * Lp, K).contiguous()
    A = vals.reshape(P * Lp, K, 1, 1)
    return A, cols, x.reshape(-1)


def patch_spmv_k1(x, vals, idx):
    from ..kernels.sup_spmv import sup_spmv

    return sup_spmv(*k1_operands(x, vals, idx)).reshape(x.shape)


def _rel_err(got, ref):
    return float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                1e-30)


def flat_gather(n, device):
    from ..utils.cudatime import cuda_ms

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal(n).astype(np.float32),
                        device=device)
    idx = torch.as_tensor(rng.integers(0, n, n), device=device)
    t = cuda_ms(lambda: x[idx]) * 1e-3
    print(f"torch flat gather {n:>9} elems from {n:>8}: {t * 1e3:7.4f} ms  "
          f"{n / t / 1e9:6.2f} Gelem/s", flush=True)
    return {"n": n, "ms": t * 1e3, "gelem_per_s": n / t / 1e9}


def patch_spmv_bench(P, K, device):
    from ..kernels.patch_spmv import patch_spmv, patch_spmv_plain
    from ..kernels.sup_spmv import sup_spmv
    from ..utils.cudatime import cuda_ms

    x, vals, idx = patch_inputs(P, K, device)
    ref = patch_spmv_plain(x, vals, idx)
    y5 = patch_spmv(x, vals, idx)
    k1 = k1_operands(x, vals, idx)
    y1 = sup_spmv(*k1).reshape(x.shape)
    torch.cuda.synchronize()
    err5, err1 = _rel_err(y5, ref), _rel_err(y1, ref)
    ok = err5 <= RTOL and err1 <= RTOL
    t5 = cuda_ms(lambda: patch_spmv(x, vals, idx)) * 1e-3
    t1 = cuda_ms(lambda: sup_spmv(*k1)) * 1e-3
    tp = cuda_ms(lambda: patch_spmv_plain(x, vals, idx)) * 1e-3
    nbytes = vals.numel() * 4 + idx.numel() * 4 + 2 * x.numel() * 4
    ng = P * L * K
    print(f"patch-ELL P={P} K={K}: K5 {t5 * 1e3:7.4f} ms  "
          f"{ng / t5 / 1e9:6.2f} Ggather/s  {nbytes / t5 / 1e9:7.1f} GB/s | "
          f"K1 width 1 {t1 * 1e3:7.4f} ms  {nbytes / t1 / 1e9:7.1f} GB/s | "
          f"plain {tp * 1e3:7.4f} ms | rel err K5 {err5:.2e} "
          f"K1 {err1:.2e}  ok={ok}", flush=True)
    return {"P": P, "K": K, "ms": t5 * 1e3, "k1_ms": t1 * 1e3,
            "plain_ms": tp * 1e3, "ggather_per_s": ng / t5 / 1e9,
            "gb_per_s": nbytes / t5 / 1e9, "k1_gb_per_s": nbytes / t1 / 1e9,
            "rel_err": err5, "k1_rel_err": err1, "ok": ok}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="a CUDA device (anything else raises)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type != "cuda":
        raise RuntimeError(f"gather_micro measures a CUDA card; "
                           f"--device {args.device} is not one")
    if not torch.cuda.is_available():
        raise RuntimeError("gather_micro: CUDA is not available")
    from .. import kernels

    kernels.reset_counts()
    flat = [flat_gather(n, device) for n in FLAT_SIZES]
    patch = [patch_spmv_bench(P, K, device) for P, K in PATCH_SHAPES]
    launches = kernels.counts()
    print(json.dumps({"gather_micro": {
        "device": torch.cuda.get_device_name(device), "flat_gather": flat,
        "patch_spmv": patch, "launches": launches}}), flush=True)
    bad = [(r["P"], r["K"]) for r in patch if not r["ok"]]
    if bad:
        raise AssertionError(f"patch SpMV differs from its plain version "
                             f"beyond {RTOL:g} at (P, K) {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
