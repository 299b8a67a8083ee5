"""Precision and device policy.

device=None means the card: it resolves to "cuda", and the CPU runs
only when the caller asks for it (device="cpu"). dtype="auto" resolves
to float32 on a CUDA device and float64 on the CPU — the counterpart of
cfdtpu/utils/dtypes.py, where the TPU gets float32 and the CPU float64.
Meshes and host arrays keep numpy dtypes; tensors take the matching
torch dtype.

A CUDA device that is not available raises, the default included:
nothing carries on on the CPU in its place.
"""

from __future__ import annotations

import numpy as np
import torch

_TORCH = {np.dtype(np.float32): torch.float32,
          np.dtype(np.float64): torch.float64}


def resolve_device(device=None) -> torch.device:
    """The torch device for `device`; None means the card ("cuda")."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} means the CUDA card, but CUDA is not "
            "available (pass device='cpu' to run on the CPU)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"unsupported device {device!r}")
    return dev


def resolve_dtype(dtype, device=None) -> np.dtype:
    if dtype is None or dtype == "auto":
        dev = resolve_device(device)
        return np.dtype(np.float32 if dev.type == "cuda" else np.float64)
    return np.dtype(dtype)


def torch_dtype(dtype) -> torch.dtype:
    """numpy float dtype -> torch dtype."""
    try:
        return _TORCH[np.dtype(dtype)]
    except KeyError:
        raise NotImplementedError(f"unsupported dtype {dtype!r}") from None


def default_tolerances(dtype) -> dict:
    """Dtype-appropriate Newton/Krylov tolerances (same values as
    cfdtpu/utils/dtypes.py)."""
    if np.dtype(dtype) == np.float32:
        return {
            "snes_rtol": 1e-5,
            "snes_atol": 1e-8,
            "snes_stol": 1e-6,
            "ksp_rtol": 1e-4,
        }
    return {
        "snes_rtol": 1e-8,
        "snes_atol": 1e-10,
        "snes_stol": 1e-8,
        "ksp_rtol": 1e-5,
    }
