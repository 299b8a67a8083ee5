"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import functools

import torch

FLOATS = (torch.float32, torch.float64)


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; anything else raises
    (the plain versions serve CPU tensors only)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise NotImplementedError(f"no kernel for device {t.device}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_float(name: str, t: torch.Tensor, dtype=None) -> None:
    require(t.dtype in FLOATS,
            f"{name}: dtype {t.dtype} not in float32/float64")
    if dtype is not None:
        require(t.dtype == dtype, f"{name}: dtype {t.dtype} != {dtype}")


def check_index(name: str, t: torch.Tensor) -> None:
    require(t.dtype == torch.int32, f"{name}: indices must be int32")
    require(t.is_contiguous(), f"{name}: indices must be contiguous")


def check_same_device(*named) -> None:
    dev = named[0][1].device
    for name, t in named[1:]:
        if t is not None:
            require(t.device == dev, f"{name}: on {t.device}, not {dev}")


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def is_f64(t: torch.Tensor) -> int:
    return 1 if t.dtype == torch.float64 else 0


@functools.lru_cache(maxsize=None)
def sm_count(index) -> int:
    """The multiprocessor count of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count
