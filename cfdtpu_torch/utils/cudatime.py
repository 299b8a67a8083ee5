"""Device time of a CUDA call, measured with CUDA events."""

from __future__ import annotations

import statistics
import time

import torch


def cuda_ms(fn, n: int = 25, warmup: int = 3) -> float:
    """Median device milliseconds of one fn() call over n calls.

    Each call is bracketed by CUDA events. The device is first held busy
    (torch.cuda._sleep) for longer than the host needs to queue all n
    calls, so the events see only device execution, not the host-side
    dispatch of the Python wrapper."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_ms measures a CUDA card; none is available")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    # ~2e9 cycles per second at H100 clocks; 3x margin over the enqueue
    cycles = int(min(2.0, 3.0 * n * host_s + 0.01) * 2e9)
    evs = []
    torch.cuda._sleep(cycles)
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in evs)
