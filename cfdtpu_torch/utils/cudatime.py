"""Device time of a CUDA call, measured with CUDA events, and the device
activities it issues, read from torch.profiler."""

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


def device_kernels(fn) -> list[str]:
    """Names of the device activities (kernels, copies, fills) one fn()
    call issues, from torch.profiler's CUDA trace, in launch order. One
    warm-up call first, so that a kernel's build is not counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("device_kernels traces a CUDA card; none is "
                           "available")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in sorted(prof.events(),
                                   key=lambda e: e.time_range.start)
            if e.device_type == DeviceType.CUDA]
