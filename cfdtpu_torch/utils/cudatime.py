"""Device time of a CUDA call, measured with CUDA events, and the device
activities it issues, read from torch.profiler."""

from __future__ import annotations

import statistics
import time

import torch

# bytes written between timed calls by cuda_ms(flush_l2=True): more than
# twice an H100's 50 MB L2, so the call finds none of its inputs there
FLUSH_BYTES = 128 * 2**20


def _flush(buf) -> None:
    """Write the buffer, then read back its first half: the L2 ends up
    holding clean lines of the buffer, as it holds clean operator values
    in the solver, and the timed call pays no write-back of the
    buffer's dirty lines."""
    buf.fill_(1)
    buf[: buf.numel() // 2].sum()


def cuda_ms(fn, n: int = 25, warmup: int = 3, flush_l2: bool = False
            ) -> float:
    """Median device milliseconds of one fn() call over n calls.

    Each call is bracketed by CUDA events. The device is first held busy
    (torch.cuda._sleep) for longer than the host needs to queue all n
    calls, so the events see only device execution, not the host-side
    dispatch of the Python wrapper. With flush_l2, a FLUSH_BYTES buffer
    is written (and half of it read back, _flush) before each call,
    outside its events, so the call reads its inputs from device memory
    (cold L2), as it does in the solver when a larger operator stream
    runs between two of its calls."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_ms measures a CUDA card; none is available")
    # allocated per call, so that no later peak-memory reading holds it
    buf = (torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
           if flush_l2 else None)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    if flush_l2:
        _flush(buf)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    # ~2e9 cycles per second at H100 clocks; 3x margin over the enqueue
    cycles = int(min(2.0, 3.0 * n * host_s + 0.01) * 2e9)
    evs = []
    torch.cuda._sleep(cycles)
    for _ in range(n):
        if flush_l2:
            _flush(buf)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in evs)


def empty_ms(n: int = 25) -> float:
    """cuda_ms of an empty kernel launched through the kernel library's
    C interface, as the port's kernels are: the floor that a small call
    site can approach."""
    from ..kernels._build import check, library

    if not torch.cuda.is_available():
        raise RuntimeError("empty_ms measures a CUDA card; none is available")
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        check(library().cfd_empty(stream), "empty")

    return cuda_ms(launch, n=n)


def device_kernels(fn, pad: int = 0) -> list[str]:
    """Names of the device activities (kernels, copies, fills) one fn()
    call issues, from torch.profiler's CUDA trace, in launch order
    (launches: one warm-up call first, so that a kernel's build is not
    counted, and the fullest of three traces; `pad` as there)."""
    return launches(fn, pad=pad)[1]


def device_ms(fn, n: int = 20, tries: int = 3) -> float | None:
    """Device milliseconds of one fn() call, from torch.profiler's CUDA
    trace: the summed durations of the device activities that n calls
    issue, over n. Unlike cuda_ms it leaves out the launch and the
    events around it (the empty kernel's cuda_ms), and sees the L2 warm
    from the calls before. A trace whose activities are no positive
    multiple of n has lost some (the profiler can drop records of a
    short trace): it is taken again, up to `tries` times, then None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("device_ms traces a CUDA card; none is available")
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == DeviceType.CUDA]
        if us and len(us) % n == 0:
            return sum(us) / 1e3 / n
    return None


# host calls that put work on the card: kernel launches (the entry
# points of the CUDA runtime and of the CUDA driver API) and graph launches
KERNEL_LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cuLaunchKernelEx")
GRAPH_LAUNCH_API = "cudaGraphLaunch"
# host calls that wait for the card: the synchronisations and the
# blocking copy
HOST_WAIT_APIS = ("cudaStreamSynchronize", "cudaEventSynchronize",
                  "cudaDeviceSynchronize", "cudaMemcpy")


def host_calls(events) -> dict[str, int]:
    """Counts of the host's calls to the CUDA runtime among torch.profiler
    events: "kernel" (KERNEL_LAUNCH_APIS), "graph" (cudaGraphLaunch),
    "memcpy" (cudaMemcpyAsync) and "wait" (HOST_WAIT_APIS)."""
    out = {"kernel": 0, "graph": 0, "memcpy": 0, "wait": 0}
    for e in events:
        if e.name in KERNEL_LAUNCH_APIS:
            out["kernel"] += 1
        elif e.name == GRAPH_LAUNCH_API:
            out["graph"] += 1
        elif e.name == "cudaMemcpyAsync":
            out["memcpy"] += 1
        elif e.name in HOST_WAIT_APIS:
            out["wait"] += 1
    return out


# the device kernel of torch.cuda._sleep, launches' padding
PAD_KERNEL = "spin_kernel"


def launches(fn, traces: int = 3, pad: int = 0
             ) -> tuple[dict[str, int], list[str]]:
    """The host's launch calls (host_calls) and the names of the device
    activities of one fn() call, from torch.profiler, after one warm-up
    call. The profiler can drop records of a short trace (now and then a
    trace comes back empty, or without one of two kernels), and it never
    adds one: fn() is traced `traces` times and the trace with the most
    device activities is returned (the first of those). With `pad`, each
    trace also holds that many short spin kernels (torch.cuda._sleep)
    queued after fn() and left out of what is returned, so that fn()'s
    records are not the trace's last."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("launches traces a CUDA card; none is available")
    fn()
    torch.cuda.synchronize()
    best = ({}, [])
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            for _ in range(pad):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        events = sorted(prof.events(), key=lambda e: e.time_range.start)
        names = [e.name for e in events if e.device_type == DeviceType.CUDA
                 and not (pad and PAD_KERNEL in e.name)]
        if len(names) > len(best[1]):
            calls = host_calls(events)
            calls["kernel"] -= pad
            best = (calls, names)
    return best
