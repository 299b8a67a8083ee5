"""The traced sub-window: torch.profiler over a run of whole steps, read
into device busy time, idle share, device time by kernel name, the
host's launch calls and the breakdown of the result line.

The arithmetic is the benchmark's own copy of chip_smoke.py's
StepProfile and of utils/cudatime.host_calls, so that a change to the
program cannot change the yardstick: device busy time is the union of
the device activities' intervals, and the idle share is 1 - busy / wall.
"""

from __future__ import annotations

import time

# host calls that put work on the card, and those that wait for it
KERNEL_LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cuLaunchKernelEx")
GRAPH_LAUNCH_API = "cudaGraphLaunch"
HOST_WAIT_APIS = ("cudaStreamSynchronize", "cudaEventSynchronize",
                  "cudaDeviceSynchronize", "cudaMemcpy")
TOP = 10  # entries of each breakdown list
LABELLED_GAPS = 500  # the longest idle gaps, labelled by the host's op


def host_calls(events) -> dict[str, int]:
    """Counts of the host's CUDA runtime calls among profiler events."""
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


def merge_intervals(iv):
    """Union of (start, end) intervals, sorted: [(start, end), ...]."""
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def busy_time(iv) -> float:
    """Length of the union of the intervals."""
    return sum(b - a for a, b in merge_intervals(iv))


def gaps(iv, t0=None, t1=None):
    """The idle gaps between merged intervals (and from t0 to the first,
    from the last to t1): [(start, end), ...]."""
    merged = merge_intervals(iv)
    out = []
    prev = t0
    for a, b in merged:
        if prev is not None and a > prev:
            out.append((prev, a))
        prev = b if prev is None else max(prev, b)
    if t1 is not None and prev is not None and t1 > prev:
        out.append((prev, t1))
    return out


def label_gaps(host, gap_list):
    """What the host was doing in each gap: the innermost host op that
    covers the gap's midpoint, else "host_untraced" (Python or NumPy work
    that records no op). host: [(start, end, name)]."""
    import numpy as np

    if not host:
        return ["host_untraced"] * len(gap_list)
    s = np.array([h[0] for h in host], dtype=np.float64)
    e = np.array([h[1] for h in host], dtype=np.float64)
    dur = e - s
    out = []
    for a, b in gap_list:
        mid = 0.5 * (a + b)
        cover = np.flatnonzero((s <= mid) & (e >= mid))
        out.append(host[cover[np.argmin(dur[cover])]][2] if cover.size
                   else "host_untraced")
    return out


class Profile:
    """start() before the first traced step, stop() after the last; the
    result is read once the window has closed (read())."""

    def __init__(self):
        self.prof = None
        self.wall_s = 0.0
        self._t0 = 0.0

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)

    def read(self) -> dict:
        """busy_s, wall_s, device ops {name: [calls, seconds]}, host calls,
        idle gaps by host label {label: seconds}."""
        from torch.autograd import DeviceType

        events = self.prof.events()
        dev = [(e.time_range.start, e.time_range.end, e.name)
               for e in events if e.device_type == DeviceType.CUDA]
        host = [(e.time_range.start, e.time_range.end, e.name)
                for e in events if e.device_type != DeviceType.CUDA]
        ops: dict[str, list] = {}
        for a, b, n in dev:
            slot = ops.setdefault(n, [0, 0.0])
            slot[0] += 1
            slot[1] += (b - a) / 1e6
        iv = [(a, b) for a, b, _ in dev]
        t0 = min((s for s, _, _ in host), default=None)
        t1 = max((e for _, e, _ in host), default=None)
        longest = sorted(gaps(iv, t0, t1), key=lambda g: g[0] - g[1])[
            :LABELLED_GAPS]
        idle: dict[str, float] = {}
        for (a, b), lab in zip(longest, label_gaps(host, longest)):
            idle[lab] = idle.get(lab, 0.0) + (b - a) / 1e6
        return {"busy_s": busy_time(iv) / 1e6, "wall_s": self.wall_s,
                "device_ops": ops, "host_calls": host_calls(events),
                "idle_by_host": idle, "device_activities": len(dev)}


def breakdown(result: dict) -> dict:
    """The result line's breakdown: the device ops that took most time
    and the idle gaps summed by what the host was doing, TOP each."""
    ops = sorted(result["device_ops"].items(), key=lambda kv: -kv[1][1])
    idle = sorted(result["idle_by_host"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n[:120], s] for n, (_, s) in ops[:TOP]],
            "idle_gaps": [[n[:120], s] for n, s in idle[:TOP]]}
