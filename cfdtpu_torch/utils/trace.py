"""Spans and counters at the layer boundaries of the time step: the
port's one instrument.

span(name) times a layer's work on the host. With tracing off it returns
one shared object that does nothing, so a span costs the read of a
module-level bool: no allocation, no clock read, no torch.profiler call.
With tracing on it records (name, parent, step, t0_ns, t1_ns) with
time.perf_counter_ns in memory, and while a torch.profiler records it
also opens a profiler range "cfd." + name, so the span lies in the
profiler's host timeline, on the clock of the device activities.
Nothing is written to disk.

The range is torch's fast record function (a C++ context manager, an
operator-scope range), not torch.profiler.record_function: that one
opens a user annotation, which the CUDA profiler mirrors on the device
as a range over every kernel launched inside it, so a trace read for
device activity would count each span's whole extent as busy time.
The fast range lies on the host alone, and costs about a tenth.

Tracing is on while enable() holds and, inside a time loop, for each
iteration at whose top a torch.profiler was recording: begin_step(i)
reads that at the top of every iteration of Scenario.solve, the switch
holds for the whole iteration, and end_loop(), in the loop's finally,
closes the last iteration's record and clears the switch. A profiler
started and stopped between two iterations (in a step callback) gets
spans on exactly its steps; an unprofiled iteration pays one check.

count(name, n) adds to a named counter, always, as a plain integer add.
The kernels' launch counters (COUNTERS, one a kernel wrapper, re-exported
by cfdtpu_torch.kernels) are counters of this module, as are those of
the time step:

    rebuilds       steps that built the operator and the preconditioner
                   anew (every step without pc_lag_steps)
    retries        step attempts repeated after a failed one
    newton_iters   Newton iterations
    ls_trials      line-search trials after the full Newton step
    ksp_iters      FGMRES inner iterations
    ksp_cycles     FGMRES restart cycles
    ksp_discarded  FGMRES lookahead iterations queued and not used
                   (la/gmres.py DISCARDED)
    pc_captures    preconditioner applications captured as CUDA graphs
    pc_replays     replays of those graphs
    pc_refits      builds copied in place into the tensors of a held
                   preconditioner application (la/schur.py PrecondSlot,
                   span pc.refit) instead of a new one made
    cuda_malloc    the caching allocator's cudaMalloc calls in traced
    cuda_free      steps, and its cudaFree calls: num_device_alloc and
                   num_device_free of torch.cuda.memory_stats, read at the
                   step span's entry and exit

The spans in ALLOC_SPANS also read the allocator at their entry and exit
and keep their own deltas (Span.counts), so each cudaFree is put down to
the phase that makes it.

records() returns the closed spans and, for each traced step, the deltas
of its counters; reset() empties the store and zeroes every counter.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

_profiling = torch._C._autograd._profiler_enabled
_host_range = torch._C._profiler._RecordFunctionFast

# spans that read the caching allocator's counts at entry and exit
ALLOC_SPANS = frozenset(("step", "build", "release", "pc.capture"))


class Counter:
    """A named integer count, `.n`, added to in place."""

    __slots__ = ("name", "n")

    def __init__(self, name: str):
        self.name = name
        self.n = 0


_REGISTRY: dict[str, Counter] = {}


def counter(name: str) -> Counter:
    """The counter of that name, made at its first use."""
    c = _REGISTRY.get(name)
    if c is None:
        c = _REGISTRY[name] = Counter(name)
    return c


def count(name: str, n: int = 1) -> None:
    counter(name).n += n


# one a kernel wrapper (cfdtpu_torch/kernels): each call that launches
# adds one; a fused variant or option also counts under its own name
COUNTERS = {
    name: counter(name)
    for name in ("sup_spmv", "sup_spmv_prolong", "bsr_spmv", "ell_sum",
                 "ns_cell_residual_p1", "ns_cell_residual_p1_facet",
                 "ns_cell_jacobian_p1", "ns_cell_jacobian_p1_facet",
                 "ns_cell_residual_p1_tet", "ns_cell_jacobian_p1_tet",
                 "selfp_triple", "patch_spmv", "ras_apply",
                 "amg_prolong", "krylov_cgs", "krylov_lsq",
                 "sup_spmv_cheby", "cheby_update", "krylov_cgs_scaled",
                 "block_jacobi", "block_jacobi_inv", "amg_gcr2",
                 "ns_cell_residual_bdf2_p1", "ns_cell_residual_bdf2_p1_facet",
                 "ns_cell_jacobian_bdf2_p1", "ns_cell_jacobian_bdf2_p1_facet",
                 "ns_cell_residual_curl_p1", "ns_cell_residual_curl_p1_facet",
                 "ns_cell_jacobian_curl_p1", "ns_cell_jacobian_curl_p1_facet",
                 *(f"ns_facet_{term}{jac}_p1{fused}"
                   for term in ("natural", "viscous", "backflow", "weakp",
                                "nitsche", "nitsche_curl", "cbc", "ddn")
                   for jac in ("", "_jac") for fused in ("", "_fused")))
}


def reset_counts() -> None:
    """Zero the kernel launch counters."""
    for c in COUNTERS.values():
        c.n = 0


def counts() -> dict[str, int]:
    """The kernel launch counters."""
    return {name: c.n for name, c in COUNTERS.items()}


class Span(NamedTuple):
    """A closed span. id: its place in the store (spans in the order they
    opened); parent: the id of the span it opened inside, or None; step:
    the time step it ran in, or None outside the time loop; counts: the
    allocator's deltas for an ALLOC_SPANS span on the card, else None."""

    id: int
    name: str
    parent: int | None
    step: int | None
    t0_ns: int
    t1_ns: int
    counts: dict | None


class _Store:
    def __init__(self):
        self.spans: list[list] = []  # [name, parent, step, t0, t1, counts]
        self.stack: list[int] = []
        self.step: int | None = None  # the iteration being traced
        self.before: dict[str, int] = {}  # its counters at its top
        self.steps: dict[int, dict[str, int]] = {}


_store = _Store()
_on = False  # read by span(): on by enable() or for a profiled iteration
_enabled = False


def _allocator():
    """(cudaMalloc calls, cudaFree calls) of the caching allocator so
    far, or None before CUDA is in use."""
    if not torch.cuda.is_initialized():
        return None
    st = torch.cuda.memory.memory_stats_as_nested_dict()
    return st.get("num_device_alloc", 0), st.get("num_device_free", 0)


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "st", "i", "rf", "a0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        st = self.st = _store
        self.i = len(st.spans)
        rec = [self.name, st.stack[-1] if st.stack else None, st.step,
               0, None, None]
        st.spans.append(rec)
        st.stack.append(self.i)
        self.a0 = _allocator() if self.name in ALLOC_SPANS else None
        self.rf = None
        if _profiling():
            self.rf = _host_range("cfd." + self.name)
            self.rf.__enter__()
        rec[3] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        st = self.st
        rec = st.spans[self.i]
        rec[4] = t1
        if st.stack and st.stack[-1] == self.i:
            st.stack.pop()
        if self.a0 is not None:
            a1 = _allocator()
            rec[5] = {"cuda_malloc": a1[0] - self.a0[0],
                      "cuda_free": a1[1] - self.a0[1]}
            if self.name == "step":
                count("cuda_malloc", rec[5]["cuda_malloc"])
                count("cuda_free", rec[5]["cuda_free"])
        return False


def span(name: str):
    """A context manager around one layer's work; see the module's
    docstring."""
    if not _on:
        return _NO_SPAN
    return _Span(name)


def _snapshot() -> dict[str, int]:
    return {name: c.n for name, c in _REGISTRY.items()}


def _close_step() -> None:
    st = _store
    b = st.before
    st.steps[st.step] = {name: n - b.get(name, 0)
                         for name, n in _snapshot().items()
                         if n != b.get(name, 0)}
    st.step = None


def begin_step(i: int) -> None:
    """At the top of each iteration of a time loop, before step i: closes
    the previous iteration's record and switches tracing on for this
    iteration if enable() holds or a torch.profiler records."""
    global _on
    if _store.step is not None:
        _close_step()
    _on = _enabled or _profiling()
    if _on:
        _store.step = int(i)
        _store.before = _snapshot()


def end_loop() -> None:
    """In the time loop's finally: closes the last iteration's record and
    leaves tracing on only if enable() holds."""
    global _on
    if _store.step is not None:
        _close_step()
    _on = _enabled


def enable() -> None:
    """Trace everything until disable(), set-up and steps alike."""
    global _on, _enabled
    _enabled = _on = True


def disable() -> None:
    global _on, _enabled
    _enabled = _on = False


def reset() -> None:
    """Empty the store and zero every counter."""
    global _store
    _store = _Store()
    for c in _REGISTRY.values():
        c.n = 0


def records() -> dict:
    """{"spans": [Span, ...] (the closed ones, in the order they opened),
    "steps": {step: {counter: delta}} (each traced step's counters that
    moved, over its whole iteration)}."""
    st = _store
    spans = [Span(i, r[0], r[1], r[2], r[3], r[4], r[5])
             for i, r in enumerate(st.spans) if r[4] is not None]
    return {"spans": spans,
            "steps": {k: dict(v) for k, v in st.steps.items()}}
