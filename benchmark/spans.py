"""The program's own spans and counters over the traced steps, for the
per-layer metrics that read them.

In a --trace 1 run the program (cfdtpu_torch.utils.trace) records spans
and counters on exactly the steps over which torch.profiler records: its
time loop switches tracing on at the top of each iteration in which a
profiler is recording. traced(ctx) reads that store. It gives None
where the program has no trace module, or where the store does not hold
exactly one `step` span for each of the run's traced steps
(ctx.trace_steps), so a reader never reports what it cannot match to
the traced window.
"""

from __future__ import annotations


class Traced:
    """The traced steps' spans (cfdtpu_torch.utils.trace.Span) and the sum
    of their counters' deltas."""

    def __init__(self, spans, totals, n_steps):
        self.spans = spans
        self.totals = totals
        self.n_steps = n_steps
        self.by_id = {s.id: s for s in spans}

    def total(self, name: str) -> int:
        return self.totals.get(name, 0)

    def host_ms(self, *names: str) -> float:
        """Host ms in the spans of these names, summed."""
        return sum(s.t1_ns - s.t0_ns for s in self.spans
                   if s.name in names) / 1e6

    def outside_ms(self, names: tuple[str, ...], of: str) -> float:
        """Host ms in the spans of these names that lie inside no span
        called `of` (at any depth)."""
        return sum(s.t1_ns - s.t0_ns for s in self.spans
                   if s.name in names and not self._inside(s, of)) / 1e6

    def self_ms(self, name: str, less: tuple[str, ...]) -> float:
        """Host ms in the spans called `name`, less the time of the spans
        called one of `less` that lie inside them (at any depth)."""
        inner = 0
        for s in self.spans:
            if s.name in less and self._inside(s, name):
                inner += s.t1_ns - s.t0_ns
        return self.host_ms(name) - inner / 1e6

    def _inside(self, s, name: str) -> bool:
        p = s.parent
        while p is not None:
            ps = self.by_id.get(p)
            if ps is None:
                return False
            if ps.name == name:
                return True
            p = ps.parent
        return False


def traced(ctx) -> Traced | None:
    try:
        from cfdtpu_torch.utils import trace
    except ImportError:
        return None
    n = len(getattr(ctx, "trace_steps", None) or [])
    if n == 0:
        return None
    rec = trace.records()
    ids = [s.step for s in rec["spans"] if s.name == "step"]
    if len(ids) != n or len(set(ids)) != n:
        return None
    steps = set(ids)
    totals: dict[str, int] = {}
    for step, deltas in rec["steps"].items():
        if step in steps:
            for name, d in deltas.items():
                totals[name] = totals.get(name, 0) + d
    return Traced([s for s in rec["spans"] if s.step in steps], totals, n)
