"""One reader a metric, named as BENCHMARK.json names the metric.

Each module defines read(ctx) -> float | None: the metric's value from
the run's context (benchmark/run.py: Context), or None where the run
holds nothing to read, and the harness then leaves the metric out."""
