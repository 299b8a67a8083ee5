"""Host ms a rebuild of the operator and the preconditioner costs: the
program's spans build (the Jacobian, its assembly and the PC set-up),
release (dropping the previous state, its CUDA graphs and their pools)
and pc.capture (the new state's preconditioner captured as a CUDA
graph at its first application) over the traced steps, with the
spans pc_setup and pc.refit that lie outside build (without
pc_lag_steps the solver sets the PC up at its first application, inside
ksp), over the program's counter rebuilds there (benchmark/spans.py)."""

from benchmark.spans import traced


def read(ctx):
    tr = traced(ctx)
    if tr is None or tr.total("rebuilds") == 0:
        return None
    return (tr.host_ms("build", "release", "pc.capture")
            + tr.outside_ms(("pc_setup", "pc.refit"), "build")
            ) / tr.total("rebuilds")
