"""Host ms of the Krylov layer's own work an FGMRES iteration: the
program's ksp spans (each fgmres call of Newton) over the traced steps,
less the ksp.wait spans inside them (the host waiting on the card's
reads) and the pc.capture, pc_setup and pc.refit spans inside them (a
rebuild's graph capture and, without pc_lag_steps, the PC set-up at its
first application, which build_ms_per_rebuild counts), over the counter
ksp_iters there (benchmark/spans.py)."""

from benchmark.spans import traced


def read(ctx):
    tr = traced(ctx)
    if tr is None or tr.total("ksp_iters") == 0:
        return None
    return (tr.self_ms("ksp", ("ksp.wait", "pc.capture", "pc_setup",
                               "pc.refit"))
            / tr.total("ksp_iters"))
