"""Krylov iterations a step: solver.step_stats["ksp_iters"] summed over
the window's steps, over the steps."""


def read(ctx):
    if not ctx.steps:
        return None
    return sum(x["ksp"] for x in ctx.steps) / len(ctx.steps)
