"""Median wall time of the window's untraced steps that rebuilt the
operator and the preconditioner (the calls of the solver's
_build_op_state, counted by the harness's wrapper), in ms."""

import statistics


def read(ctx):
    s = [x["wall_s"] for x in ctx.steps if x["rebuilt"] and not x["traced"]]
    return statistics.median(s) * 1e3 if s else None
