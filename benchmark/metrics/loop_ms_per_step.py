"""The scenario loop's own time a step: the step's callback-to-callback
wall time less the span around solver.solveStep, averaged over the
window's untraced steps, in ms."""


def read(ctx):
    s = [x for x in ctx.steps if not x["traced"]]
    if not s:
        return None
    return sum(x["wall_s"] - x["solve_s"] for x in s) / len(s) * 1e3
