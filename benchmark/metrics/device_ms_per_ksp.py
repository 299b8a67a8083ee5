"""Device-busy ms in the traced steps (the union of the device
activities' intervals) over their Krylov iterations."""


def read(ctx):
    if ctx.trace is None or not ctx.trace["device_activities"]:
        return None
    ksp = sum(x["ksp"] for x in ctx.trace_steps)
    return ctx.trace["busy_s"] * 1e3 / ksp if ksp else None
