"""Kernel and graph launches from the host (cudaLaunchKernel and its
kin, cudaGraphLaunch) in the traced steps over their Krylov
iterations."""


def read(ctx):
    if ctx.trace is None or not ctx.trace["device_activities"]:
        return None
    ksp = sum(x["ksp"] for x in ctx.trace_steps)
    calls = ctx.trace["host_calls"]
    return (calls["kernel"] + calls["graph"]) / ksp if ksp else None
