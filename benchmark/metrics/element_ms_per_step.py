"""Device ms a step of the form layer's element kernels: the device
activities whose names hold "ns_cell_" (the cell kernels and their
fused facet variants), summed over the traced steps, over the steps."""


def read(ctx):
    if ctx.trace is None or not ctx.trace_steps:
        return None
    s = sum(sec for name, (_, sec) in ctx.trace["device_ops"].items()
            if "ns_cell_" in name)
    return s * 1e3 / len(ctx.trace_steps) if s > 0 else None
