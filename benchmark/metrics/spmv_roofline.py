"""The outer Jacobian's matvec (kernel K1) against its memory bound.

After the window, on the window's last operator, y = A x is launched
many times back to back under torch.profiler; the time is the union of
the device activities' intervals in that trace (the kernels' own time,
whatever the host's launch pace), a launch's share of it. The bound
counts the bytes that the node-block sparsity itself needs
(benchmark/peaks.py: spmv_bytes, from the benchmark's mesh), whatever
layout the program stores, at the card's HBM bandwidth; the share is
bound / time, in %.
"""

WARMUP = 10
LAUNCHES = 200


def outer_operator(solver):
    """y = A x of the solver's outer Jacobian as the window left it, and
    the length of x; None where the solver holds no operator. The one
    place the benchmark reaches into the solver for this metric."""
    state = getattr(solver, "_op_state", None)
    nodebsr = getattr(solver, "_nodebsr", None)
    if state is None or nodebsr is None:
        return None
    vals = state["vals"]
    n = nodebsr.n_nodes * nodebsr.bs
    return (lambda x: nodebsr.apply_element_matrices(vals, (), x)), n


def read(ctx):
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from benchmark.peaks import HBM_BYTES_PER_S, spmv_bytes
    from benchmark.tracewin import busy_time

    if ctx.device.type != "cuda" or ctx.solver is None:
        return None
    op = outer_operator(ctx.solver)
    if op is None:
        return None
    apply, n = op
    g = torch.Generator(device=ctx.device).manual_seed(0)
    x = torch.rand(n, generator=g, device=ctx.device,
                   dtype=ctx.solver.dtype)
    for _ in range(WARMUP):
        apply(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(LAUNCHES):
            apply(x)
        torch.cuda.synchronize()
    iv = [(e.time_range.start, e.time_range.end) for e in prof.events()
          if e.device_type == DeviceType.CUDA]
    if not iv:
        return None
    seconds = busy_time(iv) / 1e6 / LAUNCHES
    item = np.dtype(ctx.config["dtype"]).itemsize
    nbytes = spmv_bytes(ctx.mesh["cells"], len(ctx.mesh["points"]), 3, item)
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
