"""The outer Jacobian's matvec (kernel K1) against its memory bound.

After the window, on the window's last operator, y = A x is launched
many times back to back under torch.profiler; the time is the union of
the device activities' intervals in that trace (the kernels' own time,
whatever the host's launch pace), a launch's share of it. The bound
counts the bytes that the node-block sparsity itself needs
(benchmark/peaks.py: spmv_bytes, from the benchmark's mesh, with blocks
of d + 1 unknowns a node in d dimensions), whatever layout the program
stores, at the card's HBM bandwidth; the share is bound / time, in %.
Where the solver carries no operator between steps (pc_lag_steps 1
builds one in each Newton iteration and keeps none), the operator is
the Jacobian that the program builds at the window's last state: the
same sparsity and the same work.
"""

WARMUP = 10
LAUNCHES = 200


def outer_operator(solver):
    """y = A x of the solver's outer Jacobian as the window left it (or,
    where the solver carries none, as the program builds it at the
    window's last state), and the length of x; None where the solver
    has no node-block operator. The one place the benchmark reaches into
    the solver for this metric."""
    state = getattr(solver, "_op_state", None)
    nodebsr = getattr(solver, "_nodebsr", None)
    if nodebsr is None:
        return None
    if state is None:
        vals = nodebsr.assemble(*solver.form.element_jacobians(
            solver.u_sol, solver.p_sol, solver._aux(), solver.params()))
    else:
        vals = state["vals"]
    n = nodebsr.n_nodes * nodebsr.bs
    return (lambda x: nodebsr.apply_element_matrices(vals, (), x)), n


def node_block_bytes(mesh, itemsize: int) -> int:
    """The bound's bytes on a benchmark mesh: blocks of d + 1 unknowns a
    node, d the width of its points."""
    from benchmark.peaks import spmv_bytes

    return spmv_bytes(mesh["cells"], len(mesh["points"]),
                      mesh["points"].shape[1] + 1, itemsize)


def read(ctx):
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from benchmark.peaks import HBM_BYTES_PER_S
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
    nbytes = node_block_bytes(ctx.mesh,
                              np.dtype(ctx.config["dtype"]).itemsize)
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
