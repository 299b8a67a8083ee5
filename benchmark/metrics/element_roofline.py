"""The element kernel (K3 with its facet blocks in its launch) against
its memory bound.

After the window, at the window's last state, the form's residual and
its element Jacobians are built many times back to back under
torch.profiler; the time is the union of the intervals of the device
activities whose names hold "ns_cell_" (the element kernel, whatever its
facet variant; the K2 sums after it are left out), a residual and a
Jacobian build's share of it. The bound counts the bytes that the
element work itself needs (element_bytes, from the benchmark's mesh),
whatever tables the program keeps beside them, at the card's HBM
bandwidth; the share is bound / time, in %.
"""

WARMUP = 5
LAUNCHES = 40
NAME = "ns_cell_"


def element_bytes(mesh, itemsize: int) -> int:
    """Bytes of one residual and one Jacobian launch on a benchmark mesh
    of P1 simplices in d dimensions (nv = d + 1 vertices a cell and d
    vertices a facet, nl = nv (d + 1) unknowns a cell), each input read
    once and each output written once: u, u_prev and p (n (2 d + 1)),
    each cell's int32 vertices, its vertices' coordinates and its size
    h; each boundary facet's int32 velocity and pressure maps and its
    cell's coordinates; the residual's nl values a cell and nv d a facet
    and the Jacobian's nl^2 a cell and a facet. The launch pair reads its
    inputs twice."""
    n, d = mesh["points"].shape
    nc, nv = mesh["cells"].shape
    nf = len(mesh["facets"])
    nl = nv * (d + 1)
    inputs = (n * (2 * d + 1) * itemsize
              + nc * (4 * nv + nv * d * itemsize + itemsize)
              + nf * (2 * 4 * nv + nv * d * itemsize))
    residual = inputs + (nc * nl + nf * nv * d) * itemsize
    jacobian = inputs + (nc + nf) * nl * nl * itemsize
    return residual + jacobian


def read(ctx):
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from benchmark.peaks import HBM_BYTES_PER_S
    from benchmark.tracewin import busy_time

    s = ctx.solver
    if ctx.device.type != "cuda" or s is None:
        return None
    form = getattr(s, "form", None)
    if form is None or not hasattr(s, "_aux"):
        return None
    args = (s.u_sol, s.p_sol, s._aux(), s.params())

    def launch():
        form.residual(*args)
        form.element_jacobians(*args)

    for _ in range(WARMUP):
        launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(LAUNCHES):
            launch()
        torch.cuda.synchronize()
    iv = [(e.time_range.start, e.time_range.end) for e in prof.events()
          if e.device_type == DeviceType.CUDA and NAME in e.name]
    if not iv:
        return None
    seconds = busy_time(iv) / 1e6 / LAUNCHES
    nbytes = element_bytes(ctx.mesh, np.dtype(ctx.config["dtype"]).itemsize)
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
