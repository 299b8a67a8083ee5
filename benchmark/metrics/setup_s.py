"""From process start to the window's first step: imports, the kernel
library, the mesh, the solver's set-up and the warm-up steps."""


def read(ctx):
    return ctx.setup_s
