"""Time steps completed in the window over the window's wall time, which
ends in torch.cuda.synchronize()."""


def read(ctx):
    if not ctx.steps or not ctx.window_s:
        return None
    return len(ctx.steps) / ctx.window_s
