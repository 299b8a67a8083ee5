"""The 95th percentile (linear interpolation between order statistics)
of the wall time of every step in the window, each timed on the host
between consecutive step callbacks."""

import numpy as np


def read(ctx):
    if not ctx.steps:
        return None
    return float(np.percentile([s["wall_s"] for s in ctx.steps], 95)) * 1e3
