"""The share of the traced steps' wall time in which no device activity
ran: 1 - busy / wall, in %."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr["device_activities"] or not tr["wall_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["wall_s"])
