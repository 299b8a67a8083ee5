"""The card's wasted Krylov work: FGMRES lookahead iterations queued and
then discarded (the program's counter ksp_discarded) per hundred
iterations used (ksp_iters), over the traced steps (benchmark/spans.py),
in %."""

from benchmark.spans import traced


def read(ctx):
    tr = traced(ctx)
    if tr is None or tr.total("ksp_iters") == 0:
        return None
    return 100.0 * tr.total("ksp_discarded") / tr.total("ksp_iters")
