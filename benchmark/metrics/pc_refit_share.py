"""The share of the traced rebuilds whose preconditioner was refitted in
place into the one the solver already holds (the program's counter
pc_refits), not made and captured anew, over its counter rebuilds there
(benchmark/spans.py), in %. None where the traced steps rebuilt
nothing, and on a program without a preconditioner slot
(cfdtpu_torch.la.schur.PrecondSlot), which refits nothing."""

from benchmark.spans import traced


def read(ctx):
    try:
        from cfdtpu_torch.la.schur import PrecondSlot  # noqa: F401
    except ImportError:
        return None
    tr = traced(ctx)
    if tr is None or tr.total("rebuilds") == 0:
        return None
    return 100.0 * tr.total("pc_refits") / tr.total("rebuilds")
