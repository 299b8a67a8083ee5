"""The caching allocator's cudaMalloc and cudaFree calls a traced step:
the program's counters cuda_malloc and cuda_free (its reads of
torch.cuda.memory_stats at each step span's entry and exit) over the
traced steps (benchmark/spans.py); None off the card."""

from benchmark.spans import traced


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    tr = traced(ctx)
    if tr is None:
        return None
    return (tr.total("cuda_malloc") + tr.total("cuda_free")) / tr.n_steps
