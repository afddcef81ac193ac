"""The card's idle share of a `mem` window: the window less the union of
its kernels, copies and fills (torch.profiler's CUDA activity)."""

from portbench.trace import clip, total


def read(ctx):
    busy = total(clip(ctx.trace.busy(), ctx.t0, ctx.t1))
    return 100.0 * (1.0 - busy / (ctx.t1 - ctx.t0))
