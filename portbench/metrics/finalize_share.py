"""The C++ finalize's self time (chain, extend, pair, SAM text; K2's
extensions run inside it) as a share of the window."""

from portbench.metrics._shares import self_time, share


def read(ctx):
    return share(ctx, self_time(ctx, "finalize", "sa_lookup"))
