"""Seeding's self time (trip order, lane packing, K1's wrappers, demux)
as a share of the window: its spans less the SA lookup's and less the
card's activity inside them."""

from portbench.metrics._shares import self_time, share


def read(ctx):
    return share(ctx, self_time(ctx, "seed", "sa_lookup", ctx.trace.busy()))
