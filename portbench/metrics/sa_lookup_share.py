"""The SA lookup's time (FMIndex.sa_lookup: the dense sidecar, or the
sampled-SA walk on the host) as a share of the window."""

from portbench.metrics._shares import self_time, share


def read(ctx):
    return share(ctx, self_time(ctx, "sa_lookup"))
