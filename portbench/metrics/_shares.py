"""Helpers of the per-layer readers: a layer's self time as a share of
the window, from the traced run's spans (portbench/trace.py)."""

from portbench.trace import clip, minus, total, union


def share(ctx, intervals):
    """Percent of the window that the intervals cover, or None when the
    layer ran no span in the traced run."""
    if intervals is None:
        return None
    return 100.0 * total(clip(union(intervals), ctx.t0, ctx.t1)) \
        / (ctx.t1 - ctx.t0)


def self_time(ctx, layer, *children):
    """The layer's spans less its children's (span names or interval
    arrays); None when the layer has none."""
    iv = ctx.trace.span(layer)
    if len(iv) == 0:
        return None
    for c in children:
        iv = minus(iv, ctx.trace.span(c) if isinstance(c, str) else c)
    return iv
