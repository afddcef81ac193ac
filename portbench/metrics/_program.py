"""The program's own spans (bwa_tpu_torch.tracing) in a traced run.

install() switches the program's tracer on; spans(ctx) drains it once,
after the window, and keeps the spans on ctx, their times in seconds on
the clock of ctx.t0 and ctx.t1 (time.perf_counter's).  A span that
straddles an edge of the window counts in proportion to its part inside
(inside()).  A program without the tracer gives no spans, and the readers
of this helper None."""

from __future__ import annotations

from types import SimpleNamespace


def install(_spans) -> None:
    try:
        from bwa_tpu_torch import tracing
    except ImportError:
        return
    tracing.enable()


def spans(ctx) -> list:
    """The program's spans, drained once per ctx: each with name, thread,
    id, parent, chunk, counters, t0, t1 (s), wall_s and cpu_s (the
    thread's CPU time over it)."""
    got = getattr(ctx, "program_spans", None)
    if got is None:
        try:
            from bwa_tpu_torch import tracing
        except ImportError:
            got = []
        else:
            got = [SimpleNamespace(
                name=s.name, thread=s.thread, id=s.id, parent=s.parent,
                chunk=s.chunk, counters=dict(s.counters),
                t0=s.t0 * 1e-9, t1=s.t1 * 1e-9, wall_s=(s.t1 - s.t0) * 1e-9,
                cpu_s=(s.cpu1 - s.cpu0) * 1e-9) for s in tracing.drain()]
        ctx.program_spans = got
    return got


def named(ctx, name: str) -> list:
    return [s for s in spans(ctx) if s.name == name]


def inside(ctx, s) -> float:
    """The share of span s inside the window."""
    if s.t1 <= s.t0:
        return 1.0 if ctx.t0 <= s.t0 <= ctx.t1 else 0.0
    return max(0.0, min(s.t1, ctx.t1) - max(s.t0, ctx.t0)) / (s.t1 - s.t0)


def counter_share(ctx, name: str, key: str):
    """100 x the window's part of the ns counter `key` of the spans `name`
    over the window, or None when no such span carries the counter."""
    hits = [s for s in named(ctx, name) if key in s.counters]
    if not hits:
        return None
    v = sum(s.counters[key] * inside(ctx, s) for s in hits) * 1e-9
    return 100.0 * v / (ctx.t1 - ctx.t0)


def innermost(ctx, t: float):
    """The innermost span open at time t on main_mem's thread (the one
    that ran process_seqs), or None."""
    ps = named(ctx, "process_seqs")
    thread = ps[0].thread if ps else None
    best = None
    for s in spans(ctx):
        if s.thread == thread and s.t0 <= t < s.t1 and (
                best is None or s.t0 >= best.t0):
            best = s
    return best


def idle_gaps(ctx, n: int = 10) -> list:
    """The window's n longest gaps in the card's activity, each as
    [innermost program span at its middle (or "none"), seconds]."""
    import numpy as np

    from portbench.trace import clip, minus

    gaps = minus(np.array([[ctx.t0, ctx.t1]]),
                 clip(ctx.trace.busy(), ctx.t0, ctx.t1))
    longest = gaps[np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")][:n]
    out = []
    for s, e in longest:
        sp = innermost(ctx, (s + e) / 2)
        out.append([sp.name if sp is not None else "none", float(e - s)])
    return out
