"""The SA lookup's time per step of the sampled-SA walk: the program's
sa_lookup spans (FMIndex.sa_lookup, bsw2.cpp fm_sa_batch) over their
walk_steps counters, in ns; None when no span walked a step (the dense
sidecar, or a program without the tracer)."""

from portbench.metrics import _program

install = _program.install


def read(ctx):
    ns = steps = 0.0
    for s in _program.named(ctx, "sa_lookup"):
        f = _program.inside(ctx, s)
        ns += s.wall_s * 1e9 * f
        steps += s.counters.get("walk_steps", 0) * f
    return ns / steps if steps > 0 else None
