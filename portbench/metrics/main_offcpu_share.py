"""The time main_mem's thread spent in process_seqs off its core (its
wall time less the thread's CPU time: waits for the GIL, for the card, for
a core), as a share of the window."""

from portbench.metrics import _program

install = _program.install


def read(ctx):
    ps = _program.named(ctx, "process_seqs")
    ids = {s.id for s in ps}
    outer = [s for s in ps if s.parent not in ids]
    if not outer:
        return None
    off = sum((s.wall_s - s.cpu_s) * _program.inside(ctx, s) for s in outer)
    return 100.0 * off / (ctx.t1 - ctx.t0)
