"""The native finalize's rescue phase (mem_matesw's ksw_align2 calls) as
a share of the window: the rescue_ns counter of the program's
finalize.native spans."""

from portbench.metrics import _program

install = _program.install


def read(ctx):
    return _program.counter_share(ctx, "finalize.native", "rescue_ns")
