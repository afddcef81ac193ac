"""The native finalize's extend phase (chain2aln's ksw_extend2 calls and
sort_dedup_patch) as a share of the window: the extend_ns counter of the
program's finalize.native spans."""

from portbench.metrics import _program

install = _program.install


def read(ctx):
    return _program.counter_share(ctx, "finalize.native", "extend_ns")
