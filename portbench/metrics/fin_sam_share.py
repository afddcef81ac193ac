"""The native finalize's sam phase (reg2aln, gen_cigar2's ksw_global2
calls and the SAM text) as a share of the window: the sam_ns counter of
the program's finalize.native spans."""

from portbench.metrics import _program

install = _program.install


def read(ctx):
    return _program.counter_share(ctx, "finalize.native", "sam_ns")
