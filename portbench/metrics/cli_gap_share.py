"""The CLI's share of the window: the main thread's time outside
process_seqs (waiting on the reader thread's next chunk, handing a
chunk to the writer, the chunk hook)."""

import numpy as np

from portbench.metrics._shares import share
from portbench.trace import minus


def read(ctx):
    ps = ctx.trace.span("process_seqs")
    if len(ps) == 0:
        return None
    return share(ctx, minus(np.array([[ctx.t0, ctx.t1]]), ps))
