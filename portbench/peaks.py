"""Published peaks of one NVIDIA H100 SXM (data sheet, 700 W) and the
roofline bound of a kernel's work against them."""

HBM_BYTES_PER_S = 3.35e12
# INT32 lanes: 64 a SM x 132 SMs x 1.98 GHz boost
INT_OPS_PER_S = 64 * 132 * 1.98e9


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the work could take: its bytes at the memory rate or
    its integer operations at the INT32 rate, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S)


def roofline(bounds_s: float, kernel_s: float):
    """Share (%) of the roofline: the summed bound over the summed kernel
    time; None when no kernel ran."""
    if kernel_s <= 0:
        return None
    return 100.0 * bounds_s / kernel_s
