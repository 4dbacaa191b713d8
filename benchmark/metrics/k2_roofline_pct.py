"""K2, the geometric pair law: its least time on the card (the law's
operations and bytes in the slice, summed over the ranks) over the device
time of its kernel in the slice, summed over the ranks, in %."""

from benchmark.metrics import law_roofline


def read(ctx):
    return law_roofline(ctx, conservative=False,
                        kernel="pair_geometric_kernel")
