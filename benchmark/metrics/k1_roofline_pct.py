"""K1, the conservative pair law: its least time on the card (the law's
operations and bytes in the slice, ``roofline/pair_law.py``, against the
card's peaks) over the device time of its kernel in the slice, in %."""

from benchmark.metrics import law_roofline


def read(ctx):
    return law_roofline(ctx, conservative=True,
                        kernel="pair_conservative_kernel")
