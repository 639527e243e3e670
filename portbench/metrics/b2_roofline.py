"""Kernel B2's share of its roofline: the bound of each decision's
bisection calls (``cost.seg_count_cost`` with the global table) over B2's
device time in the trace."""

LAYER = "kernel B2"
KERNELS = ("seg_small_kernel", "seg_slice_kernel")


def read(ctx):
    return ctx.roofline("b2", KERNELS)
