"""Kernel B1's share of its roofline: the bound of every B1 call the
window's units ask for (the iterations without labels, each solve's label
pass; ``cost.lloyd_cost`` at the call's shape) over B1's device time in the
trace."""

LAYER = "kernel B1"
KERNELS = ("lloyd_wgmma_kernel", "lloyd_general_kernel", "lloyd_small_kernel")


def read(ctx):
    return ctx.roofline("b1", KERNELS)
