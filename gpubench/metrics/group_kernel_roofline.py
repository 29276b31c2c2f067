"""group_kernel_roofline: K1-K4 (``csrc/agg.cu``'s ``group_kernel``
template, launched by ``ops/agg_kernels.py``), percent of the HBM bound of
their queries' bytes over the profiled time of every ``group_kernel``."""

from harness.roofline import share


def read(ctx):
    return share(ctx, "group_kernel_roofline", kernel="group_kernel")
