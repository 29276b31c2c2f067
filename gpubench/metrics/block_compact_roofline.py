"""block_compact_roofline: K6 (``csrc/compact.cu``'s
``block_compact_kernel``), percent of the HBM bound of the scans' selection
planes and selected positions over the profiled time of every launch."""

from harness.roofline import share


def read(ctx):
    return share(ctx, "block_compact_roofline", kernel="block_compact_kernel")
