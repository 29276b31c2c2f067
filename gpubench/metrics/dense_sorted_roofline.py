"""dense_sorted_roofline: the dense tier's sorted route
(``parallel/mesh_exec.py``, torch ops), percent of the HBM bound of its
queries' bytes over all device time inside those queries."""

from harness.roofline import share


def read(ctx):
    return share(ctx, "dense_sorted_roofline")
