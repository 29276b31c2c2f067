"""dense_shuffle_roofline: the dense tier's shuffle route
(``parallel/mesh_exec.py``: each part's sparse sort-reduce into pairs and
their scatter into [K] tables, torch ops, then one copy of the tables),
percent of the HBM bound of its queries' bytes over all device time inside
those queries."""

from harness.roofline import share


def read(ctx):
    return share(ctx, "dense_shuffle_roofline")
