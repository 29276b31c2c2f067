"""Device compute kernels.

- ``kernels``: plain PyTorch tensor kernels of the generic operator DAG —
  predicate masks, projection arithmetic, exact sort-based group
  aggregation, distinct, sort/take.
- ``fused``: scatter formulations of the fused filter + group-aggregate
  (the plain versions of the hand-written kernels).
- ``agg_kernels``: the hand-written CUDA kernels of the compiled serving
  path (``csrc/agg.cu``), with their wrappers and launch counters.
"""

from . import kernels  # noqa: F401
