"""Distributed filter + two-phase aggregation over a device mesh (reference:
frostdb_tpu/parallel/distributed.py).

The per-shard stage is the reference's non-final HashAggregate
(aggregate.go:124); the cross-shard combine is a ``psum`` over the mesh
(collectives.py) instead of the Synchronizer barrier (synchronize.go:16).
Group keys are dense dictionary codes (table-global dictionaries make
codes comparable across shards, columnbatch.py), so the partial state is a
dense [K] table per aggregation.

For group spaces too large for a dense table the rows repartition by key
first (shuffle.py).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..ops import kernels as K
from . import collectives as C
from .mesh import PartitionedTable


def combine_codes(codes_and_sizes: Sequence[tuple[torch.Tensor, int]]):
    """Combine multiple small code spaces into one dense code:
    code = c1*K2*K3... + c2*K3 + ... Returns (codes, K_total)."""
    code = None
    k_total = 1
    for c, k in codes_and_sizes:
        c = c.to(torch.int32)
        code = c if code is None else code * k + c
        k_total *= k
    return code, k_total


_COMBINE = {K.AGG_SUM: C.psum, K.AGG_COUNT: C.psum, K.AGG_MIN: C.pmin}


def distributed_filter_aggregate(
    table: PartitionedTable,
    group_col: str,
    num_codes: int,
    agg_specs: Sequence[tuple[str, str]],  # (op, value column)
    filter_col: str | None = None,
    filter_op: str = ">=",
    filter_literal=0,
):
    """Distributed query step: filter + group-by-aggregate.

    Returns a zero-arg callable producing dense [num_codes] tensors (one
    per agg spec) plus the per-code row counts, each the combined
    (replicated) result, on shard 0's device."""
    gcol = table.column(group_col)
    fcol = table.column(filter_col) if filter_col is not None else None
    vcols = [table.column(vc) for _op, vc in agg_specs]

    def run():
        outs: list = [[] for _ in agg_specs]
        counts = []
        for s in C.axis_index(table.n_shards):
            # Padding rows have validity False on every column, so the
            # group column's validity is the padding indicator.
            sel = gcol.validity[s]
            if fcol is not None:
                fvalid = fcol.validity[s]
                sel = sel & fvalid & K.compare_scalar_mask(
                    fcol.data[s], fvalid, filter_literal, filter_op
                )
            codes = gcol.data[s].to(torch.int32)
            for j, ((op, _vc), c) in enumerate(zip(agg_specs, vcols)):
                outs[j].append(
                    K.dense_group_reduce(codes, c.data[s], sel, num_codes, op)
                )
            counts.append(
                K.dense_group_reduce(codes, None, sel, num_codes, K.AGG_COUNT)
            )
        totals = tuple(
            _COMBINE.get(op, C.pmax)(partials)[0]
            for (op, _vc), partials in zip(agg_specs, outs)
        )
        return totals, C.psum(counts)[0]

    return run


def distributed_distinct(table: PartitionedTable, col: str, num_codes: int):
    """Distinct codes present in a column across all shards (reference:
    distinct.go; here a dense presence count per shard + psum)."""
    c = table.column(col)
    present = [
        K.dense_group_reduce(
            c.data[s].to(torch.int32), None, c.validity[s], num_codes, K.AGG_COUNT
        )
        for s in C.axis_index(table.n_shards)
    ]
    return C.psum(present)[0] > 0
