"""Row repartitioning over the mesh with an all_to_all exchange (reference:
frostdb_tpu/parallel/shuffle.py).

The reference's only cross-worker data movement is shared object storage
(SURVEY.md §5.8); the mesh's exchange is an ``all_to_all``
(collectives.py). Rows hash to destination shards; each shard packs its
rows into fixed-capacity per-destination buckets, exchanges, and the
receivers hold ``[n_shards, cap]`` slots each.

Capacity: with roughly uniform keys each destination receives about
``rows/n_shards`` from each sender; ``oversub`` (default 2x) covers
imbalance. Overflow is detected exactly (per-destination counts, combined
with a ``pmax``) and surfaces as a ShuffleOverflow.

Skew (SURVEY.md §7 hard parts): a heavy key overflows its destination no
matter the oversubscription — hashing co-locates ALL its rows. ``salt=S``
spreads each key over S shards (sub-shard = row position mod S, mixed into
the destination), so per-destination load is bounded by
``rows_of_heaviest_key / S``; consumers must then combine per-key partials
across sub-shards. ``shuffle_by_key_auto`` is the skew-aware entry: it
detects overflow and escalates the salt geometrically instead of blowing up
capacity.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import ShardedTensor
from . import collectives as C
from .mesh import PartitionedTable, ShardedColumn, hash_int64_device


class ShuffleOverflow(RuntimeError):
    pass


def bucket_slots(dest: torch.Tensor, n_shards: int, cap: int):
    """Gather-packing of rows into [n_shards, cap] destination buckets:
    rows stable-sorted by ``dest`` (values >= n_shards sort last and go
    nowhere); output slot (b, p) takes sorted row ``starts[b] + p`` while
    ``p < counts[b]``. Returns (order, src, in_bucket, counts): the sort
    permutation, the clamped sorted-row index per slot, the live-slot mask
    and the per-destination row counts."""
    m = dest.shape[0]
    dev = dest.device
    order = torch.sort(dest, stable=True).indices
    counts = torch.bincount(dest.to(torch.int64), minlength=n_shards + 1)[:n_shards]
    starts = torch.cumsum(counts, 0) - counts
    out_idx = torch.arange(n_shards * cap, device=dev)
    b = out_idx // cap
    p = out_idx % cap
    src = torch.clamp(starts[b] + p, 0, max(m - 1, 0))
    in_bucket = p < counts[b]
    return order, src, in_bucket, counts


def shuffle_by_key(
    table: PartitionedTable,
    key: str,
    oversub: float = 2.0,
    salt: int = 1,
) -> PartitionedTable:
    """Repartition so equal keys co-locate (salt=1) or spread over ``salt``
    shards (skewed keys; see module docstring). Returns a new
    PartitionedTable whose shards hold the exchanged rows (padding rows
    invalid)."""
    n_shards = table.n_shards
    per_shard = table.n_pad // n_shards
    salt = max(1, min(int(salt), n_shards))
    # per-destination bucket capacity per sender (tile-aligned)
    cap = int(np.ceil(per_shard / n_shards * oversub / 128)) * 128
    cap = max(cap, 128)

    names = list(table.columns)
    kcol = table.column(key)
    packs = []
    over = []
    for s in C.axis_index(n_shards):
        kdata, kvalid = kcol.data[s], kcol.validity[s]
        dest = hash_int64_device(kdata) % n_shards
        if salt > 1:
            # Sub-shard by row position: a key's rows round-robin over salt
            # consecutive destinations, bounding any one shard's share of a
            # heavy key to 1/salt of its rows per sender.
            sub = torch.arange(kdata.shape[0], device=kdata.device) % salt
            dest = (dest + sub) % n_shards
        dest = torch.where(kvalid, dest, n_shards)  # invalid last
        packs.append(bucket_slots(dest, n_shards, cap))
        over.append((packs[-1][3] > cap).any().to(torch.int32))
    if bool(C.pmax(over)[0]):
        raise ShuffleOverflow(
            f"destination bucket overflow (cap={cap}); retry with larger oversub"
        )

    out = PartitionedTable(table.mesh, table.axis)
    out.n_pad = n_shards * cap * n_shards  # per-shard rows * shards
    out.n_rows = table.n_rows
    for n in names:
        src_col = table.column(n)
        packed, pvalid = [], []
        for s, (order, src, in_bucket, _counts) in enumerate(packs):
            d_s = src_col.data[s][order][src]
            packed.append(
                torch.where(in_bucket, d_s, torch.zeros_like(d_s)).reshape(n_shards, cap)
            )
            pvalid.append(
                (src_col.validity[s][order][src] & in_bucket).reshape(n_shards, cap)
            )
        out.columns[n] = ShardedColumn(
            n,
            src_col.kind,
            ShardedTensor(x.reshape(-1) for x in C.all_to_all(packed)),
            ShardedTensor(x.reshape(-1) for x in C.all_to_all(pvalid)),
        )
    return out


def shuffle_by_key_auto(
    table: PartitionedTable,
    key: str,
    oversub: float = 2.0,
    max_salt: Optional[int] = None,
) -> tuple[PartitionedTable, int]:
    """Skew-aware repartitioning: try the plain co-locating exchange, and on
    overflow escalate the salt geometrically (1 -> 2 -> 4 ...) before giving
    up — turning a heavy key's hot destination into balanced load instead of
    growing every bucket (SURVEY.md §5.8 skew-aware repartitioning).

    Returns ``(shuffled_table, salt_used)``; salt_used > 1 tells the caller
    equal keys now live on salt_used shards, so aggregation consumers must
    combine per-key partials across sub-shards (the two-phase final stage).
    """
    if max_salt is None:
        max_salt = table.n_shards
    salt = 1
    while True:
        try:
            return shuffle_by_key(table, key, oversub=oversub, salt=salt), salt
        except ShuffleOverflow:
            if salt >= max_salt:
                # fully salted and still overflowing: genuinely undersized
                # buckets, not skew — grow capacity once, then give up.
                return (
                    shuffle_by_key(
                        table, key, oversub=oversub * 2.0, salt=salt
                    ),
                    salt,
                )
            salt = min(salt * 2, max_salt)
