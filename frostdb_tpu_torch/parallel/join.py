"""Distributed hash join (reference: frostdb_tpu/parallel/join.py; the
reference frostdb has no join operator at all — verified by grep over
query/, SURVEY.md intro).

Strategy: both sides hash-partitioned on the join key over the same mesh
(PartitionedTable.from_batch(hash_key=...)), so equal keys are co-located
and the join is shard-local — the shuffle cost is paid once at load, like
the reference pays hashing cost at insert (dynparquet/hashed.go). The local
join builds a dense code-indexed table (unique build keys: primary-key
join) and probes with a gather; data crosses shards only when the sides
are *not* co-partitioned, in which case the build side is all-gathered
when small (broadcast join) — the classic two regimes.

Skew: hash partitioning of *keys* (not rows) bounds per-shard build size;
heavy probe keys are naturally spread only in the broadcast regime.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..device import ShardedTensor
from ..ops import kernels as K
from . import collectives as C
from .mesh import PartitionedTable


def _per_shard(cols, s: int) -> list:
    """Shard ``s``'s (data, validity) pair of every column."""
    return [(c.data[s], c.validity[s]) for c in cols]


def distributed_hash_join(
    left: PartitionedTable,
    right: PartitionedTable,
    key: str,
    num_codes: int,
    right_value_cols: Sequence[str],
    broadcast_right: bool = False,
):
    """Join left rows with unique-key right rows on dict-coded ``key``.

    Returns a zero-arg callable producing (matched_mask, values): for each
    right value column an array aligned with the left table's (sharded)
    rows. Unmatched or invalid left rows get mask False."""
    lk = left.column(key)
    rk = right.column(key)
    rvals = [right.column(c) for c in right_value_cols]
    n_shards = left.n_shards

    def run():
        if broadcast_right:
            # the build side all-gathered: every shard holds all of it
            rcodes = C.all_gather(list(rk.data))
            rvalid = C.all_gather(list(rk.validity))
            gathered = [
                (C.all_gather(list(c.data)), C.all_gather(list(c.validity)))
                for c in rvals
            ]
            rvs = [
                [(d[s], va[s]) for d, va in gathered] for s in range(n_shards)
            ]
        else:
            rcodes, rvalid = list(rk.data), list(rk.validity)
            rvs = [_per_shard(rvals, s) for s in range(n_shards)]
        matched_out, vals_out = [], [[] for _ in rvals]
        for s in C.axis_index(n_shards):
            rc, rv = rcodes[s], rvalid[s]
            dev = rc.device
            # Build: dense table code -> row of the (unique) right row.
            safe = torch.where(rv, rc.to(torch.int64), num_codes)
            present = (
                K._segment(rv.to(torch.int32), safe, num_codes + 1, "amax")[:num_codes]
                > 0
            )
            n_r = rc.shape[0]
            ridx = K._segment(
                torch.where(rv, torch.arange(n_r, dtype=torch.int32, device=dev), n_r),
                safe,
                num_codes + 1,
                "amin",
            )[:num_codes]
            ridx = torch.clamp(ridx, max=n_r - 1).long()
            lc = torch.clamp(lk.data[s].to(torch.int64), 0, num_codes - 1)
            matched = lk.validity[s] & present[lc]
            probe_rows = ridx[lc]
            for j, (v, va) in enumerate(rvs[s]):
                vals_out[j].append(v[probe_rows])
                matched = matched & va[probe_rows]
            matched_out.append(matched)
        return ShardedTensor(matched_out), tuple(ShardedTensor(v) for v in vals_out)

    return run


def distributed_hash_join_multi(
    left: PartitionedTable,
    right: PartitionedTable,
    key: str,
    num_codes: int,
    right_value_cols: Sequence[str],
    out_capacity: int,
    mode: str = "inner",
):
    """Duplicate-key distributed join on dict-coded ``key`` (the general
    case distributed_hash_join's unique-build-key fast path excludes).

    Per shard, the build side sorts by key code into CSR buckets (stable
    sort + segment counts + cumsum); each probe row's matches expand via an
    exclusive cumsum of per-row match counts and a searchsorted over the
    output index space. The data-dependent OUTPUT size takes a static
    per-shard ``out_capacity`` with exact overflow detection, as the
    shuffle does (shuffle.py); ``distributed_join_auto`` escalates it
    geometrically.

    Modes:
      inner       one output row per (probe row, matching build row)
      left_outer  unmatched/invalid-key probe rows emit one row with
                  right_valid False
      semi/anti   no expansion: a [rows]-aligned bool mask per probe row

    Returns a zero-arg callable producing per-shard-concatenated arrays:
      inner/left_outer: (totals[S], left_row, right_valid, *right_vals)
        with slots >= totals[s] inside shard s undefined;
      semi/anti: mask aligned with the left table's rows.
    """
    if mode not in ("inner", "left_outer", "semi", "anti"):
        raise ValueError(f"unknown join mode {mode}")
    lk = left.column(key)
    rk = right.column(key)
    rvals = [right.column(c) for c in right_value_cols]
    n_shards = left.n_shards

    def shard(s):
        lcodes, lvalid = lk.data[s], lk.validity[s]
        rcodes, rvalid = rk.data[s], rk.validity[s]
        dev = lcodes.device
        n_r = rcodes.shape[0]
        n_l = lcodes.shape[0]
        safe_r = torch.where(rvalid, rcodes.to(torch.int64), num_codes)
        # CSR buckets: build rows sorted by code (invalid, num_codes, last);
        # starts via cumsum.
        perm = torch.sort(safe_r, stable=True).indices
        counts = torch.bincount(safe_r, minlength=num_codes + 1)[:num_codes]
        starts = torch.cumsum(counts, 0) - counts
        lc = torch.clamp(lcodes.to(torch.int64), 0, num_codes - 1)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        match_counts = torch.where(lvalid, counts[lc], zero)
        if mode == "semi":
            return (match_counts > 0,)
        if mode == "anti":
            return (lvalid & (match_counts == 0),)
        out_counts = match_counts
        if mode == "left_outer":
            out_counts = torch.clamp(match_counts, min=1)
        off = torch.cat([zero.reshape(1), torch.cumsum(out_counts, 0)])
        total = off[-1]
        # Expand: output slot j belongs to probe row i = the last row whose
        # offset is <= j; its rank within the row indexes the CSR bucket.
        out_idx = torch.arange(out_capacity, dtype=torch.int64, device=dev)
        li = torch.clamp(
            torch.searchsorted(off, out_idx, right=True) - 1, 0, n_l - 1
        )
        rank = out_idx - off[li]
        code = lc[li]
        has_match = match_counts[li] > 0
        rpos = torch.clamp(starts[code] + rank, 0, n_r - 1)
        rrow = perm[rpos]
        slot_live = out_idx < total
        right_valid = slot_live & has_match
        outs = [total.reshape(1), li.to(torch.int32), right_valid]
        for v, va in _per_shard(rvals, s):
            outs.append(v[rrow])
            outs.append(va[rrow] & right_valid)
        return tuple(outs)

    def run():
        per = [shard(s) for s in C.axis_index(n_shards)]
        res = tuple(ShardedTensor(col) for col in zip(*per))
        if mode in ("semi", "anti"):
            return res[0]
        return res[0], res[1], res[2], res[3:]

    return run


def distributed_join_auto(
    left: PartitionedTable,
    right: PartitionedTable,
    key: str,
    num_codes: int,
    right_value_cols: Sequence[str],
    mode: str = "inner",
    initial_capacity: int | None = None,
    max_doublings: int = 8,
):
    """Duplicate-key join with geometric capacity escalation (the
    shuffle_by_key_auto pattern): run at a per-shard capacity, detect
    overflow exactly from the returned totals, and run again at double the
    capacity until every shard fits."""
    if mode in ("semi", "anti"):
        return distributed_hash_join_multi(
            left, right, key, num_codes, right_value_cols, 1, mode
        )()
    n_shards = left.n_shards
    cap = initial_capacity or max(
        128, left.column(key).data.shape[0] // n_shards
    )
    for _ in range(max_doublings + 1):
        run = distributed_hash_join_multi(
            left, right, key, num_codes, right_value_cols, cap, mode
        )
        totals, li, rvalid, rvs = run()
        totals_np = np.asarray(totals)
        if int(totals_np.max(initial=0)) <= cap:
            return totals_np, li, rvalid, rvs, cap
        cap *= 2
    raise RuntimeError("join output exceeded capacity after escalation")
