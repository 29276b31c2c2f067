"""Hash-join physical operator (north-star component, SURVEY.md §2.8).

The reference has no join operator (verified by grep over query/); the
serialized-plan protocol (reference
proto/frostdb/storage/v1alpha1/storage.proto:6) is its federation seed.
Here the join is a first-class engine citizen: a logical ``Join`` node and
this operator as its lowering.

Execution: the right (build) subplan runs to completion at finish time; both
sides' key columns are mapped into one shared dense code space on the host
(exact ``np.unique`` compaction, the same trick as the compiled path's
compact code remap); the match expansion — the O(output) part — runs as
torch ops on the left table's device (ops/kernels.join_expand), and the
pairs come back in one device-to-host copy; with a mesh of more than one
shard the expansion is the distributed CSR join (``mesh_join_pairs``,
parallel/join.py). Output rows are canonically ordered (left stream row,
right row).
"""

from __future__ import annotations

import numpy as np
import torch

from .physeval import EvalError
from ..columnbatch import (
    Column,
    ColumnBatch,
    KIND_DICT,
    KIND_FLOAT64,
    KIND_INT64,
    KIND_LIST,
    KIND_UINT64,
)
from ..config import DEFAULT_DEVICE, resolve_device
from ..ops import kernels as K


def _key_values(col: Column | None, n: int):
    """Per-row comparable key representation + validity.

    Dict columns compare by string value (codes are per-table, so two
    tables' dictionaries never align — the shared code space is rebuilt from
    values); numeric columns by value. Returns (values, validity, class)
    where class is "str" or "num".
    """
    if col is None:
        return np.zeros(n, dtype=np.int64), np.zeros(n, dtype=np.bool_), "num"
    if col.kind == KIND_LIST:
        raise EvalError(f"cannot join on list column {col.name}")
    if col.kind == KIND_DICT:
        varr = col.dictionary.value_array()
        if len(varr) == 0:
            vals = np.full(n, "", dtype=object)
        else:
            codes = np.clip(col.values.astype(np.int64), 0, len(varr) - 1)
            vals = varr[codes]
        return vals, col.validity, "str"
    if col.kind == KIND_FLOAT64:
        return col.values.astype(np.float64), col.validity, "num"
    if col.kind == KIND_UINT64:
        # Keep the native uint64 dtype: the common exact representation with
        # the other side is chosen in shared_key_codes (a blind int64
        # reinterpret would equate u64 2^64-1 with i64 -1 cross-kind).
        return col.values.astype(np.uint64), col.validity, "num"
    return col.values.astype(np.int64), col.validity, "num"


_F53 = 1 << 53  # largest contiguously float64-representable integer magnitude


def _exact_numeric_union(lrep, rrep, lvalid, rvalid, key):
    """Concatenate both sides' numeric key values in an EXACT common
    representation (a blind float64 cast collides distinct int64 keys above
    2^53; an int64 reinterpret of uint64 equates -1 with 2^64-1).

    NaN keys are folded into the null mask: SQL equality never matches NaN
    (the masks are mutated in place — callers pass the accumulating
    per-side validity arrays).
    """
    has_float = lrep.dtype == np.float64 or rrep.dtype == np.float64
    if has_float:
        for rep, valid in ((lrep, lvalid), (rrep, rvalid)):
            if rep.dtype == np.float64:
                valid &= ~np.isnan(rep)
            elif len(rep):
                big = (
                    (rep > np.uint64(_F53)).any()
                    if rep.dtype == np.uint64
                    else ((rep > _F53) | (rep < -_F53)).any()
                )
                if big:
                    raise EvalError(
                        f"join key {key}: int values exceed 2^53; an exact"
                        " float64 comparison is impossible — cast one side"
                    )
        return np.concatenate(
            [lrep.astype(np.float64), rrep.astype(np.float64)]
        )
    has_uint = lrep.dtype == np.uint64 or rrep.dtype == np.uint64
    if has_uint:
        reps = (lrep, rrep)
        umax_ok = all(
            (r <= np.uint64(np.iinfo(np.int64).max)).all()
            for r in reps
            if r.dtype == np.uint64 and len(r)
        )
        if umax_ok:
            return np.concatenate([r.astype(np.int64) for r in reps])
        imin_ok = all(
            (r >= 0).all() for r in reps if r.dtype == np.int64 and len(r)
        )
        if imin_ok:
            return np.concatenate([r.astype(np.uint64) for r in reps])
        # Exact fallback: Python ints compare/sort exactly at any magnitude.
        return np.concatenate(
            [r.astype(object) for r in reps]
        )
    return np.concatenate([lrep.astype(np.int64), rrep.astype(np.int64)])


# (id(left dict), len, id(right dict), len) -> (left dict, right dict,
# lut_l, lut_r, num_codes). Table-global dictionaries are append-only, so
# (id, len) versions an entry — but only while both objects stay alive: the
# cache holds strong references, or a recycled address with an equal length
# would serve a stale mapping. Repeated joins over growing tables reuse it.
_DICT_JOIN_LUTS: dict = {}


def _dict_key_codes(lcol, rcol, nl: int, nr: int):
    """Shared dense codes for a dict⨝dict key column: the two dictionaries
    (not the N rows) map into one value space, then row codes translate
    through int LUT gathers. Same-dictionary sides skip even that."""
    ld = lcol.dictionary if lcol is not None else None
    rd = rcol.dictionary if rcol is not None else None
    if ld is not None and rd is not None and ld is rd:
        num = max(len(ld), 1)
        lc = np.clip(lcol.values.astype(np.int64), 0, num - 1)
        rc = np.clip(rcol.values.astype(np.int64), 0, num - 1)
        return np.concatenate([lc, rc]), num
    lvals = ld.value_array() if ld is not None else np.zeros(0, dtype=object)
    rvals = rd.value_array() if rd is not None else np.zeros(0, dtype=object)
    key = (
        id(ld),
        len(lvals),
        id(rd),
        len(rvals),
    )
    hit = _DICT_JOIN_LUTS.get(key)
    if hit is None or hit[0] is not ld or hit[1] is not rd:
        if len(_DICT_JOIN_LUTS) > 256:
            _DICT_JOIN_LUTS.clear()
        both = np.concatenate(
            [np.asarray(lvals, dtype=object), np.asarray(rvals, dtype=object)]
        ).astype(str)
        uniq, inv = np.unique(both, return_inverse=True)
        hit = _DICT_JOIN_LUTS[key] = (
            ld,
            rd,
            inv[: len(lvals)].astype(np.int64),
            inv[len(lvals) :].astype(np.int64),
            max(len(uniq), 1),
        )
    _ld, _rd, lut_l, lut_r, num = hit
    lc = (
        lut_l[np.clip(lcol.values.astype(np.int64), 0, max(len(lut_l) - 1, 0))]
        if lcol is not None and len(lut_l)
        else np.zeros(nl, dtype=np.int64)
    )
    rc = (
        lut_r[np.clip(rcol.values.astype(np.int64), 0, max(len(lut_r) - 1, 0))]
        if rcol is not None and len(lut_r)
        else np.zeros(nr, dtype=np.int64)
    )
    return np.concatenate([lc, rc]), num


def shared_key_codes(left: ColumnBatch, right: ColumnBatch | None, on):
    """Map both sides' key tuples into one dense code space.

    Returns (lcodes, lvalid, rcodes, rvalid, num_codes): int64 codes in
    [0, num_codes) with rows carrying any null key marked invalid (SQL null
    never equals null).
    """
    nl = left.num_rows
    nr = right.num_rows if right is not None else 0
    acc = None
    acc_num = 1
    lvalid = np.ones(nl, dtype=np.bool_)
    rvalid = np.ones(nr, dtype=np.bool_)
    for k in on:
        lcol = left.column(k)
        rcol = right.column(k) if right is not None else None
        if (
            (lcol is None or lcol.kind == KIND_DICT)
            and (rcol is None or rcol.kind == KIND_DICT)
            and (lcol is not None or rcol is not None)
        ):
            # Dict-code key building: map only the TWO DICTIONARIES into the
            # shared space (cached per dictionary version) and translate row
            # codes with O(n) int gathers — no per-row string
            # materialization or O(n log n) string sort (_key_values is
            # never called, so no object array of N rows exists).
            lvalid &= (
                lcol.validity if lcol is not None else np.zeros(nl, np.bool_)
            )
            rvalid &= (
                rcol.validity if rcol is not None else np.zeros(nr, np.bool_)
            )
            codes, num = _dict_key_codes(lcol, rcol, nl, nr)
        else:
            lrep, lv, lcls = _key_values(lcol, nl)
            rrep, rv, rcls = _key_values(rcol, nr)
            lvalid &= lv
            rvalid &= rv
            if lcol is not None and rcol is not None and lcls != rcls:
                raise EvalError(
                    f"join key {k} kind mismatch: {lcol.kind} vs {rcol.kind}"
                )
            if lcls == "str" or rcls == "str":
                both = np.concatenate(
                    [
                        np.asarray(lrep, dtype=object),
                        np.asarray(rrep, dtype=object),
                    ]
                ).astype(str)
            else:
                both = _exact_numeric_union(lrep, rrep, lvalid, rvalid, k)
            uniq, inv = np.unique(both, return_inverse=True)
            codes = inv.astype(np.int64)
            num = max(len(uniq), 1)
        if acc is None:
            acc, acc_num = codes, num
        else:
            pair = acc * num + codes
            uniq2, acc = np.unique(pair, return_inverse=True)
            acc = acc.astype(np.int64)
            acc_num = max(len(uniq2), 1)
    if acc is None:
        acc = np.zeros(nl + nr, dtype=np.int64)
    return acc[:nl], lvalid, acc[nl:], rvalid, acc_num


def local_join_pairs(
    lcodes, lvalid, rcodes, rvalid, num_codes, total, how, device
):
    """Single-device CSR expansion (ops/kernels.join_expand) on ``device``.
    Returns host (lrows, rrows, matched) ordered (left row asc, right row
    asc). ``total`` is the host-known output size, so the expansion is
    sized to it exactly; an empty right side takes one invalid-key row."""
    dev = torch.device(device)
    nl = len(lcodes)
    nr = len(rcodes)
    if nr == 0:
        rcodes = np.zeros(1, dtype=np.int64)
        rvalid = np.zeros(1, dtype=np.bool_)
    lc = torch.as_tensor(np.ascontiguousarray(lcodes, dtype=np.int64), device=dev)
    lkv = torch.as_tensor(np.ascontiguousarray(lvalid, dtype=np.bool_), device=dev)
    rc = torch.as_tensor(np.ascontiguousarray(rcodes, dtype=np.int64), device=dev)
    rkv = torch.as_tensor(np.ascontiguousarray(rvalid, dtype=np.bool_), device=dev)
    llive = torch.ones(nl, dtype=torch.bool, device=dev)
    _t, li, rrow, _live, matched = K.join_expand(
        lc, lkv, llive, rc, rkv, num_codes, total, how == "left_outer"
    )
    # ONE device-to-host copy of the emitted pairs, packed as int32 (row
    # ids < 2^31 by construction).
    parts = [li, rrow]
    if how == "left_outer":
        parts.append(matched.to(torch.int32))
    blob = torch.cat(parts).cpu().numpy()
    li = blob[:total].astype(np.int64)
    rrow = blob[total : 2 * total].astype(np.int64)
    if how == "left_outer":
        matched_np = blob[2 * total : 3 * total].astype(np.bool_)
    else:
        # inner joins emit matches only — no need to ship an all-true mask
        matched_np = np.ones(total, dtype=np.bool_)
    return li, rrow, matched_np


def mesh_join_pairs(lcodes, lvalid, rcodes, rvalid, num_codes, how, mesh, axis):
    """Distributed CSR expansion over the device mesh (parallel/join.py):
    both sides hash-partition on the shared key code so equal keys co-locate
    and the match is shard-local; row ids ride along so the host
    materializes the same (left row, right row) pair set as the local
    expansion. Canonical (left, right) lexsort makes the output identical
    to single-device execution."""
    from ..parallel.join import distributed_join_auto
    from ..parallel.mesh import PartitionedTable

    nl = len(lcodes)
    nr = len(rcodes)
    lcb = ColumnBatch(
        [
            Column("__code__", KIND_INT64, lcodes.astype(np.int64), lvalid),
            Column(
                "__rowid__",
                KIND_INT64,
                np.arange(nl, dtype=np.int64),
                np.ones(nl, dtype=np.bool_),
            ),
        ],
        nl,
    )
    rcb = ColumnBatch(
        [
            Column("__code__", KIND_INT64, rcodes.astype(np.int64), rvalid),
            Column(
                "__rowid__",
                KIND_INT64,
                np.arange(nr, dtype=np.int64),
                np.ones(nr, dtype=np.bool_),
            ),
        ],
        nr,
    )
    lpt = PartitionedTable.from_batch(lcb, mesh, axis, hash_key="__code__")
    rpt = PartitionedTable.from_batch(rcb, mesh, axis, hash_key="__code__")
    totals, li, rjvalid, rvs, cap = distributed_join_auto(
        lpt, rpt, "__code__", num_codes, ["__rowid__"], how
    )
    n_shards = lpt.n_shards
    per_shard = lpt.n_pad // n_shards
    lrowid = np.asarray(lpt.column("__rowid__").data)
    lrowlive = np.asarray(lpt.column("__rowid__").validity)
    li = np.asarray(li)
    rjvalid = np.asarray(rjvalid)
    rrowid = np.asarray(rvs[0])
    lrows_parts = []
    rrows_parts = []
    match_parts = []
    for s in range(n_shards):
        t = int(totals[s])
        sl = slice(s * cap, s * cap + t)
        lp = s * per_shard + li[sl]
        live = lrowlive[lp]  # drop padding-row phantom slots (left_outer)
        lrows_parts.append(lrowid[lp][live])
        m = rjvalid[sl][live]
        match_parts.append(m)
        rrows_parts.append(np.where(m, rrowid[sl][live], np.int64(-1)))
    lrows = np.concatenate(lrows_parts) if lrows_parts else np.zeros(0, np.int64)
    rrows = np.concatenate(rrows_parts) if rrows_parts else np.zeros(0, np.int64)
    matched = (
        np.concatenate(match_parts) if match_parts else np.zeros(0, np.bool_)
    )
    order = np.lexsort((rrows, lrows))
    return lrows[order], rrows[order], matched[order]


def join_batches(
    left: ColumnBatch,
    right: ColumnBatch | None,
    on,
    how: str,
    device=DEFAULT_DEVICE,
    mesh=None,
    mesh_axis: str = "shards",
) -> ColumnBatch | None:
    """Join two unified host batches; the workhorse behind the HashJoin
    operator (and directly reachable for library use). The match expansion
    runs on ``device``, or across ``mesh`` when it has more than one
    shard."""
    dev = resolve_device(device)
    nl = left.num_rows
    nr = right.num_rows if right is not None else 0
    lcodes, lvalid, rcodes, rvalid, num_codes = shared_key_codes(
        left, right, on
    )
    counts = (
        np.bincount(rcodes[rvalid], minlength=num_codes)
        if nr
        else np.zeros(num_codes, dtype=np.int64)
    )
    mc = np.where(lvalid, counts[lcodes], 0)

    if how == "semi":
        return left.select_mask(mc > 0)
    if how == "anti":
        return left.select_mask(lvalid & (mc == 0))

    total = int(np.maximum(mc, 1).sum()) if how == "left_outer" else int(mc.sum())
    if total == 0:
        return None
    if mesh is not None and mesh.shape[mesh_axis] > 1 and nr > 0:
        lrows, rrows, matched = mesh_join_pairs(
            lcodes, lvalid, rcodes, rvalid, num_codes, how, mesh, mesh_axis
        )
    else:
        lrows, rrows, matched = local_join_pairs(
            lcodes, lvalid, rcodes, rvalid, num_codes, total, how, dev
        )

    out_cols = [c.take(lrows) for c in left.columns]
    left_names = {c.name for c in left.columns}
    key_names = set(on)
    if right is not None and nr == 0:
        # Zero-row right (left_outer only reaches here; inner/semi returned
        # above): no row to take — extend with all-null right columns of the
        # right schema.
        for c in right.columns:
            if c.name in key_names:
                continue
            nm = c.name if c.name not in left_names else c.name + "_right"
            out_cols.append(
                Column.all_null(
                    nm, c.kind, len(lrows), c.dictionary, c.layout, template=c
                )
            )
        return ColumnBatch(out_cols, len(lrows))
    if right is not None:
        safe_r = np.clip(rrows, 0, max(nr - 1, 0))
        rt = right.take(safe_r)
        for c in rt.columns:
            if c.name in key_names:
                continue
            nm = c.name if c.name not in left_names else c.name + "_right"
            validity = c.validity & matched
            vals = c.values
            if c.kind != KIND_LIST:
                # invariant: null slots hold 0/False (columnbatch.py Column)
                vals = np.where(validity, vals, vals.dtype.type(0))
            out_cols.append(
                Column(
                    nm,
                    c.kind,
                    vals,
                    validity,
                    c.dictionary,
                    c.layout,
                    offsets=c.offsets,
                    child=c.child,
                )
            )
    return ColumnBatch(out_cols, len(lrows))
