"""Tensor kernels over padded column vectors — the generic operator DAG's
device work, in plain PyTorch on the tensors' own device.

These replace the reference's per-row Go loops:

- predicate masks            <- query/physicalplan/binaryscalarexpr.go
- projection arithmetic      <- query/physicalplan/project.go binaryExprProjection
- group aggregation          <- query/physicalplan/aggregate.go (hash map loop)
- distinct                   <- query/physicalplan/distinct.go (seen-set loop)
- join match expansion       <- no reference analogue (query/join.py)

Design: every kernel takes padded same-shape tensors plus masks; row
selection is a boolean vector (the roaring-bitmap analogue, filter.go:255);
grouping is *exact* — a multi-key lexicographic sort (chained stable
``torch.sort`` passes, least significant key first) followed by segment
reductions, so there are no hash collisions and group emission order is the
deterministic first-occurrence order of the input stream, matching the
reference's insertion-ordered hash table (aggregate.go:430 map + append-only
builders).

Segment reductions are ``scatter_reduce`` with ``include_self=False`` into
an output pre-filled with the reduction's identity, so empty segments hold
the same values as ``jax.ops.segment_*`` (0, the dtype maximum, the dtype
minimum). Float sums on the GPU take a fixed-order scan instead
(``ordered_segment_sum``).
"""

from __future__ import annotations

import torch


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


# ---------------------------------------------------------------------------
# Predicate masks

_COMPARE = {
    "==": torch.eq,
    "!=": torch.ne,
    "<": torch.lt,
    "<=": torch.le,
    ">": torch.gt,
    ">=": torch.ge,
}


def compare_scalar_mask(values, validity, literal, op: str):
    """values <op> literal -> bool mask; null rows never match (reference:
    ArrayScalarCompute skips null slots, binaryscalarexpr.go:143-146)."""
    if op not in _COMPARE:
        raise ValueError(f"unsupported compare op {op}")
    return _COMPARE[op](values, literal) & validity


# ---------------------------------------------------------------------------
# Projection arithmetic


def arith(lv, l_valid, rv, r_valid, op: str):
    """Elementwise binary arithmetic with null propagation. Integer division
    truncates toward zero like Go and division by zero yields null
    (reference golden: logictest/testdata/exec/aggregate/math
    ``timestamp / value`` with value=0 -> null). Takes tensors or host
    arrays (host arrays compute on the CPU)."""
    lv, rv = _tensor(lv), _tensor(rv)
    l_valid, r_valid = _tensor(l_valid), _tensor(r_valid)
    valid = l_valid & r_valid
    if op == "+":
        out = lv + rv
    elif op == "-":
        out = lv - rv
    elif op == "*":
        out = lv * rv
    elif op == "/":
        zero = rv == 0
        valid = valid & ~zero
        safe = torch.where(zero, torch.ones_like(rv), rv)
        if lv.dtype.is_floating_point:
            out = lv / safe
        else:
            # INT64_MIN / -1 overflows (a hardware trap on the CPU); like
            # XLA it yields INT64_MIN, which is -INT64_MIN wrapped.
            neg1 = safe == -1
            out = torch.where(
                neg1,
                -lv,
                torch.div(
                    lv, torch.where(neg1, torch.ones_like(safe), safe),
                    rounding_mode="trunc",
                ),
            )
    else:
        raise ValueError(f"unsupported arith op {op}")
    return out, valid


# ---------------------------------------------------------------------------
# Exact group-by aggregation

AGG_SUM = "sum"
AGG_COUNT = "count"
AGG_MIN = "min"
AGG_MAX = "max"
AGG_UNIQUE = "unique"
AGG_AND = "and"


def _as_sort_key(vals) -> torch.Tensor:
    """Map a key column to an int64 equality-preserving representation:
    bools widen, floats bitcast their float64 bits. uint64 columns arrive
    already as sign-flipped int64 (device.py), which preserves equality and
    order."""
    if vals.dtype == torch.bool:
        return vals.to(torch.int64)
    if vals.dtype.is_floating_point:
        return vals.to(torch.float64).view(torch.int64)
    return vals.to(torch.int64)


def _dtype_max(dtype):
    if dtype.is_floating_point:
        return float("inf")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).max


def _dtype_min(dtype):
    if dtype.is_floating_point:
        return float("-inf")
    if dtype == torch.bool:
        return False
    return torch.iinfo(dtype).min


def ordered_segment_sum(vals, seg, num_segments: int):
    """Float segment sums in an order fixed by the data alone, for segments
    that are contiguous runs (``seg`` non-decreasing, as ``group_ids`` and
    ``ordered_group_ids`` produce them): a binary tree over each segment's
    values in row order, rooted at its first row (log2(n) passes of
    elementwise adds, no atomics). The result depends on the segment's
    values alone, so it is the same on every run; empty segments hold 0,
    and an all-(-0.0) segment sums to +0.0 as a sum that starts from 0
    does."""
    n = vals.shape[0]
    dev = vals.device
    pos = torch.arange(n, device=dev)
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = seg[1:] != seg[:-1]
    rank = pos - torch.cummax(torch.where(head, pos, 0), 0).values
    acc = vals.clone()
    step = 1
    while step < n:
        # rows at a multiple of 2*step within their segment take in the
        # block that starts step rows later, if it is in the same segment
        take = (rank[:-step] % (2 * step) == 0) & (seg[step:] == seg[:-step])
        acc[:-step] = torch.where(take, acc[:-step] + acc[step:], acc[:-step])
        step *= 2
    out = torch.zeros(num_segments, dtype=vals.dtype, device=dev)
    out[seg[head].long()] = acc[head] + 0.0
    return out


def _segment(vals, seg, num_segments: int, reduce: str):
    """jax.ops.segment_{sum,min,max} semantics: empty segments hold the
    reduction's identity (0 / dtype max / dtype min). On the CPU a float
    sum adds each segment's values in row order, as the reference does; on
    the GPU, where a scatter adds in the order its atomics land, it takes
    ``ordered_segment_sum`` so the result does not change between runs."""
    if (
        reduce == "sum"
        and vals.dtype.is_floating_point
        and vals.device.type != "cpu"
    ):
        return ordered_segment_sum(vals, seg, num_segments)
    fill = {"sum": 0, "amin": _dtype_max, "amax": _dtype_min}[reduce]
    if callable(fill):
        fill = fill(vals.dtype)
    out = torch.full(
        (num_segments,), fill, dtype=vals.dtype, device=vals.device
    )
    return out.scatter_reduce_(
        0, seg.long(), vals, reduce=reduce, include_self=False
    )


def lexsort(keys) -> torch.Tensor:
    """Permutation sorting rows lexicographically by ``keys`` (first key
    most significant), ties by row index — ``lax.sort`` over all keys plus
    a trailing row-index key. Chained stable sorts, least significant key
    first."""
    n = keys[0].shape[0]
    perm = torch.arange(n, device=keys[0].device)
    for k in reversed(keys):
        idx = torch.sort(k[perm], stable=True).indices
        perm = perm[idx]
    return perm


def _diffs(arr):
    head = torch.ones(1, dtype=torch.bool, device=arr.device)
    return torch.cat([head, arr[1:] != arr[:-1]])


def group_ids(key_vals, key_valid, sel):
    """Exact grouping pass, shared by aggregation and distinct.

    Sorts selected rows to the front grouped by the key tuple (stable by
    original row index), derives segment boundaries and first-occurrence
    ordering.

    Returns (num_groups, perm, sel_sorted, seg, order, first_row_ordered):
      - perm[i]: original row index of sorted position i
      - seg[i]: segment (group) id of sorted position i (key-sorted order)
      - order[g_out] = key-order group id emitted at output position g_out
        (output positions are first-occurrence order)
      - first_row_ordered[g_out]: first original row of that group (>= n
        for positions beyond num_groups)
    """
    n = sel.shape[0]
    dev = sel.device
    keys = [(~sel).to(torch.int8)]
    for v, va in zip(key_vals, key_valid):
        live = va & sel
        keys.append(live.to(torch.int8))
        keys.append(
            torch.where(
                live, _as_sort_key(v), torch.zeros((), dtype=torch.int64, device=dev)
            )
        )
    perm = lexsort(keys)
    sorted_keys = [k[perm] for k in keys]
    sel_sorted = sorted_keys[0] == 0

    if len(key_vals) > 0:
        changed = torch.zeros(n, dtype=torch.bool, device=dev)
        for arr in sorted_keys[1:]:
            changed = changed | _diffs(arr)
    else:
        changed = torch.zeros(n, dtype=torch.bool, device=dev)
        changed[0] = True
    boundary = changed & sel_sorted
    num_groups = boundary.sum()
    seg = torch.clamp(torch.cumsum(boundary.to(torch.int32), 0) - 1, min=0)

    # First original row per group; rows within a segment are in ascending
    # original order thanks to the row-index tie break.
    perm32 = perm.to(torch.int32)
    first_row = _segment(
        torch.where(sel_sorted, perm32, torch.full_like(perm32, n)),
        seg,
        n,
        "amin",
    )
    order = torch.sort(first_row, stable=True).indices
    first_row_o = first_row[order]
    return num_groups, perm32, sel_sorted, seg, order, first_row_o


def ident_like(v):
    """Min-reduce identity that can NEVER clamp a real value: group_ids
    routes unselected/padding rows into the LAST segment, so segment_agg's
    identities compete inside real groups. The int64 extremes are exact
    even on collision: min's identity INT64_MAX only ties a true INT64_MAX
    value."""
    return _dtype_max(v.dtype)


_I64_MIN = -(2**63)  # the sign bit of a float64's bits
_I64_MAX = 2**63 - 1


def _nan_sign_like_reference(sums, v_s, sel_sorted, seg, n: int):
    """Give NaN float sums the sign the reference's sequential segment sum
    gives them: each step computes ``v + acc``, so a NaN input replaces the
    running sum (the LAST NaN input's sign wins), and ``inf + -inf`` with
    no NaN input makes the negative default NaN. The sign otherwise depends
    on the add order, which a scatter on the GPU does not keep."""
    nan_in = torch.isnan(v_s) & sel_sorted
    pos = torch.arange(n, device=v_s.device)
    last = _segment(torch.where(nan_in, pos, -1), seg, n, "amax")
    last_neg = torch.signbit(v_s[torch.clamp(last, min=0)])
    neg = torch.where(last >= 0, last_neg, True)
    # The sign goes on the NaN's bits: a GPU's float arithmetic, negation
    # included, returns its one canonical NaN, which is positive.
    nan = torch.full_like(sums, float("nan")).view(torch.int64) & _I64_MAX
    signed = torch.where(neg, nan | _I64_MIN, nan).view(sums.dtype)
    return torch.where(torch.isnan(sums), signed, sums)


def segment_agg(vals, valid, perm, sel_sorted, seg, order, op: str):
    """One aggregation over the segments produced by ``group_ids``. Returns
    (out[N], valid[N]) in first-occurrence output order."""
    n = sel_sorted.shape[0]
    perm = perm.long()
    v_s = vals[perm]
    va_s = valid[perm]
    ones = torch.ones(n, dtype=torch.bool, device=vals.device)
    if op == AGG_SUM:
        # Null slots hold zero, matching the reference's raw-buffer sum
        # (aggregate.go:763 math.Int64.Sum includes null slots).
        out = _segment(
            torch.where(sel_sorted, v_s, torch.zeros_like(v_s)), seg, n, "sum"
        )
        if v_s.dtype.is_floating_point:
            out = _nan_sign_like_reference(out, v_s, sel_sorted, seg, n)
        valid_out = ones
    elif op == AGG_COUNT:
        # Counts all rows in the group including nulls (aggregate.go:934).
        out = _segment(sel_sorted.to(torch.int64), seg, n, "sum")
        valid_out = ones
    elif op == AGG_MIN:
        ident = torch.full_like(v_s, ident_like(v_s))
        out = _segment(torch.where(sel_sorted, v_s, ident), seg, n, "amin")
        valid_out = ones
    elif op == AGG_MAX:
        # exact max identity: -inf / INT64_MIN (a negated min-identity
        # -(2^63-1) would clamp an all-INT64_MIN group by one)
        ident = torch.full_like(v_s, _dtype_min(v_s.dtype))
        out = _segment(torch.where(sel_sorted, v_s, ident), seg, n, "amax")
        valid_out = ones
    elif op == AGG_UNIQUE:
        # Value if the group holds exactly one distinct non-null value and no
        # nulls; else null (aggregate.go:712 uniqueInt64arrays).
        r = _as_sort_key(v_s)
        mn = _segment(
            torch.where(sel_sorted, r, torch.full_like(r, 2**63 - 1)),
            seg,
            n,
            "amin",
        )
        mx = _segment(
            torch.where(sel_sorted, r, torch.full_like(r, -(2**63))),
            seg,
            n,
            "amax",
        )
        has_null = (
            _segment((sel_sorted & ~va_s).to(torch.int32), seg, n, "amax") > 0
        )
        out = _segment(
            torch.where(sel_sorted, v_s, torch.full_like(v_s, ident_like(v_s))),
            seg,
            n,
            "amin",
        )
        valid_out = (mn == mx) & ~has_null
    elif op == AGG_AND:
        v8 = torch.where(
            sel_sorted & va_s,
            v_s.to(torch.int8),
            torch.ones_like(v_s, dtype=torch.int8),
        )
        out = _segment(v8, seg, n, "amin") > 0
        valid_out = ones
    else:
        raise ValueError(f"unsupported aggregation {op}")
    return out[order], valid_out[order]


def group_aggregate(key_vals, key_valid, agg_vals, agg_valid, sel, agg_ops):
    """Exact grouped aggregation: ``group_ids`` + per-op ``segment_agg``.

    Returns (num_groups, first_row, group_key_vals, group_key_valid,
    agg_out_vals, agg_out_valid); tensors have length N, valid entries are
    the first num_groups, ordered by first occurrence in the stream."""
    n = sel.shape[0]
    num_groups, perm, sel_sorted, seg, order, first_row_o = group_ids(
        tuple(key_vals), tuple(key_valid), sel
    )
    live = first_row_o < n
    fr = torch.clamp(first_row_o, max=n - 1).long()
    group_key_vals = tuple(v[fr] for v in key_vals)
    group_key_valid = tuple(va[fr] & live for va in key_valid)
    outs = []
    valids = []
    for (v, va), op in zip(zip(agg_vals, agg_valid), agg_ops):
        o, vo = segment_agg(v, va, perm, sel_sorted, seg, order, op)
        outs.append(o)
        valids.append(vo & live)
    return (
        num_groups,
        first_row_o,
        group_key_vals,
        group_key_valid,
        tuple(outs),
        tuple(valids),
    )


def ordered_group_ids(key_vals, key_valid, sel):
    """Grouping pass for already-sorted input (reference:
    pqarrow/arrowutils/groupranges.go GetGroupsAndOrderedSetRanges +
    OrderedAggregate): no sort — boundaries are computed positionally, so
    this is a single streaming pass. Selected rows must form a prefix.

    Returns (num_groups, seg[N], first_row[N]) with groups in stream order.
    """
    n = sel.shape[0]
    dev = sel.device
    rowidx = torch.arange(n, dtype=torch.int32, device=dev)
    changed = torch.zeros(n, dtype=torch.bool, device=dev)
    any_key = False
    for v, va in zip(key_vals, key_valid):
        live = va & sel
        r = torch.where(
            live, _as_sort_key(v), torch.zeros((), dtype=torch.int64, device=dev)
        )
        changed = changed | _diffs(r) | _diffs(live.to(torch.int8))
        any_key = True
    if not any_key:
        changed = torch.zeros(n, dtype=torch.bool, device=dev)
        changed[0] = True
    boundary = changed & sel
    num_groups = boundary.sum()
    seg = torch.clamp(torch.cumsum(boundary.to(torch.int32), 0) - 1, min=0)
    first_row = _segment(
        torch.where(sel, rowidx, torch.full_like(rowidx, n)), seg, n, "amin"
    )
    return num_groups, seg, first_row


def distinct_rows(key_vals, key_valid, sel):
    """First-occurrence distinct row indices over the key tuple (reference:
    query/physicalplan/distinct.go seen-set). Returns (num_distinct,
    row_indices[N])."""
    num_groups, _perm, _ss, _seg, _order, first_row_o = group_ids(
        tuple(key_vals), tuple(key_valid), sel
    )
    return num_groups, first_row_o


# ---------------------------------------------------------------------------
# Dense-code reductions: group keys combined into one dense code space
# [0, num_codes); each code's partials land in a [num_codes] table. The
# dense serving tier (parallel/mesh_exec.py) runs these per part.

# "No selected row" sentinel of sorted_group_reduce's first row and min/max
# (the reference's +-2^62 headroom convention).
_INT64_BIG = 2**62


def sorted_group_reduce(codes, sel, rows, vals, num_codes: int, ops: tuple):
    """Dense [num_codes] group reduction via sort + prefix sums — the
    large-K path: one stable sort of the rows by code, segment bounds by
    ``searchsorted``, sums as differences of int64 prefix sums.

    codes [N] int32, sel [N] bool, rows [N] int64 ascending stream
    positions, vals: tuple of [N] int64 value vectors, ops: per-val
    AGG_SUM/MIN/MAX.

    Returns (counts [K] i64, first [K] i64 with a 2^62 sentinel, outs):
    - sums are differences of wrapping int64 prefix sums, so each equals
      the true segment sum mod 2^64, as the generic engine's wrapping adds
      give it;
    - min/max take the first/last element of each segment sorted by
      (code, value) (a stable sort by value, then by code); empty segments
      hold +-2^62.
    Since ``rows`` ascend, one stable sort by code orders (code, row)."""
    n = codes.shape[0]
    dev = codes.device
    big = torch.full((), _INT64_BIG, dtype=torch.int64, device=dev)
    key = torch.where(sel, codes.to(torch.int64), num_codes)
    order = torch.sort(key, stable=True).indices
    key_s = key[order]
    rows_s = rows[order]
    ks = torch.arange(num_codes, dtype=torch.int64, device=dev)
    start = torch.searchsorted(key_s, ks, side="left")
    end = torch.searchsorted(key_s, ks, side="right")
    counts = end - start
    has = counts > 0
    first = torch.where(has, rows_s[torch.clamp(start, max=n - 1)], big)
    live = key_s < num_codes
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    outs: list = [None] * len(ops)
    for i, op in enumerate(ops):
        v = vals[i]
        if op == AGG_SUM:
            ps = torch.cumsum(torch.where(live, v[order], zero), 0)
            ps0 = torch.cat([zero.reshape(1), ps])
            outs[i] = ps0[end] - ps0[start]
            continue
        by_v = torch.sort(v, stable=True).indices
        order2 = by_v[torch.sort(key[by_v], stable=True).indices]
        v2 = v[order2]
        if op == AGG_MIN:
            outs[i] = torch.where(has, v2[torch.clamp(start, max=n - 1)], big)
        else:
            outs[i] = torch.where(has, v2[torch.clamp(end - 1, min=0)], -big)
    return counts, first, tuple(outs)


# Unselected rows reduce into this many extra segments, row by row, so that
# their atomics on the card do not queue on one address (the time a query
# spent there grew with the unselected rows of the parts it read).
_DUMP_SEGMENTS = 1024


def dense_group_reduce(codes, vals, sel, num_codes: int, op: str):
    """Per-code reduction into a dense [num_codes] table: unselected rows
    reduce into extra segments that are cut off, so no identity competes
    with a selected value; empty codes hold 0 (sum, count) or the dtype's
    extreme (min: its maximum, max: its minimum)."""
    rows = torch.arange(codes.shape[0], device=codes.device)
    dump = num_codes + torch.bitwise_and(rows, _DUMP_SEGMENTS - 1)
    c = torch.where(sel, codes.to(torch.int64), dump)
    n = num_codes + _DUMP_SEGMENTS
    if op == AGG_COUNT:
        return _segment(sel.to(torch.int64), c, n, "sum")[:num_codes]
    if op == AGG_SUM:
        return _segment(torch.where(sel, vals, torch.zeros_like(vals)), c, n, "sum")[:num_codes]
    if op == AGG_MIN:
        return _segment(vals, c, n, "amin")[:num_codes]
    if op == AGG_MAX:
        return _segment(vals, c, n, "amax")[:num_codes]
    raise ValueError(op)


# ---------------------------------------------------------------------------
# Hash-join expansion (the single-device CSR join behind query/join.py)


def join_expand(
    lcodes,
    lkey_valid,
    llive,
    rcodes,
    rkey_valid,
    num_codes: int,
    capacity: int,
    left_outer: bool,
):
    """Expand equi-join matches on shared int key codes in [0, num_codes).

    Build side (right) rows bucket by code through a stable sort (CSR); each
    probe (left) row's matches expand through an exclusive cumsum of per-row
    output counts and a searchsorted over the output index space. Output
    slots are ordered (left row asc, right row asc): the stable sort keeps
    equal codes in right-row order. The right side must hold at least one
    row (callers pad an empty one with an invalid key).

    Returns (total, li, rrow, live, matched) over ``capacity`` slots:
    ``li``/``rrow`` (int32) index the probe/build rows per output slot;
    ``live`` marks slots < total; ``matched`` marks slots with a real build
    match (False only for left_outer's null-extended rows).
    """
    dev = lcodes.device
    n_l = lcodes.shape[0]
    n_r = rcodes.shape[0]
    rc = rcodes.to(torch.int64)
    safe_r = torch.where(
        rkey_valid & (rc >= 0) & (rc < num_codes),
        rc,
        torch.full_like(rc, num_codes),
    )
    perm = torch.sort(safe_r, stable=True).indices
    counts = torch.bincount(safe_r, minlength=num_codes + 1)[:num_codes]
    starts = torch.cumsum(counts, 0) - counts
    lc = torch.clamp(lcodes.to(torch.int64), 0, num_codes - 1)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    mc = torch.where(lkey_valid & llive, counts[lc], zero)
    if left_outer:
        out_counts = torch.where(llive, torch.clamp(mc, min=1), zero)
    else:
        out_counts = mc
    off = torch.cat([zero.reshape(1), torch.cumsum(out_counts, 0)])
    total = off[-1]
    out_idx = torch.arange(capacity, dtype=torch.int64, device=dev)
    li = torch.clamp(
        torch.searchsorted(off, out_idx, right=True) - 1, 0, n_l - 1
    )
    rank = out_idx - off[li]
    code = lc[li]
    has = mc[li] > 0
    rpos = torch.clamp(starts[code] + rank, 0, n_r - 1)
    rrow = perm[rpos]
    live = out_idx < total
    matched = live & has
    return total, li.to(torch.int32), rrow.to(torch.int32), live, matched
