"""The plain reference: a query of a traffic mix answered with numpy over the
generated rows.

It reads only the benchmark's own arrays (``harness/datagen.py``) and the
query as data. It knows nothing of the program: not its parts, its sort
order, its padding or its dictionaries' codes. Its answers are in the
normalized forms ``harness/judge.py`` compares:

- an aggregation: ``("groups", {key tuple: aggregate tuple})``, every group
  with a selected row, keys decoded (strings, window starts, booleans);
- a distinct: ``("distinct", [key tuple, ...])`` sorted, each once;
- a projection: ``("rows", matrix)``, one int64 row per selected row, a
  string column holding the string's index in the benchmark's dictionary,
  rows sorted (scan order is not part of the result); with a limit
  ``("rows_limit", matrix of every matching row, limit)``.

Sums add row by row in int64, exactly; ``sum_dtype`` adds in another type
instead (the control: ``float32`` where the program must give exact int64
sums). These are the semantics of ``chip_smoke.py``'s ``host_reference``,
``dense_reference`` and ``scan_reference_ok``, made general over the
mixes' query steps and free of the program's group and scan order.
"""

from __future__ import annotations

import re

import numpy as np

_CMP = {
    ">=": np.greater_equal, ">": np.greater, "<=": np.less_equal,
    "<": np.less, "==": np.equal, "!=": np.not_equal,
}
_DIRECT_KEYS = 1 << 24


class Frame:
    """Columns of equal length: ``cols[name]`` an array, ``dicts[name]``
    the strings of a coded column."""

    def __init__(self, cols: dict, dicts: dict):
        self.cols = cols
        self.dicts = dicts

    def __len__(self) -> int:
        return len(next(iter(self.cols.values())))


def mask(pred, frame: Frame) -> np.ndarray:
    """The rows of ``frame`` that ``pred`` selects."""
    op = pred[0]
    if op in ("and", "or"):
        parts = [mask(p, frame) for p in pred[1:]]
        out = parts[0]
        for p in parts[1:]:
            out = (out & p) if op == "and" else (out | p)
        return out
    col = pred[1]
    values = frame.cols[col]
    if op == "regex":
        rx = re.compile(pred[2])
        hit = np.array([rx.search(s) is not None for s in frame.dicts[col]], bool)
        return hit[values]
    lit = pred[2]
    if col in frame.dicts:
        if op not in ("==", "!="):
            raise ValueError(f"{op} on the string column {col}")
        strings = frame.dicts[col]
        code = strings.index(lit) if lit in strings else -1
        return _CMP[op](values, code)
    return _CMP[op](values, lit)


def columns_used(pred) -> set:
    if pred[0] in ("and", "or"):
        return set().union(*(columns_used(p) for p in pred[1:]))
    return {pred[1]}


def table_frame(rows) -> Frame:
    return Frame(dict(rows.columns), dict(rows.dicts))


def schema_frame(rows) -> Frame:
    """The table's schema as rows: one per concrete column, its name."""
    names = list(rows.columns)
    return Frame({"name": np.arange(len(names))}, {"name": names})


def _key(key, frame: Frame, sel):
    """(values of the key over the selected rows, decode) for one key."""
    if key[0] == "col":
        v = frame.cols[key[1]][sel]
        if key[1] in frame.dicts:
            strings = frame.dicts[key[1]]
            return v.astype(np.int64), lambda c: strings[c]
        return v.astype(np.int64), int
    if key[0] == "duration":
        w = key[1]
        return frame.cols["timestamp"][sel] // w, lambda c: c * w
    return mask(key, frame)[sel].astype(np.int64), bool


def _group_ids(keys):
    """One id per row for the tuple of keys (mixed radix over each key's
    range), the number of ids, and split(id) -> the tuple of key values."""
    radix, lows, ids = [], [], None
    for v, _ in keys:
        lo = int(v.min()) if len(v) else 0
        r = (int(v.max()) if len(v) else 0) - lo + 1
        v = v - lo if lo else v
        ids = v if ids is None else ids * r + v
        radix.append(r)
        lows.append(lo)
    n_ids = int(np.prod(radix, dtype=object))
    if n_ids > _DIRECT_KEYS:
        raise ValueError(f"{n_ids} key combinations: past the reference's direct count")

    def split(i):
        out = []
        for r, lo in zip(reversed(radix), reversed(lows)):
            out.append(i % r + lo)
            i //= r
        return tuple(reversed(out))

    return ids, n_ids, split


def _aggregate(frame, sel, aggs, keys, sum_dtype):
    kv = [_key(k, frame, sel) for k in keys]
    ids, n_ids, split = _group_ids(kv)
    counts = np.bincount(ids, minlength=n_ids)
    present = np.flatnonzero(counts)
    cols = []
    for func, col in aggs:
        x = frame.cols[col][sel]
        if func == "count":
            cols.append(counts[present])
        elif func == "sum":
            acc = np.zeros(n_ids, sum_dtype or np.int64)
            np.add.at(acc, ids, x.astype(acc.dtype))
            cols.append(acc[present].astype(np.int64))
        elif func in ("min", "max"):
            big = np.iinfo(np.int64)
            acc = np.full(n_ids, big.max if func == "min" else big.min, np.int64)
            (np.minimum if func == "min" else np.maximum).at(acc, ids, x.astype(np.int64))
            cols.append(acc[present])
        else:
            raise ValueError(f"unknown aggregation {func!r}")
    decoders = [d for _, d in kv]
    out = {}
    for j, g in enumerate(present.tolist()):
        raw = split(g)
        out[tuple(d(int(r)) for d, r in zip(decoders, raw))] = tuple(int(c[j]) for c in cols)
    return out


def _distinct(frame, sel, keys):
    kv = [_key(k, frame, sel) for k in keys]
    ids, n_ids, split = _group_ids(kv)
    present = np.flatnonzero(np.bincount(ids, minlength=n_ids))
    decoders = [d for _, d in kv]
    return [tuple(d(int(r)) for d, r in zip(decoders, split(g))) for g in present.tolist()]


def sort_rows(matrix: np.ndarray) -> np.ndarray:
    """Rows in lexicographic order."""
    if len(matrix) == 0:
        return matrix
    return matrix[np.lexsort(matrix.T[::-1])]


def answer(query: list, rows, sum_dtype=None):
    """The normalized answer of a bound query over ``rows``. A filter after
    a distinct reads only the distinct's keys, so it selects rows before
    it as well."""
    frame, sel, shape, limit = None, None, None, None
    for step in query:
        op = step[0]
        if op in ("scan", "scan_schema"):
            frame = table_frame(rows) if op == "scan" else schema_frame(rows)
            sel = np.ones(len(frame), bool)
        elif op == "filter":
            if shape is not None and shape[0] != "distinct":
                raise ValueError("a filter after an aggregation or a projection")
            sel = sel & mask(step[1], frame)
        elif op in ("aggregate", "distinct", "project"):
            shape = step
        elif op == "limit":
            limit = int(step[1])
        else:
            raise ValueError(f"unknown step {op!r}")
    if shape[0] == "aggregate":
        return ("groups", _aggregate(frame, sel, shape[1], shape[2], sum_dtype))
    if shape[0] == "distinct":
        return ("distinct", sorted(_distinct(frame, sel, shape[1]), key=repr))
    m = sort_rows(np.stack([frame.cols[c][sel].astype(np.int64) for c in shape[1]], axis=1))
    return ("rows", m) if limit is None else ("rows_limit", m, limit)
