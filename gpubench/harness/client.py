"""The benchmark's side of the program's public API: a table filled from the
generated rows through ``ColumnStore`` inserts, a query of a mix built with
``LocalEngine``'s builder, and the program's result batches put in the
normalized forms of ``reference/numpy_ref.py``.
"""

from __future__ import annotations

import numpy as np

from frostdb_tpu_torch import schema as S
from frostdb_tpu_torch.columnbatch import Column, ColumnBatch, KIND_DICT, KIND_INT64
from frostdb_tpu_torch.query import expr as E
from frostdb_tpu_torch.table import TableConfig

def fill_table(db, config: dict, batches, dicts: dict):
    """Create the configuration's table and insert each generated batch
    ({column: array}, string columns as codes into ``dicts``) as one
    record, its columns in the configuration's order. A string column's
    dictionary is that of the schema column it belongs to (``labels`` for
    ``labels.node``). The program gets copies of the arrays."""
    table = db.table(config["table"], TableConfig(schema=getattr(S, config["schema"])()))
    luts = {}
    for name in config["columns"]:
        if name in dicts:
            d = table.dictionary(name.split(".")[0])
            luts[name] = (d, d.encode(dicts[name])[0])
    for cols in batches:
        n = len(next(iter(cols.values())))
        ones = np.ones(n, bool)
        columns = []
        for name in config["columns"]:
            if name in luts:
                d, lut = luts[name]
                columns.append(Column(name, KIND_DICT, lut[cols[name]], ones, d))
            else:
                columns.append(Column(name, KIND_INT64, cols[name].copy(), ones))
        table.insert_record(ColumnBatch(columns, n))
    return table


def predicate(p):
    op = p[0]
    if op in ("and", "or"):
        parts = [predicate(c) for c in p[1:]]
        return E.And(*parts) if op == "and" else E.Or(*parts)
    c = E.Col(p[1])
    if op == "regex":
        return c.regex_match(p[2])
    lit = p[2]
    return {
        ">=": c.gt_eq, ">": c.gt, "<=": c.lt_eq, "<": c.lt, "==": c.eq, "!=": c.not_eq,
    }[op](lit)


def _key(k):
    if k[0] == "col":
        return E.Col(k[1])
    if k[0] == "duration":
        return E.Duration(k[1])
    return predicate(k)


_AGG = {"sum": E.Sum, "count": E.Count, "min": E.Min, "max": E.Max}


def build(engine, table: str, query: list):
    """A bound query of a mix as a LocalEngine builder, ready to execute."""
    q = None
    for step in query:
        op = step[0]
        if op == "scan":
            q = engine.scan_table(table)
        elif op == "scan_schema":
            q = engine.scan_schema(table)
        elif op == "filter":
            q = q.filter(predicate(step[1]))
        elif op == "aggregate":
            q = q.aggregate([_AGG[f](E.Col(c)) for f, c in step[1]], [_key(k) for k in step[2]])
        elif op == "distinct":
            q = q.distinct(*[_key(k) for k in step[1]])
        elif op == "project":
            q = q.project(*[E.Col(c) for c in step[1]])
        elif op == "limit":
            q = q.limit(E.Literal(step[1]))
        else:
            raise ValueError(f"unknown step {op!r}")
    return q


def _decoded(col) -> list:
    """A result column's values as Python objects, strings decoded and
    invalid slots None."""
    vals = np.asarray(col.values)
    valid = np.asarray(col.validity, bool)
    if col.dictionary is not None:
        strings = np.asarray(col.dictionary.values, dtype=object)
        out = strings[vals].tolist()
    elif vals.dtype == bool:
        out = [bool(v) for v in vals]
    else:
        out = vals.tolist()
    return [v if ok else None for v, ok in zip(out, valid)]


def _coded(col, strings: list) -> np.ndarray:
    """A result column as int64 for a row matrix: a string column as the
    string's index in the benchmark's dictionary ``strings`` (-1 if absent,
    -2 where invalid), any other column as its value."""
    vals = np.asarray(col.values)
    valid = np.asarray(col.validity, bool)
    if col.dictionary is not None:
        index = {s: i for i, s in enumerate(strings)}
        lut = np.array([index.get(s, -1) for s in col.dictionary.values] or [-1], np.int64)
        out = lut[vals]
    else:
        out = vals.astype(np.int64)
    return np.where(valid, out, -2)


def normalize(query: list, batches: list, dicts: dict):
    """The program's result batches in the reference's normalized form."""
    from reference.numpy_ref import sort_rows

    shape = next(s for s in query if s[0] in ("aggregate", "distinct", "project"))
    limit = next((s[1] for s in query if s[0] == "limit"), None)
    batches = [b for b in batches if b.num_rows]
    if shape[0] == "project":
        names = shape[1]
        if not batches:
            m = np.zeros((0, len(names)), np.int64)
        else:
            m = np.concatenate([
                np.stack([_coded(b.column(n), dicts.get(n, [])) if b.column(n) is not None
                          else np.full(b.num_rows, -3, np.int64) for n in names], axis=1)
                for b in batches
            ])
        m = sort_rows(m)
        return ("rows", m) if limit is None else ("rows_limit", m, limit)
    rows = []
    for b in batches:
        cols = [_decoded(c) for c in b.columns]
        rows.extend(zip(*cols))
    if shape[0] == "distinct":
        return ("distinct", sorted(rows, key=repr))
    nk = len(shape[2])
    out = {}
    for r in rows:
        key = tuple(r[:nk])
        if key in out:
            out[key] = ("duplicate group",)
        else:
            out[key] = tuple(r[nk:])
    return ("groups", out)
