"""Typed record ingestion: Python objects -> column batches + schema.

The analogue of the reference's reflection-based record builder
(internal/records/record_builder.go: Go structs with ``frostdb:`` tags ->
Arrow records; GenericTable[T] table.go:237). Here, dataclasses (or plain
dicts) declare the shape: ``dict``-typed fields become dynamic column
families, scalar fields become concrete columns, and field metadata carries
the tag options (rle_dict, asc(n), null_first, prehash).

Example:

    @dataclass
    class Sample:
        example_type: str = field(metadata={"rle_dict": True, "asc": 0})
        labels: dict = field(metadata={"rle_dict": True, "asc": 1,
                                       "null_first": True})
        timestamp: int = field(metadata={"asc": 2})
        value: int = 0

    schema = schema_for(Sample)
    batch = build_batch(table, [Sample(...), ...])
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np

from .columnbatch import (
    Column,
    ColumnBatch,
    KIND_BOOL,
    KIND_DICT,
    KIND_FLOAT64,
    KIND_INT64,
)
from .schema import (
    ColumnDef,
    SchemaDef,
    SortingColumnDef,
    StorageLayout,
    ENCODING_RLE_DICTIONARY,
    ENCODING_PLAIN,
    TYPE_BOOL,
    TYPE_DOUBLE,
    TYPE_INT64,
    TYPE_STRING,
)

_PY_TYPE_TO_STORAGE = {
    str: TYPE_STRING,
    int: TYPE_INT64,
    float: TYPE_DOUBLE,
    bool: TYPE_BOOL,
}


def schema_for(cls) -> SchemaDef:
    """Derive a SchemaDef from a dataclass (reference: internal/records
    ``Schema`` record_builder.go:315 generates the proto schema from T)."""
    assert dataclasses.is_dataclass(cls), "schema_for requires a dataclass"
    columns: list[ColumnDef] = []
    sorting: list[tuple[int, SortingColumnDef]] = []
    for f in dataclasses.fields(cls):
        md = dict(f.metadata or {})
        name = md.get("name", f.name)
        dynamic = False
        t = f.type
        if t in ("dict", dict) or (isinstance(t, str) and t.startswith("dict")):
            dynamic = True
            storage_type = TYPE_STRING
        else:
            py = t
            if isinstance(t, str):
                py = {"str": str, "int": int, "float": float, "bool": bool}.get(
                    t, str
                )
            storage_type = _PY_TYPE_TO_STORAGE.get(py, TYPE_STRING)
        encoding = (
            ENCODING_RLE_DICTIONARY if md.get("rle_dict") else ENCODING_PLAIN
        )
        columns.append(
            ColumnDef(
                name,
                StorageLayout(
                    storage_type,
                    nullable=dynamic or md.get("nullable", False),
                    encoding=encoding,
                ),
                dynamic=dynamic,
                prehash=md.get("prehash", False),
            )
        )
        if "asc" in md or "desc" in md:
            order = md.get("asc", md.get("desc"))
            sorting.append(
                (
                    order,
                    SortingColumnDef(
                        name,
                        "asc" if "asc" in md else "desc",
                        nulls_first=md.get("null_first", False),
                    ),
                )
            )
    sorting.sort(key=lambda p: p[0])
    return SchemaDef(
        name=cls.__name__.lower(),
        columns=tuple(columns),
        sorting_columns=tuple(s for _o, s in sorting),
    )


def build_batch(table, rows: Sequence[Any]) -> ColumnBatch:
    """Build a batch from dataclass instances or dicts, using the table's
    schema and global dictionaries (reference: records.Build[T].Append,
    record_builder.go:251)."""
    schema = table.schema()
    n = len(rows)

    def get(row, name):
        if isinstance(row, Mapping):
            return row.get(name)
        return getattr(row, name, None)

    # discover dynamic columns present
    dyn_cols: dict[str, list[str]] = {}
    for cdef in schema.columns():
        if not cdef.dynamic:
            continue
        seen: set[str] = set()
        for row in rows:
            v = get(row, cdef.name)
            if isinstance(v, Mapping):
                seen.update(v.keys())
        dyn_cols[cdef.name] = sorted(seen)

    concrete = schema.concrete_columns(dyn_cols)
    cols: list[Column] = []
    for full_name, cdef in concrete:
        fam, sub = (
            full_name.split(".", 1) if "." in full_name else (full_name, None)
        )
        values: list[Any] = []
        for row in rows:
            if sub is None:
                values.append(get(row, full_name))
            else:
                m = get(row, fam)
                values.append(m.get(sub) if isinstance(m, Mapping) else None)
        t = cdef.layout.type
        if cdef.layout.repeated:
            # Python sequences -> list columns (reference: internal/records
            # slices->lists, record_builder.go).
            from .columnbatch import KIND_LIST, _element_hashes, list_row_hashes

            valid = np.array([v is not None for v in values], dtype=bool)
            flat: list[Any] = []
            offsets = np.zeros(len(values) + 1, dtype=np.int64)
            for i, v in enumerate(values):
                if v is not None:
                    flat.extend(v)
                offsets[i + 1] = len(flat)
            if t == TYPE_STRING:
                d = table.dictionary(fam)
                codes, cvalid = d.encode(
                    [None if e is None else str(e) for e in flat]
                )
                child = Column("item", KIND_DICT, codes, cvalid, d)
            else:
                cvalid = np.array([e is not None for e in flat], dtype=bool)
                cvals = np.array(
                    [int(e) if e is not None else 0 for e in flat],
                    dtype=np.int64,
                )
                child = Column("item", KIND_INT64, cvals, cvalid)
            hashes = list_row_hashes(offsets, _element_hashes(child), valid)
            cols.append(
                Column(
                    full_name, KIND_LIST, hashes, valid, None, cdef.layout,
                    offsets=offsets, child=child,
                )
            )
        elif t == TYPE_STRING:
            d = table.dictionary(fam)
            codes, valid = d.encode(
                [None if v is None else str(v) for v in values]
            )
            cols.append(Column(full_name, KIND_DICT, codes, valid, d))
        elif t == TYPE_BOOL:
            valid = np.array([v is not None for v in values], dtype=bool)
            vals = np.array([bool(v) if v else False for v in values], dtype=bool)
            cols.append(Column(full_name, KIND_BOOL, vals, valid))
        elif t == TYPE_DOUBLE:
            valid = np.array([v is not None for v in values], dtype=bool)
            vals = np.array(
                [float(v) if v is not None else 0.0 for v in values],
                dtype=np.float64,
            )
            cols.append(Column(full_name, KIND_FLOAT64, vals, valid))
        else:
            valid = np.array([v is not None for v in values], dtype=bool)
            vals = np.array(
                [int(v) if v is not None else 0 for v in values], dtype=np.int64
            )
            cols.append(Column(full_name, KIND_INT64, vals, valid))
    return ColumnBatch(cols, n)


class GenericTable:
    """Typed wrapper over a Table (reference: GenericTable[T] table.go:232)."""

    def __init__(self, table, cls):
        self.table = table
        self.cls = cls

    def write(self, *rows) -> int:
        batch = build_batch(self.table, list(rows))
        return self.table.insert_record(batch, sort=True)
