"""Carry a table's state across from plain numpy arrays.

``table_from_numpy`` rebuilds a table in this package from exported
columns, so another implementation's table (or a saved one) can be queried
here with the same dictionary codes, the same part boundaries and the same
scan order — and so the same group emission order.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from .columnbatch import Column, ColumnBatch, KIND_DICT, KIND_LIST
from .schema import SchemaDef
from .table import Table, TableConfig


def table_from_numpy(
    db,
    name: str,
    schema_def: SchemaDef,
    dictionaries: Mapping[str, Sequence[str]],
    parts: Sequence[Mapping[str, tuple]],
) -> Table:
    """Create table ``name`` in ``db`` holding ``parts``.

    ``dictionaries`` maps each column family (the name before the first
    ``.``) to its values in code order. ``parts`` lists the visible parts in
    scan order (newest first, as ``Table.collect_parts`` returns them); each
    maps column name -> ``(kind, values, validity)``. Every part is inserted
    as its own record, unsorted, oldest first, so codes, part boundaries and
    scan order match the source."""
    t = db.table(name, TableConfig(schema=schema_def))
    if t.collect_parts(db.high_watermark()):
        raise ValueError(f"table {name} already holds parts")
    for family, values in dictionaries.items():
        d = t.dictionary(family)
        if len(d):
            raise ValueError(f"dictionary {family} is not empty")
        codes, _valid = d.encode(list(values))
        if not np.array_equal(codes, np.arange(len(values))):
            raise ValueError(f"dictionary {family} has repeated values")
    for cols in reversed(list(parts)):
        out = []
        n = None
        for col_name, (kind, values, validity) in cols.items():
            if kind == KIND_LIST:
                raise ValueError("list columns are not carried across")
            dictionary = (
                t.dictionary(col_name.split(".", 1)[0])
                if kind == KIND_DICT
                else None
            )
            values = np.asarray(values)
            n = len(values) if n is None else n
            out.append(
                Column(col_name, kind, values, np.asarray(validity), dictionary)
            )
        t.insert_record(ColumnBatch(out, n or 0), sort=False)
    t.sync()
    return t
