"""examples_torch/simple — insert rows with dynamic label columns, then query
with a projection + filter (reference: examples/simple/simple.go:17-69).

Run: python examples_torch/simple.py [--device cpu]

The PyTorch port of examples/simple.py: the same rows and queries
through frostdb_tpu_torch, on the GPU unless --device says otherwise.
"""

import sys

sys.path.insert(0, ".")

from frostdb_tpu_torch import ColumnStore, TableConfig
from frostdb_tpu_torch.columnbatch import ColumnBatch
from frostdb_tpu_torch.logictest import format_column
from frostdb_tpu_torch.query import expr as E
from frostdb_tpu_torch.query.engine import LocalEngine
from frostdb_tpu_torch.schema import (
    ColumnDef,
    SchemaDef,
    SortingColumnDef,
    StorageLayout,
    TYPE_INT64,
    TYPE_STRING,
    ENCODING_RLE_DICTIONARY,
)

import numpy as np


def simple_schema() -> SchemaDef:
    # reference: examples/simple simpleSchema — names + values.* dynamic
    return SchemaDef(
        name="simple_schema",
        columns=(
            ColumnDef(
                "names",
                StorageLayout(
                    TYPE_STRING, nullable=True, encoding=ENCODING_RLE_DICTIONARY
                ),
                dynamic=True,
            ),
            ColumnDef("value", StorageLayout(TYPE_INT64)),
        ),
        sorting_columns=(SortingColumnDef("names", "asc", nulls_first=True),),
    )


def main(device: str = "cuda") -> None:
    store = ColumnStore(device=device)
    db = store.db("simple_db")
    table = db.table("simple_table", TableConfig(schema=simple_schema()))

    from frostdb_tpu_torch.columnbatch import Column, KIND_DICT, KIND_INT64

    d = table.dictionary("names")
    rows = [
        {"names.firstname": "Frederic", "names.surname": "Brancz", "value": 10},
        {"names.firstname": "Thor", "names.surname": "Hansen", "value": 20},
        {"names.firstname": "Matthias", "names.surname": "Loibl", "value": 30},
    ]
    n = len(rows)
    cols = []
    for name in ("names.firstname", "names.surname"):
        codes, valid = d.encode([r.get(name) for r in rows])
        cols.append(Column(name, KIND_DICT, codes, valid, d))
    cols.append(
        Column(
            "value",
            KIND_INT64,
            np.asarray([r["value"] for r in rows], dtype=np.int64),
            np.ones(n, dtype=bool),
        )
    )
    table.insert_record(ColumnBatch(cols, n), sort=True)

    engine = LocalEngine(db.table_provider())

    def print_batch(batch):
        col_strs = [format_column(c) for c in batch.columns]
        print("\t".join(c.name for c in batch.columns))
        for i in range(batch.num_rows):
            print("\t".join(cs[i] for cs in col_strs))

    print("-- select names where names.firstname == 'Frederic'")
    engine.scan_table("simple_table").filter(
        E.Col("names.firstname").eq("Frederic")
    ).project(E.DynCol("names")).execute(print_batch)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    main(ap.parse_args().device)
