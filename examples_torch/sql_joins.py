"""examples_torch/sql_joins — the north-star SQL surface: FROM/JOIN, IN lists,
GROUP BY, ORDER BY and LIMIT through the SQL frontend, served by the
engine's fast tiers (the groupjoin fusion for the join + aggregate).

The reference has no SQL JOIN or ORDER BY at all (its sqlparse covers the
TiDB subset the logictests use); this surface is built on the engine's
first-class join and Sorter operator.

Run: python examples_torch/sql_joins.py [--device cpu]

The PyTorch port of examples/sql_joins.py: the same rows and queries
through frostdb_tpu_torch, on the GPU unless --device says otherwise.
"""

import sys

sys.path.insert(0, ".")

import numpy as np

from frostdb_tpu_torch import ColumnStore, TableConfig
from frostdb_tpu_torch.columnbatch import Column, ColumnBatch, KIND_DICT, KIND_INT64
from frostdb_tpu_torch.logictest import format_column
from frostdb_tpu_torch.query.engine import LocalEngine
from frostdb_tpu_torch.schema import (
    ColumnDef,
    ENCODING_RLE_DICTIONARY,
    SchemaDef,
    SortingColumnDef,
    StorageLayout,
    TYPE_INT64,
    TYPE_STRING,
    sample_definition,
)
from frostdb_tpu_torch.sqlparse import Parser


def main(device: str = "cuda") -> None:
    store = ColumnStore(device=device)
    db = store.db("example")

    # facts: Parca-style samples with a dynamic label column
    facts = db.table("samples", TableConfig(schema=sample_definition()))
    d = facts.dictionary("labels")
    rng = np.random.default_rng(0)
    n = 10_000
    codes, valid = d.encode(
        [f"node-{int(i)}" for i in rng.integers(0, 8, n)]
    )
    facts.insert_record(
        ColumnBatch(
            [
                Column("labels.node", KIND_DICT, codes, valid, d),
                Column(
                    "timestamp",
                    KIND_INT64,
                    rng.integers(0, 1000, n).astype(np.int64),
                    np.ones(n, bool),
                ),
                Column(
                    "value",
                    KIND_INT64,
                    rng.integers(0, 100, n).astype(np.int64),
                    np.ones(n, bool),
                ),
            ],
            n,
        ),
        sort=True,
    )

    # dims: per-node weights (the build side of the join)
    dims = db.table(
        "nodes",
        TableConfig(
            schema=SchemaDef(
                "nodes",
                (
                    ColumnDef(
                        "labels.node",
                        StorageLayout(
                            TYPE_STRING,
                            nullable=True,
                            encoding=ENCODING_RLE_DICTIONARY,
                        ),
                    ),
                    ColumnDef("weight", StorageLayout(TYPE_INT64)),
                ),
                (SortingColumnDef("labels.node", "asc", True),),
            )
        ),
    )
    dd = dims.dictionary("labels")
    dcodes, dvalid = dd.encode([f"node-{i}" for i in range(0, 8, 2)])
    m = len(dcodes)
    dims.insert_record(
        ColumnBatch(
            [
                Column("labels.node", KIND_DICT, dcodes, dvalid, dd),
                Column(
                    "weight",
                    KIND_INT64,
                    np.arange(m, dtype=np.int64) * 10 + 5,
                    np.ones(m, bool),
                ),
            ],
            m,
        )
    )

    engine = LocalEngine(db.table_provider())
    queries = [
        # join + aggregate: served by the groupjoin fusion tier
        "select sum(weight) as total, labels.node from samples"
        " inner join nodes on labels.node"
        " group by labels.node order by labels.node",
        # IN list + band filter, sorted aggregate output with a limit
        "select sum(value) as v, labels.node from samples"
        " where labels.node in ('node-1', 'node-3', 'node-5')"
        " and timestamp >= 100 and timestamp < 900"
        " group by labels.node order by v desc limit 2",
        # anti join: rows whose label has NO dims entry
        "select count(value), labels.node from samples"
        " anti join nodes using (labels.node) group by labels.node"
        " order by labels.node",
    ]
    for sql in queries:
        print(f"\n> {sql}")
        res = Parser().parse(engine.scan_table("samples"), ["labels"], sql)
        out = []
        res.plan.execute(out.append)
        for b in out:
            cols = [format_column(c) for c in b.columns]
            for i in range(b.num_rows):
                print("  " + "  ".join(col[i] for col in cols))
        print(f"  [served by: {engine.last_serving_path}]")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    main(ap.parse_args().device)
