"""examples_torch/aggregations — sum(value) grouped by a dynamic label column
(reference: examples/aggregations/aggregations.go).

Run: python examples_torch/aggregations.py [--device cpu]

The PyTorch port of examples/aggregations.py: the same rows and queries
through frostdb_tpu_torch, on the GPU unless --device says otherwise.
"""

import sys

sys.path.insert(0, ".")

import numpy as np

from frostdb_tpu_torch import ColumnStore, TableConfig
from frostdb_tpu_torch.columnbatch import Column, ColumnBatch, KIND_DICT, KIND_INT64
from frostdb_tpu_torch.logictest import format_column
from frostdb_tpu_torch.query import expr as E
from frostdb_tpu_torch.query.engine import LocalEngine
from frostdb_tpu_torch.schema import sample_definition


def main(device: str = "cuda") -> None:
    store = ColumnStore(device=device)
    db = store.db("agg_db")
    table = db.table("metrics", TableConfig(schema=sample_definition()))

    d_et = table.dictionary("example_type")
    d_labels = table.dictionary("labels")
    d_st = table.dictionary("stacktrace")

    labels = ["node1", "node2", "node1", "node3", "node2", "node1"]
    values = [3, 5, 2, 9, 1, 4]
    n = len(values)
    et_codes, et_valid = d_et.encode(["cpu"] * n)
    l_codes, l_valid = d_labels.encode(labels)
    st_codes, st_valid = d_st.encode(["stack"] * n)
    batch = ColumnBatch(
        [
            Column("example_type", KIND_DICT, et_codes, et_valid, d_et),
            Column("labels.node", KIND_DICT, l_codes, l_valid, d_labels),
            Column("stacktrace", KIND_DICT, st_codes, st_valid, d_st),
            Column(
                "timestamp",
                KIND_INT64,
                np.arange(1, n + 1, dtype=np.int64),
                np.ones(n, dtype=bool),
            ),
            Column(
                "value",
                KIND_INT64,
                np.asarray(values, dtype=np.int64),
                np.ones(n, dtype=bool),
            ),
        ],
        n,
    )
    table.insert_record(batch, sort=True)

    engine = LocalEngine(db.table_provider())

    def print_batch(b):
        col_strs = [format_column(c) for c in b.columns]
        print("\t".join(c.name for c in b.columns))
        for i in range(b.num_rows):
            print("\t".join(cs[i] for cs in col_strs))

    print("-- select labels.node, sum(value) group by labels.node")
    engine.scan_table("metrics").aggregate(
        [E.Sum(E.Col("value"))], [E.Col("labels.node")]
    ).execute(print_batch)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    main(ap.parse_args().device)
