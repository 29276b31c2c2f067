"""frostdb_tpu_torch — the PyTorch + CUDA port of frostdb_tpu.

An embeddable wide-column columnar database (the design of
polarsignals/frostdb): dictionary-coded string columns, dynamic columns,
an LSM of immutable parts under snapshot isolation, and a query engine
whose hot shape — filter + group-by aggregate — runs on hand-written CUDA
kernels (``ops/agg_kernels.py``, ``csrc/agg.cu``).

Module paths mirror ``frostdb_tpu/``, the JAX package this port is held
against. This package imports torch and never jax, and nothing of
``frostdb_tpu``.

Device: ``ColumnStore(device=...)`` picks the torch device every table
lives on. The default is ``"cuda"``, which raises when no GPU is visible;
pass ``device="cpu"`` to run on the CPU.

Ported so far: in-memory tables, the planner and generic operator DAG, and
the ``compiled`` serving tier. Persistence, joins, the other serving tiers,
SQL, the plan protocol and multi-device execution are not ported yet.
"""

from .schema import (
    SchemaDef,
    ColumnDef,
    StorageLayout,
    SortingColumnDef,
    Schema,
    sample_definition,
    sample_definition_with_float,
    prehashed_sample_definition,
)
from .columnbatch import ColumnBatch, Dictionary
from .db import ColumnStore, DB
from .table import Table, TableConfig

__all__ = [
    "SchemaDef",
    "ColumnDef",
    "StorageLayout",
    "SortingColumnDef",
    "Schema",
    "sample_definition",
    "sample_definition_with_float",
    "prehashed_sample_definition",
    "ColumnBatch",
    "Dictionary",
    "ColumnStore",
    "DB",
    "Table",
    "TableConfig",
]

__version__ = "0.1.0"
