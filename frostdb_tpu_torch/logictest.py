"""SQL logic test runner (reference: logictest/runner.go; the JAX package's
frostdb_tpu/logictest.py, copied with its imports rewritten).

Parses cockroachdb/datadriven golden files (the reference's
logictest/testdata format) and executes them against this engine. Output
formatting reproduces Go's text/tabwriter with the runner's parameters
(minwidth=8, tabwidth=8, padding=2, padchar=' '; runner.go:330-338) and the
per-type value formatting of arrayToStringVals (runner.go:405+).
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .columnbatch import Column, ColumnBatch, KIND_BOOL, KIND_DICT, KIND_FLOAT64, KIND_INT64, KIND_UINT64, kind_for_layout
from .query.engine import LocalEngine
from .query.physical import ExecOptions
from .schema import (
    ColumnDef,
    Schema,
    SchemaDef,
    SortingColumnDef,
    StorageLayout,
    sample_definition_with_float,
    prehashed_sample_definition,
    TYPE_BOOL,
    TYPE_INT64,
    TYPE_STRING,
    TYPE_UINT64,
    ENCODING_RLE_DICTIONARY,
    ENCODING_DELTA_LENGTH_BYTE_ARRAY,
    COMPRESSION_LZ4_RAW,
)
from .sqlparse import Parser
from .table import TableConfig

NULL_STRING = "null"


# ---------------------------------------------------------------------------
# Schemas registered by the reference's logic_test.go:41-160.


def _simple_bool_schema() -> SchemaDef:
    return SchemaDef(
        name="simple_bool",
        columns=(
            ColumnDef("name", StorageLayout(TYPE_STRING, encoding=ENCODING_RLE_DICTIONARY)),
            ColumnDef("found", StorageLayout(TYPE_BOOL)),
        ),
        sorting_columns=(SortingColumnDef("found", "asc"),),
    )


def _bytes_schema() -> SchemaDef:
    return SchemaDef(
        name="test",
        columns=(
            ColumnDef(
                "labels",
                StorageLayout(
                    TYPE_STRING, nullable=True, encoding=ENCODING_RLE_DICTIONARY
                ),
                dynamic=True,
            ),
            ColumnDef("timestamp", StorageLayout(TYPE_UINT64)),
            ColumnDef(
                "value",
                StorageLayout(
                    TYPE_STRING,
                    encoding=ENCODING_DELTA_LENGTH_BYTE_ARRAY,
                    compression=COMPRESSION_LZ4_RAW,
                ),
            ),
        ),
        sorting_columns=(
            SortingColumnDef("labels", "asc", nulls_first=True),
            SortingColumnDef("timestamp", "asc"),
        ),
    )


def default_schemas() -> dict[str, SchemaDef]:
    return {
        "default": sample_definition_with_float(),
        "simple_bool": _simple_bool_schema(),
        "prehashed": prehashed_sample_definition(),
        "bytes": _bytes_schema(),
    }


# ---------------------------------------------------------------------------
# datadriven file parsing


@dataclass
class Directive:
    cmd: str
    args: list[tuple[str, list[str]]]
    input: str
    expected: str
    line: int


def parse_datadriven(text: str) -> list[Directive]:
    lines = text.split("\n")
    directives: list[Directive] = []
    i = 0
    n = len(lines)
    while i < n:
        line = lines[i]
        if line.strip() == "" or line.lstrip().startswith("#"):
            i += 1
            continue
        cmd_line_no = i + 1
        cmd_parts = _split_cmd_line(line)
        cmd = cmd_parts[0]
        args = [_parse_arg(a) for a in cmd_parts[1:]]
        i += 1
        input_lines = []
        while i < n and lines[i] != "----":
            input_lines.append(lines[i])
            i += 1
        if i < n:
            i += 1  # skip ----
        expected_lines = []
        while i < n and lines[i].strip() != "":
            expected_lines.append(lines[i])
            i += 1
        # strip comment-only lines inside expected (the goldens embed TODO
        # comments between ---- and output in a few places)
        directives.append(
            Directive(
                cmd=cmd,
                args=args,
                input="\n".join(input_lines),
                expected="\n".join(expected_lines),
                line=cmd_line_no,
            )
        )
    return directives


def _split_cmd_line(line: str) -> list[str]:
    # split on whitespace, but keep parenthesized arg values together
    parts: list[str] = []
    cur = ""
    depth = 0
    for ch in line:
        if ch.isspace() and depth == 0:
            if cur:
                parts.append(cur)
                cur = ""
        else:
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
            cur += ch
    if cur:
        parts.append(cur)
    return parts


def _parse_arg(a: str) -> tuple[str, list[str]]:
    if "=" not in a:
        return (a, [])
    k, v = a.split("=", 1)
    if v.startswith("(") and v.endswith(")"):
        vals = [s.strip() for s in v[1:-1].split(",")]
        return (k, vals)
    return (k, [v])


# ---------------------------------------------------------------------------
# Go text/tabwriter emulation (runner.go uses minwidth=8, tabwidth=8,
# padding=2, padchar=' ')


def tabwriter_format(rows: list[str], minwidth: int = 8, padding: int = 2) -> str:
    """rows are "cell\tcell\tlast\n" strings. Cells terminated by a tab are
    padded to the column width = max(minwidth, maxcellwidth+padding); the
    final cell of each line is written verbatim."""
    split_rows = []
    for r in rows:
        r = r.rstrip("\n")
        split_rows.append(r.split("\t"))
    widths: dict[int, int] = {}
    for cells in split_rows:
        for j, cell in enumerate(cells[:-1]):  # last cell not padded
            w = max(minwidth, len(cell) + padding)
            widths[j] = max(widths.get(j, 0), w)
    out_lines = []
    for cells in split_rows:
        line = ""
        for j, cell in enumerate(cells):
            if j < len(cells) - 1:
                line += cell.ljust(widths[j])
            else:
                line += cell
        out_lines.append(line)
    return "\n".join(out_lines) + ("\n" if out_lines else "")


# ---------------------------------------------------------------------------
# Value formatting (runner.go arrayToStringVals)


def format_column(c: Column) -> list[str]:
    out = []
    for i in range(len(c)):
        if not c.validity[i]:
            out.append(NULL_STRING)
            continue
        if c.kind == KIND_DICT:
            out.append(c.dictionary.values[int(c.values[i])])
        elif c.kind == KIND_FLOAT64:
            out.append(f"{float(c.values[i]):f}")
        elif c.kind == KIND_BOOL:
            out.append("true" if c.values[i] else "false")
        else:
            out.append(str(int(c.values[i])))
    return out


# ---------------------------------------------------------------------------
# Runner


class Runner:
    def __init__(self, db, schemas: Optional[dict[str, SchemaDef]] = None):
        """``db`` must expose create_table(name, schema_def) -> table and
        scan_table(name) -> LocalQueryBuilder (reference: logictest DB
        interface, runner.go:60)."""
        self.db = db
        self.schemas = schemas or default_schemas()
        self.active_table = None
        self.active_table_name = ""
        self.active_dyn_cols: list[str] = []
        self.parser = Parser()

    def run_directive(self, d: Directive) -> str:
        try:
            if d.cmd == "createtable":
                return self.handle_create_table(d)
            if d.cmd == "insert":
                return self.handle_insert(d)
            if d.cmd == "exec":
                return self.handle_exec(d)
            raise RuntimeError(f"unknown command {d.cmd}")
        except Exception as e:  # runner returns err.Error() (runner.go:93)
            raise

    # ------------------------------------------------------------------

    def handle_create_table(self, d: Directive) -> str:
        schema_def = None
        for k, vals in d.args:
            if k == "schema":
                schema_def = self.schemas.get(vals[0])
        if schema_def is None:
            raise RuntimeError("createtable: schema not found")
        name = str(uuid.uuid4())
        self.active_table = self.db.create_table(name, schema_def)
        self.active_table_name = name
        self.active_dyn_cols = [
            c.name for c in self.active_table.schema().columns() if c.dynamic
        ]
        return d.expected

    def handle_insert(self, d: Directive) -> str:
        schema: Schema = self.active_table.schema()
        col_names: list[str] = []
        for k, vals in d.args:
            if k == "cols":
                col_names = vals
        if not col_names:
            raise RuntimeError("insert: no input schema provided")

        dyn_cols: dict[str, list[str]] = {}
        for cn in col_names:
            cd = schema.column_by_name(cn)
            if cd is None:
                raise RuntimeError(f"insert: column {cn} not found in schema")
            if "." in cn and cd.dynamic:
                fam, sub = cn.split(".", 1)
                dyn_cols.setdefault(fam, []).append(sub)

        concrete = schema.concrete_columns(dyn_cols)
        rows = []
        for line in d.input.split("\n"):
            vals = line.split()
            if len(vals) != len(col_names):
                raise RuntimeError(
                    f"insert: row ({len(vals)} values) does not match expected"
                    f" schema ({len(col_names)} cols)"
                )
            rows.append(dict(zip(col_names, vals)))

        cols: list[Column] = []
        n = len(rows)
        for full_name, cdef in concrete:
            kind = kind_for_layout(cdef.layout)
            raw = [r.get(full_name) for r in rows]
            parsed = [self._parse_value(v, cdef.layout.type) for v in raw]
            valid = np.array([p is not None for p in parsed], dtype=np.bool_)
            if kind == KIND_DICT:
                fam = full_name.split(".", 1)[0] if cdef.dynamic else full_name
                dct = self.active_table.dictionary(fam)
                codes, valid = dct.encode(parsed)
                cols.append(Column(full_name, KIND_DICT, codes, valid, dct))
            elif kind == KIND_BOOL:
                vals_np = np.array(
                    [bool(p) if p is not None else False for p in parsed],
                    dtype=np.bool_,
                )
                cols.append(Column(full_name, KIND_BOOL, vals_np, valid))
            elif kind == KIND_FLOAT64:
                vals_np = np.array(
                    [float(p) if p is not None else 0.0 for p in parsed],
                    dtype=np.float64,
                )
                cols.append(Column(full_name, KIND_FLOAT64, vals_np, valid))
            elif kind == KIND_UINT64:
                vals_np = np.array(
                    [int(p) if p is not None else 0 for p in parsed],
                    dtype=np.uint64,
                )
                cols.append(Column(full_name, KIND_UINT64, vals_np, valid))
            else:
                vals_np = np.array(
                    [int(p) if p is not None else 0 for p in parsed],
                    dtype=np.int64,
                )
                cols.append(Column(full_name, KIND_INT64, vals_np, valid))

        batch = ColumnBatch(cols, n)
        # Sort by sorting columns (runner.go buf.Sort()).
        sorting = schema.sorting_key_columns(dyn_cols)
        batch = batch.sort_by(sorting)
        self.active_table.insert_record(batch)
        return d.expected

    @staticmethod
    def _parse_value(v: Optional[str], type_: str):
        if v is None or v == NULL_STRING:
            return None
        if type_ == TYPE_STRING:
            return v
        if type_ == TYPE_BOOL:
            if v == "true":
                return True
            if v == "false":
                return False
            raise RuntimeError(f"invalid boolean value: {v}")
        if type_ in (TYPE_INT64, TYPE_UINT64):
            return int(v)
        return float(v)

    # ------------------------------------------------------------------

    def handle_exec(self, d: Directive) -> str:
        unordered = any(k == "unordered" for k, _ in d.args)
        res = self.parser.parse(
            self.db.scan_table(self.active_table_name),
            self.active_dyn_cols,
            d.input,
        )
        if res.explain:
            return res.plan.explain()

        results: list[str] = []

        def cb(batch: ColumnBatch) -> None:
            col_strings = [format_column(c) for c in batch.columns]
            for i in range(batch.num_rows):
                results.append("\t".join(cs[i] for cs in col_strings) + "\n")

        res.plan.execute(cb)
        if unordered:
            results.sort()
        return tabwriter_format(results).rstrip("\n") if results else ""


class LogicTestDB:
    """Adapter over a frostdb_tpu_torch DB for the runner (the reference wires
    frostdb.DB the same way, logictest/logic_test.go:26-39)."""

    def __init__(self, db, exec_options: Optional[ExecOptions] = None):
        self.db = db
        if exec_options is None:
            # logic_test.go:35 passes WithOrderedAggregations; SQL plans
            # still produce HashAggregate because the visitor's
            # pre-projection breaks stream ordering (plan goldens rely on
            # this).
            exec_options = ExecOptions(ordered_aggregations=True)
        self.engine = LocalEngine(db.table_provider(), exec_options)

    def create_table(self, name: str, schema_def: SchemaDef):
        return self.db.table(name, TableConfig(schema=schema_def))

    def scan_table(self, name: str):
        return self.engine.scan_table(name)


def run_file(path: str, db_factory) -> list[tuple[Directive, str, str]]:
    """Run one datadriven file; returns (directive, expected, actual) for
    every directive. ``db_factory()`` must return a fresh LogicTestDB."""
    with open(path) as f:
        text = f.read()
    db = db_factory()
    runner = Runner(db)
    out = []
    for d in parse_datadriven(text):
        actual = runner.run_directive(d)
        out.append((d, d.expected, actual))
    return out
