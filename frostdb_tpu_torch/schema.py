"""Schema core: column definitions, dynamic columns, sorting columns.

The analogue of the reference's ``dynparquet`` package
(dynparquet/schema.go:112 `Schema`, :259 `SchemaFromDefinition`). A
``SchemaDef`` mirrors the proto schema definition
(proto/frostdb/schema/v1alpha1); a ``Schema`` adds the derived machinery:
concrete column-set instantiation for a set of dynamic column names, sorting
key expansion, and comparison semantics across differing dynamic column sets
(dynparquet/row.go:79 `Schema.Cmp`).

Unlike the reference there is no parquet writer pool here: concrete schemas
are cheap frozen tuples, and the columnar data model lives in
``columnbatch.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Iterable, Mapping, Sequence

# Storage types (reference: schemapb.StorageLayout_TYPE_*)
TYPE_STRING = "string"
TYPE_INT64 = "int64"
TYPE_DOUBLE = "double"
TYPE_BOOL = "bool"
TYPE_UINT64 = "uint64"
TYPE_INT32 = "int32"

ENCODING_PLAIN = "plain"
ENCODING_RLE_DICTIONARY = "rle_dictionary"
ENCODING_DELTA_BINARY_PACKED = "delta_binary_packed"
ENCODING_DELTA_BYTE_ARRAY = "delta_byte_array"
ENCODING_DELTA_LENGTH_BYTE_ARRAY = "delta_length_byte_array"

COMPRESSION_NONE = "none"
COMPRESSION_SNAPPY = "snappy"
COMPRESSION_GZIP = "gzip"
COMPRESSION_BROTLI = "brotli"
COMPRESSION_LZ4_RAW = "lz4_raw"
COMPRESSION_ZSTD = "zstd"


@dataclass(frozen=True)
class StorageLayout:
    """Physical layout of a column (reference: schemapb.StorageLayout)."""

    type: str
    nullable: bool = False
    encoding: str = ENCODING_PLAIN
    compression: str = COMPRESSION_NONE
    repeated: bool = False

    @property
    def dict_encoded(self) -> bool:
        return self.encoding == ENCODING_RLE_DICTIONARY


@dataclass(frozen=True)
class ColumnDef:
    """A (possibly dynamic) column definition (reference:
    dynparquet/schema.go ColumnDefinition)."""

    name: str
    layout: StorageLayout
    dynamic: bool = False
    prehash: bool = False


@dataclass(frozen=True)
class SortingColumnDef:
    """Reference: schemapb.SortingColumn."""

    name: str
    direction: str = "asc"  # "asc" | "desc"
    nulls_first: bool = False


@dataclass(frozen=True)
class GroupDef:
    """A nested group of columns (reference: schemapb v1alpha2
    Node/Group, dynparquet/schema.go:259 SchemaFromDefinition — the
    reference accepts flat v1alpha1 and nested v1alpha2 definitions).
    Groups flatten to dotted leaf columns (``group.leaf``) for storage and
    querying; the group structure round-trips at the Arrow edges
    (``ColumnBatch.to_arrow(schema=...)`` re-nests into struct arrays)."""

    name: str
    nodes: tuple  # ColumnDef | GroupDef
    nullable: bool = False


def _flatten_nodes(prefix: str, nodes) -> list[ColumnDef]:
    out: list[ColumnDef] = []
    for n in nodes:
        if isinstance(n, GroupDef):
            out.extend(_flatten_nodes(prefix + n.name + ".", n.nodes))
        else:
            out.append(replace(n, name=prefix + n.name))
    return out


def flatten_definition(d: "SchemaDef") -> "SchemaDef":
    """Expand nested groups into dotted leaf ColumnDefs; identity for flat
    definitions (reference: record_builder.go struct fields become
    name-mangled parquet leaves)."""
    if not any(isinstance(c, GroupDef) for c in d.columns):
        return d
    return replace(d, columns=tuple(_flatten_nodes("", d.columns)))


def _column_to_dict(c) -> dict:
    if isinstance(c, GroupDef):
        return {
            "name": c.name,
            "group": [_column_to_dict(n) for n in c.nodes],
            "nullable": c.nullable,
        }
    return {
        "name": c.name,
        "layout": {
            "type": c.layout.type,
            "nullable": c.layout.nullable,
            "encoding": c.layout.encoding,
            "compression": c.layout.compression,
            "repeated": c.layout.repeated,
        },
        "dynamic": c.dynamic,
        "prehash": c.prehash,
    }


def _column_from_dict(c: dict):
    if "group" in c:
        return GroupDef(
            name=c["name"],
            nodes=tuple(_column_from_dict(n) for n in c["group"]),
            nullable=c.get("nullable", False),
        )
    return ColumnDef(
        name=c["name"],
        layout=StorageLayout(
            type=c["layout"]["type"],
            nullable=c["layout"].get("nullable", False),
            encoding=c["layout"].get("encoding", ENCODING_PLAIN),
            compression=c["layout"].get("compression", COMPRESSION_NONE),
            repeated=c["layout"].get("repeated", False),
        ),
        dynamic=c.get("dynamic", False),
        prehash=c.get("prehash", False),
    )


@dataclass(frozen=True)
class SchemaDef:
    """Serializable schema definition (reference: schemapb.Schema; columns
    may contain nested GroupDefs — the v1alpha2 form)."""

    name: str
    columns: tuple[ColumnDef, ...]
    sorting_columns: tuple[SortingColumnDef, ...] = ()

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "columns": [_column_to_dict(c) for c in self.columns],
            "sorting_columns": [
                {
                    "name": s.name,
                    "direction": s.direction,
                    "nulls_first": s.nulls_first,
                }
                for s in self.sorting_columns
            ],
        }

    @staticmethod
    def from_dict(d: dict) -> "SchemaDef":
        return SchemaDef(
            name=d["name"],
            columns=tuple(_column_from_dict(c) for c in d["columns"]),
            sorting_columns=tuple(
                SortingColumnDef(
                    name=s["name"],
                    direction=s.get("direction", "asc"),
                    nulls_first=s.get("nulls_first", False),
                )
                for s in d["sorting_columns"]
            ),
        )


# The prefix separator between a dynamic column family name and the concrete
# instantiation, e.g. "labels" + "." + "label1" (reference uses the same
# convention, logictest/runner.go:157).
DYN_SEP = "."


def is_dynamic_name(full_name: str) -> bool:
    return DYN_SEP in full_name


def split_dynamic(full_name: str) -> tuple[str, str]:
    i = full_name.index(DYN_SEP)
    return full_name[:i], full_name[i + 1 :]


class Schema:
    """Runtime schema: definition + derived lookups.

    Concrete column sets: given dynamic column instantiations (a mapping
    family name -> sorted concrete names), produces the ordered tuple of
    concrete column names. Ordering follows the reference's parquet group
    semantics: columns sorted by full name (parquet-go sorts group fields by
    name; dynparquet/schema.go:684 `dynamicParquetSchema`).
    """

    def __init__(self, definition: SchemaDef):
        # Nested v1alpha2-style groups flatten to dotted leaf columns; the
        # original (possibly nested) definition is kept for struct
        # round-trips at the Arrow edges.
        self.nested_def = definition
        self.def_ = flatten_definition(definition)
        self._by_name: dict[str, ColumnDef] = {
            c.name: c for c in self.def_.columns
        }

    def groups(self) -> list[GroupDef]:
        return [
            c for c in self.nested_def.columns if isinstance(c, GroupDef)
        ]

    # -- basic lookups ----------------------------------------------------

    @property
    def name(self) -> str:
        return self.def_.name

    def columns(self) -> Sequence[ColumnDef]:
        return self.def_.columns

    def sorting_columns(self) -> Sequence[SortingColumnDef]:
        return self.def_.sorting_columns

    def column_by_name(self, name: str) -> ColumnDef | None:
        """Look up a column definition; for "family.concrete" names the
        family definition is returned (reference:
        dynparquet Schema.ColumnByName)."""
        if name in self._by_name:
            return self._by_name[name]
        if is_dynamic_name(name):
            fam, _ = split_dynamic(name)
            c = self._by_name.get(fam)
            if c is not None and c.dynamic:
                return c
        return None

    def dynamic_families(self) -> list[str]:
        return [c.name for c in self.def_.columns if c.dynamic]

    def prehash_families(self) -> list[str]:
        return [c.name for c in self.def_.columns if c.prehash]

    # -- concrete instantiation -------------------------------------------

    def concrete_columns(
        self, dynamic_cols: Mapping[str, Sequence[str]]
    ) -> list[tuple[str, ColumnDef]]:
        """Ordered concrete (full_name, def) pairs for the given dynamic
        column instantiation. Full names are sorted alphabetically, matching
        the reference's parquet schema field ordering."""
        out: list[tuple[str, ColumnDef]] = []
        for c in self.def_.columns:
            if c.dynamic:
                for sub in sorted(dynamic_cols.get(c.name, ())):
                    # Dynamic column instances are always nullable: a row
                    # simply might not carry the label.
                    layout = replace(c.layout, nullable=True)
                    out.append(
                        (c.name + DYN_SEP + sub, replace(c, layout=layout))
                    )
            else:
                out.append((c.name, c))
        out.sort(key=lambda p: p[0])
        return out

    def sorting_key_columns(
        self, dynamic_cols: Mapping[str, Sequence[str]]
    ) -> list[tuple[str, SortingColumnDef]]:
        """Expand sorting columns over a concrete dynamic column set
        (reference: dynparquet/schema.go `parquetSortingSchema` /
        dynamicSortingColumn). A dynamic sorting column expands to all its
        concrete instantiations in alphabetical order."""
        out: list[tuple[str, SortingColumnDef]] = []
        for s in self.def_.sorting_columns:
            c = self._by_name.get(s.name)
            if c is not None and c.dynamic:
                for sub in sorted(dynamic_cols.get(s.name, ())):
                    out.append((s.name + DYN_SEP + sub, s))
            else:
                out.append((s.name, s))
        return out


def merge_dynamic_column_sets(
    sets: Iterable[Mapping[str, Sequence[str]]]
) -> dict[str, list[str]]:
    """Union of dynamic column sets (reference: dynparquet/schema.go:1399
    `MergeDynamicColumnSets`)."""
    merged: dict[str, set[str]] = {}
    for s in sets:
        for fam, names in s.items():
            merged.setdefault(fam, set()).update(names)
    return {fam: sorted(names) for fam, names in merged.items()}


# ---------------------------------------------------------------------------
# Test/sample schemas (reference: samples/example.go:157 SampleDefinition,
# :215 SampleDefinitionWithFloat, :100 PrehashedSampleDefinition).


def sample_definition() -> SchemaDef:
    return SchemaDef(
        name="test",
        columns=(
            ColumnDef(
                "example_type",
                StorageLayout(TYPE_STRING, encoding=ENCODING_RLE_DICTIONARY),
            ),
            ColumnDef(
                "labels",
                StorageLayout(
                    TYPE_STRING, nullable=True, encoding=ENCODING_RLE_DICTIONARY
                ),
                dynamic=True,
            ),
            ColumnDef(
                "stacktrace",
                StorageLayout(TYPE_STRING, encoding=ENCODING_RLE_DICTIONARY),
            ),
            ColumnDef("timestamp", StorageLayout(TYPE_INT64)),
            ColumnDef("value", StorageLayout(TYPE_INT64)),
        ),
        sorting_columns=(
            SortingColumnDef("example_type", "asc"),
            SortingColumnDef("labels", "asc", nulls_first=True),
            SortingColumnDef("timestamp", "asc"),
            SortingColumnDef("stacktrace", "asc", nulls_first=True),
        ),
    )


def sample_definition_with_float() -> SchemaDef:
    base = sample_definition()
    return SchemaDef(
        name=base.name,
        columns=base.columns
        + (
            ColumnDef("floatvalue", StorageLayout(TYPE_DOUBLE, nullable=True)),
        ),
        sorting_columns=base.sorting_columns,
    )


# The ten cpu fields of the Time Series Benchmark Suite's devops use case
# (github.com/timescale/tsbs, cmd/tsbs_generate_data, cpu-only).
TSBS_CPU_FIELDS = (
    "usage_user", "usage_system", "usage_idle", "usage_nice", "usage_iowait",
    "usage_irq", "usage_softirq", "usage_steal", "usage_guest", "usage_guest_nice",
)


def tsbs_cpu_definition() -> SchemaDef:
    """TSBS devops cpu rows: the host's tags as dynamic ``labels``, the
    reading's timestamp and the ten cpu fields, sorted by labels, then
    time."""
    return SchemaDef(
        name="cpu",
        columns=(
            ColumnDef(
                "labels",
                StorageLayout(
                    TYPE_STRING, nullable=True, encoding=ENCODING_RLE_DICTIONARY
                ),
                dynamic=True,
            ),
            ColumnDef("timestamp", StorageLayout(TYPE_INT64)),
            *(ColumnDef(f, StorageLayout(TYPE_INT64)) for f in TSBS_CPU_FIELDS),
        ),
        sorting_columns=(
            SortingColumnDef("labels", "asc", nulls_first=True),
            SortingColumnDef("timestamp", "asc"),
        ),
    )


def prehashed_sample_definition() -> SchemaDef:
    base = sample_definition()
    cols = []
    for c in base.columns:
        if c.name in ("labels", "stacktrace"):
            cols.append(replace(c, prehash=True))
        else:
            cols.append(c)
    return SchemaDef(
        name=base.name, columns=tuple(cols), sorting_columns=base.sorting_columns
    )
