"""Host-side columnar batches with table-global string dictionaries.

This is the in-memory data model that replaces the reference's Arrow records
(pqarrow/arrow.go) with a device-friendly SoA layout:

- Numeric columns are dense numpy vectors + validity bitmaps; null slots hold
  zero, which exactly reproduces the reference's aggregation semantics (its
  sum/min/max kernels run over the raw value buffers including null slots,
  query/physicalplan/aggregate.go:763 `math.Int64.Sum`).
- String columns are int32 codes into an append-only *table-global*
  dictionary. This is the core design decision: device kernels only ever
  see integer codes, string predicates (==, regexp, contains) are evaluated
  once on the (small) dictionary host-side and become code-membership masks
  on device — the vectorized generalization of the reference's
  dictionary-compare trick (query/physicalplan/binaryscalarexpr.go:194
  `DictionaryArrayScalarEqual` compares dictionary values once).

Arrow/parquet appear only at the edges (ingest, WAL/snapshot serialization,
object-storage persistence) via pyarrow, imported only inside the
functions that convert (``to_arrow`` / ``from_arrow``), so the package
imports on hosts without pyarrow.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field as dc_field
from typing import Iterable, Mapping, Sequence

import numpy as np

from .schema import (
    ColumnDef,
    Schema,
    SortingColumnDef,
    StorageLayout,
    TYPE_BOOL,
    TYPE_DOUBLE,
    TYPE_INT64,
    TYPE_STRING,
    TYPE_UINT64,
    is_dynamic_name,
    split_dynamic,
)

# Column kinds (device representation)
KIND_INT64 = "int64"
KIND_UINT64 = "uint64"
KIND_FLOAT64 = "float64"
KIND_BOOL = "bool"
KIND_DICT = "dict"  # string -> int32 codes into a Dictionary
# Variable-length lists (reference: pqarrow/builder/listbuilder.go,
# internal/records slices->lists). Device representation: the Column's
# ``values`` hold a per-row int64 CONTENT HASH (order- and null-sensitive),
# so grouping/distinct/prehash/equality flow through every device kernel
# unchanged, while the variable-length payload lives host-side as
# ``offsets`` [n+1] + a flat ``child`` Column for materialization
# (the same hash-the-list trick the reference uses in HashArray,
# dynparquet/hashed.go:86 list case).
KIND_LIST = "list"

_KIND_NP_DTYPE = {
    KIND_INT64: np.int64,
    KIND_UINT64: np.uint64,
    KIND_FLOAT64: np.float64,
    KIND_BOOL: np.bool_,
    KIND_DICT: np.int32,
    KIND_LIST: np.int64,
}


def kind_for_layout(layout: StorageLayout) -> str:
    t = layout.type
    if layout.repeated:
        return KIND_LIST
    if t == TYPE_STRING:
        return KIND_DICT
    if t == TYPE_INT64:
        return KIND_INT64
    if t == TYPE_UINT64:
        return KIND_UINT64
    if t == TYPE_DOUBLE:
        return KIND_FLOAT64
    if t == TYPE_BOOL:
        return KIND_BOOL
    raise ValueError(f"unsupported storage type {t!r}")


_M1 = 0xFF51AFD7ED558CCD
_M2 = 0xC4CEB9FE1A85EC53
_M3 = 0x9DDFEA08EB382D69
_MASK = (1 << 64) - 1


def _mix64(x: int) -> int:
    x ^= x >> 33
    x = (x * _M1) & _MASK
    x ^= x >> 33
    x = (x * _M2) & _MASK
    x ^= x >> 33
    return x


def _mix64_np(x: np.ndarray) -> np.ndarray:
    """Vectorized _mix64 over a uint64 array."""
    x = x.astype(np.uint64, copy=True)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(33)
        x *= np.uint64(_M1)
        x ^= x >> np.uint64(33)
        x *= np.uint64(_M2)
        x ^= x >> np.uint64(33)
    return x


def list_row_hashes(
    offsets: np.ndarray, elem_hashes: np.ndarray, validity: np.ndarray
) -> np.ndarray:
    """Order- and null-sensitive per-row content hash of a list column —
    the device-facing value of a KIND_LIST column (the analogue of the
    reference hashing whole lists in HashArray, dynparquet/hashed.go:86).
    ``elem_hashes`` is one int64/uint64 hash per flat child element (null
    child slots must already hold a fixed sentinel)."""
    n = len(offsets) - 1
    lengths = np.diff(offsets).astype(np.int64)
    total = int(offsets[-1])
    with np.errstate(over="ignore"):
        if total:
            row_ids = np.repeat(np.arange(n, dtype=np.int64), lengths)
            pos = (
                np.arange(total, dtype=np.uint64)
                - np.repeat(offsets[:-1].astype(np.uint64), lengths)
            )
            # Positional weighting keeps the hash order-sensitive while the
            # per-row fold stays a commutative scatter-add.
            g = _mix64_np(
                elem_hashes.astype(np.uint64) ^ ((pos + np.uint64(1)) * np.uint64(_M2))
            )
            sums = np.zeros(n, dtype=np.uint64)
            np.add.at(sums, row_ids, g)
        else:
            sums = np.zeros(n, dtype=np.uint64)
        h = _mix64_np(sums ^ (lengths.astype(np.uint64) * np.uint64(_M3)))
    out = h.view(np.int64)
    return np.where(validity, out, np.int64(0))


_NULL_ELEM_SENTINEL = np.uint64(0x9E3779B97F4A7C15)


def _element_hashes(child: "Column") -> np.ndarray:
    """Per-element uint64 hashes of a list's flat child column (dictionary
    codes hash through the table-global dictionary so equal strings hash
    equal across parts; null elements hash to a fixed sentinel)."""
    if child.kind == KIND_DICT:
        code_hash = child.dictionary.hash_for_code().view(np.uint64)
        if len(code_hash):
            h = code_hash[np.clip(child.values.astype(np.int64), 0, len(code_hash) - 1)]
        else:
            h = np.zeros(len(child), dtype=np.uint64)
    elif child.kind == KIND_LIST:
        h = child.values.view(np.uint64)
    elif child.kind == KIND_FLOAT64:
        h = _mix64_np(child.values.view(np.uint64))
    else:
        h = _mix64_np(child.values.astype(np.int64).view(np.uint64))
    return np.where(child.validity, h, _NULL_ELEM_SENTINEL)


def _hash64(s: str) -> int:
    """Deterministic 64-bit string hash used for pre-hashed columns
    (reference: dynparquet/hashed.go:86 `HashArray` uses metro-hash).
    Mirrors native/frostdb_native.cpp hash_bytes so native and Python
    dictionaries produce identical pre-hash columns."""
    data = s.encode("utf-8", "surrogateescape")
    n = len(data)
    h = (0x9E3779B97F4A7C15 ^ n) & _MASK
    i = 0
    while i + 8 <= n:
        k = int.from_bytes(data[i : i + 8], "little")
        h = (_mix64(h ^ k) * _M3) & _MASK
        i += 8
    tail = int.from_bytes(data[i:], "little") if i < n else 0
    h = _mix64(h ^ tail)
    return h - (1 << 64) if h >= (1 << 63) else h


class Dictionary:
    """Append-only string dictionary shared by all parts of a table column.

    Codes are stable for the lifetime of the table, so device-resident parts
    written at different times remain directly comparable — the analogue of
    the reference re-dictionarifying on merge (pqarrow/arrowutils/sort.go
    dictionary Take path), hoisted to ingest time.

    Backed by the native C++ runtime (native/frostdb_native.cpp) when the
    toolchain is available; the pure-Python fallback is hash-identical.
    """

    def __init__(self, use_native: bool | None = None) -> None:
        self._native = None
        if use_native is not False:
            from . import native as _native_mod

            if _native_mod.available():
                self._native = _native_mod.NativeDict()
        self._values: list[str] = []
        self._index: dict[str, int] = {}
        self._hashes: list[int] = []

    def __len__(self) -> int:
        if self._native is not None:
            return len(self._native)
        return len(self._values)

    @property
    def values(self) -> list[str]:
        if self._native is not None:
            return self._native.values()
        return self._values

    def code(self, value: str) -> int:
        if self._native is not None:
            codes, _valid = self._native.encode_batch([value])
            return int(codes[0])
        c = self._index.get(value)
        if c is None:
            c = len(self._values)
            self._values.append(value)
            self._index[value] = c
            self._hashes.append(_hash64(value))
        return c

    def lookup(self, value: str) -> int | None:
        """Code for value, or None if the value has never been seen."""
        if self._native is not None:
            return self._native.lookup(value)
        return self._index.get(value)

    def hash_for_code(self) -> np.ndarray:
        if self._native is not None:
            return self._native.hashes()
        return np.asarray(self._hashes, dtype=np.int64)

    def encode(self, values: Iterable[str | None]) -> tuple[np.ndarray, np.ndarray]:
        vals = list(values)
        if self._native is not None:
            return self._native.encode_batch(vals)
        codes: list[int] = []
        valid: list[bool] = []
        for v in vals:
            if v is None:
                codes.append(0)
                valid.append(False)
            else:
                codes.append(self.code(v))
                valid.append(True)
        return (
            np.asarray(codes, dtype=np.int32),
            np.asarray(valid, dtype=np.bool_),
        )

    def value_array(self) -> np.ndarray:
        return np.asarray(self.values, dtype=object)

    def sort_ranks(self) -> np.ndarray:
        """rank[code] = position of the code's value in sorted value order.
        Used to sort rows by string value while the device representation
        stays code-based."""
        values = self.values
        vals = np.asarray(values, dtype="U") if values else np.asarray([], dtype="U")
        order = np.argsort(vals, kind="stable")
        ranks = np.empty(len(order), dtype=np.int64)
        ranks[order] = np.arange(len(order), dtype=np.int64)
        return ranks


@dataclass
class Column:
    """One column of a host batch."""

    name: str
    kind: str
    values: np.ndarray  # dtype per kind; null slots hold 0/False
    validity: np.ndarray  # bool; True = non-null
    dictionary: Dictionary | None = None
    # Layout metadata carried through for parquet round-trips.
    layout: StorageLayout | None = None
    # List payload (KIND_LIST only): offsets [n+1] into the flat child.
    offsets: np.ndarray | None = None
    child: "Column | None" = None

    def __post_init__(self) -> None:
        assert self.values.shape == self.validity.shape, (
            self.name,
            self.values.shape,
            self.validity.shape,
        )
        if self.kind == KIND_DICT:
            assert self.dictionary is not None
        if self.kind == KIND_LIST:
            assert self.offsets is not None and self.child is not None

    def __len__(self) -> int:
        return len(self.values)

    def take(self, indices: np.ndarray) -> "Column":
        if self.kind == KIND_LIST:
            lengths = np.diff(self.offsets)[indices]
            new_off = np.zeros(len(lengths) + 1, dtype=np.int64)
            np.cumsum(lengths, out=new_off[1:])
            total = int(new_off[-1])
            if total:
                starts = self.offsets[indices].astype(np.int64)
                child_idx = (
                    np.repeat(starts, lengths)
                    + np.arange(total, dtype=np.int64)
                    - np.repeat(new_off[:-1], lengths)
                )
            else:
                child_idx = np.zeros(0, dtype=np.int64)
            return Column(
                self.name,
                self.kind,
                self.values[indices],
                self.validity[indices],
                self.dictionary,
                self.layout,
                offsets=new_off,
                child=self.child.take(child_idx),
            )
        return Column(
            self.name,
            self.kind,
            self.values[indices],
            self.validity[indices],
            self.dictionary,
            self.layout,
        )

    def null_count(self) -> int:
        return int((~self.validity).sum())

    def py_value(self, i: int):
        """Python value at row i (None when null)."""
        if not self.validity[i]:
            return None
        if self.kind == KIND_LIST:
            lo, hi = int(self.offsets[i]), int(self.offsets[i + 1])
            return [self.child.py_value(j) for j in range(lo, hi)]
        if self.kind == KIND_DICT:
            return self.dictionary.values[int(self.values[i])]
        v = self.values[i]
        if self.kind == KIND_BOOL:
            return bool(v)
        if self.kind == KIND_FLOAT64:
            return float(v)
        return int(v)

    @staticmethod
    def all_null(
        name: str, kind: str, n: int, dictionary: Dictionary | None = None,
        layout: StorageLayout | None = None, template: "Column | None" = None,
    ) -> "Column":
        """Virtual all-null column (reference: pqarrow/nullarray.go
        `VirtualNullArray`, dynparquet/nil_chunk.go `NilColumnChunk`).
        ``template`` supplies the child structure for list columns."""
        offsets = child = None
        if kind == KIND_LIST:
            offsets = np.zeros(n + 1, dtype=np.int64)
            if template is not None and template.child is not None:
                child = template.child.take(np.zeros(0, dtype=np.int64))
            else:
                child_kind = KIND_INT64
                if layout is not None:
                    import dataclasses

                    child_kind = kind_for_layout(
                        dataclasses.replace(layout, repeated=False)
                    )
                child = Column.all_null(
                    "item",
                    child_kind,
                    0,
                    dictionary if child_kind == KIND_DICT else None,
                )
            dictionary = None if kind == KIND_LIST else dictionary
        return Column(
            name,
            kind,
            np.zeros(n, dtype=_KIND_NP_DTYPE[kind]),
            np.zeros(n, dtype=np.bool_),
            dictionary,
            layout,
            offsets=offsets,
            child=child,
        )


class ColumnBatch:
    """An ordered set of equal-length columns — the unit of data flowing
    through the engine (the reference's arrow.Record analogue)."""

    def __init__(self, columns: Sequence[Column], num_rows: int | None = None):
        self.columns: list[Column] = list(columns)
        if num_rows is None:
            if not self.columns:
                raise ValueError("empty batch requires explicit num_rows")
            num_rows = len(self.columns[0])
        self.num_rows = num_rows
        for c in self.columns:
            assert len(c) == num_rows, (c.name, len(c), num_rows)
        self._by_name = {c.name: c for c in self.columns}

    def __len__(self) -> int:
        return self.num_rows

    def column_names(self) -> list[str]:
        return [c.name for c in self.columns]

    def column(self, name: str) -> Column | None:
        return self._by_name.get(name)

    def signature(self) -> tuple[tuple[str, str], ...]:
        """Column-set signature: the jit-cache key component. Two batches
        with equal signatures run through the same compiled executable."""
        return tuple((c.name, c.kind) for c in self.columns)

    def dynamic_columns(self) -> dict[str, list[str]]:
        """Concrete dynamic columns present, by family
        (reference: pqarrow/parquet.go:322 `RecordDynamicCols`)."""
        out: dict[str, list[str]] = {}
        for c in self.columns:
            if is_dynamic_name(c.name):
                fam, sub = split_dynamic(c.name)
                out.setdefault(fam, []).append(sub)
        return {k: sorted(v) for k, v in out.items()}

    def take(self, indices: np.ndarray) -> "ColumnBatch":
        return ColumnBatch([c.take(indices) for c in self.columns], len(indices))

    def select_mask(self, mask: np.ndarray) -> "ColumnBatch":
        idx = np.nonzero(mask)[0]
        return self.take(idx)

    def slice(self, start: int, length: int) -> "ColumnBatch":
        idx = np.arange(start, min(start + length, self.num_rows))
        return self.take(idx)

    def with_columns(self, cols: Sequence[Column]) -> "ColumnBatch":
        return ColumnBatch(list(self.columns) + list(cols), self.num_rows)

    def project(self, names: Sequence[str]) -> "ColumnBatch":
        cols = []
        for n in names:
            c = self._by_name.get(n)
            if c is not None:
                cols.append(c)
        return ColumnBatch(cols, self.num_rows)

    # ------------------------------------------------------------------
    # Sorting (reference: dynparquet Buffer.Sort / pqarrow SortRecord)

    def sort_indices(
        self, sorting: Sequence[tuple[str, SortingColumnDef]]
    ) -> np.ndarray:
        """Stable multi-key sort indices by the given concrete sorting
        columns. Missing columns sort as null (reference:
        dynparquet/row.go:68 DynamicRow comparison backfills nulls)."""
        keys: list[np.ndarray] = []
        for name, s in sorting:
            col = self._by_name.get(name)
            if col is None:
                continue  # all-null: no effect on ordering
            if col.kind == KIND_DICT:
                ranks = col.dictionary.sort_ranks()
                if len(ranks) == 0:
                    key = np.zeros(len(col), dtype=np.int64)
                else:
                    key = ranks[col.values.astype(np.int64)] + 1
            elif col.kind == KIND_BOOL:
                key = col.values.astype(np.int64) + 1
            elif col.kind == KIND_FLOAT64:
                key = col.values.astype(np.float64)
            else:
                key = col.values.astype(np.int64) + 1 - 1  # copy
            key = key.astype(np.float64) if col.kind == KIND_FLOAT64 else key
            # Null placement: nulls_first -> below all values; else above.
            if col.kind == KIND_FLOAT64:
                nullkey = -np.inf if s.nulls_first else np.inf
                key = np.where(col.validity, key, nullkey)
            else:
                big = np.int64(2**62)
                nullkey = -big if s.nulls_first else big
                key = np.where(col.validity, key, nullkey)
            if s.direction == "desc":
                key = -key
            keys.append(key)
        if not keys:
            return np.arange(self.num_rows)
        # np.lexsort: last key is primary.
        return np.lexsort(tuple(reversed(keys)))

    def sort_by(self, sorting: Sequence[tuple[str, SortingColumnDef]]) -> "ColumnBatch":
        return self.take(self.sort_indices(sorting))

    # ------------------------------------------------------------------
    # Schema unification (reference: pqarrow/arrowutils/schema.go
    # EnsureSameSchema / mergeArrowSchemas)

    def conform(
        self,
        concrete: Sequence[tuple[str, ColumnDef]],
        dictionaries: Mapping[str, Dictionary],
    ) -> "ColumnBatch":
        """Return a batch with exactly the given concrete columns in order,
        backfilling missing ones with virtual nulls."""
        cols: list[Column] = []
        for full_name, cdef in concrete:
            c = self._by_name.get(full_name)
            if c is None:
                kind = kind_for_layout(cdef.layout)
                fam = split_dynamic(full_name)[0] if is_dynamic_name(full_name) else full_name
                needs_dict = kind == KIND_DICT or (
                    kind == KIND_LIST and cdef.layout.type == TYPE_STRING
                )
                c = Column.all_null(
                    full_name,
                    kind,
                    self.num_rows,
                    dictionaries.get(fam) if needs_dict else None,
                    cdef.layout,
                )
            cols.append(c)
        return ColumnBatch(cols, self.num_rows)

    # ------------------------------------------------------------------
    # Pre-hashed columns (reference: dynparquet/hashed.go:38 PrehashColumns)

    def prehash(self, schema: Schema) -> "ColumnBatch":
        fams = set(schema.prehash_families())
        if not fams:
            return self
        extra: list[Column] = []
        for c in self.columns:
            fam = split_dynamic(c.name)[0] if is_dynamic_name(c.name) else c.name
            if fam not in fams or c.name.startswith(HASHED_PREFIX):
                continue
            if c.kind == KIND_DICT:
                code_hash = c.dictionary.hash_for_code()
                if len(code_hash) == 0:
                    hashed = np.zeros(self.num_rows, dtype=np.int64)
                else:
                    hashed = code_hash[c.values.astype(np.int64)]
            else:
                hashed = c.values.astype(np.int64)
            hashed = np.where(c.validity, hashed, np.int64(0))
            extra.append(
                Column(
                    HASHED_PREFIX + c.name,
                    KIND_INT64,
                    hashed,
                    np.ones(self.num_rows, dtype=np.bool_),
                )
            )
        if not extra:
            return self
        return self.with_columns(extra)

    def without_hashed(self) -> "ColumnBatch":
        cols = [c for c in self.columns if not c.name.startswith(HASHED_PREFIX)]
        return ColumnBatch(cols, self.num_rows)

    # ------------------------------------------------------------------
    # Arrow interop

    def to_arrow(self, schema=None) -> pa.RecordBatch:
        """Arrow output. With a ``Schema`` whose definition has nested
        groups (v1alpha2), the group's dotted leaf columns re-nest into one
        StructArray per group — the struct round-trip at the Arrow edge
        (reference: dynparquet/schema.go:259 accepts nested definitions;
        record_builder.go builds struct fields)."""
        import pyarrow as pa

        arrays = []
        fields = []

        def convert(c: Column) -> pa.Array:
            mask = ~c.validity
            if c.kind == KIND_LIST:
                child_arr = convert(c.child)
                return pa.ListArray.from_arrays(
                    pa.array(c.offsets.astype(np.int32), type=pa.int32()),
                    child_arr,
                    mask=pa.array(mask) if mask.any() else None,
                )
            if c.kind == KIND_DICT:
                dict_values = pa.array(c.dictionary.values, type=pa.string())
                indices = pa.array(c.values.astype(np.int32), mask=mask)
                return pa.DictionaryArray.from_arrays(indices, dict_values)
            if c.kind == KIND_BOOL:
                return pa.array(c.values, type=pa.bool_(), mask=mask)
            if c.kind == KIND_FLOAT64:
                return pa.array(c.values, type=pa.float64(), mask=mask)
            if c.kind == KIND_UINT64:
                return pa.array(c.values, type=pa.uint64(), mask=mask)
            return pa.array(c.values, type=pa.int64(), mask=mask)

        group_names = []
        if schema is not None and getattr(schema, "groups", None):
            group_names = [g.name for g in schema.groups()]

        emitted_groups: set[str] = set()
        for c in self.columns:
            gname = c.name.split(".", 1)[0] if "." in c.name else None
            if gname in group_names:
                if gname in emitted_groups:
                    continue
                emitted_groups.add(gname)
                members = [
                    m
                    for m in self.columns
                    if m.name.startswith(gname + ".")
                ]
                child_arrays = [convert(m) for m in members]
                child_fields = [
                    pa.field(m.name.split(".", 1)[1], a.type, nullable=True)
                    for m, a in zip(members, child_arrays)
                ]
                struct = pa.StructArray.from_arrays(
                    child_arrays, fields=child_fields
                )
                arrays.append(struct)
                fields.append(pa.field(gname, struct.type, nullable=True))
                continue
            arr = convert(c)
            arrays.append(arr)
            fields.append(pa.field(c.name, arr.type, nullable=True))
        return pa.RecordBatch.from_arrays(arrays, schema=pa.schema(fields))

    @staticmethod
    def from_arrow(
        rb: pa.RecordBatch | pa.Table,
        dictionaries: Mapping[str, Dictionary] | None = None,
        get_dictionary=None,
    ) -> "ColumnBatch":
        """Ingest an Arrow batch, re-encoding string/dictionary columns into
        table-global dictionaries. ``get_dictionary(family)`` supplies the
        dictionary for a column family; falls back to fresh per-call dicts.
        """
        import pyarrow as pa

        if isinstance(rb, pa.Table):
            rb = rb.combine_chunks()
            batches = rb.to_batches()
            if len(batches) == 1:
                rb = batches[0]
            else:
                rb = pa.Table.from_batches(batches).combine_chunks().to_batches()[0]
        local_dicts: dict[str, Dictionary] = {}

        def dict_for(name: str) -> Dictionary:
            fam = split_dynamic(name)[0] if is_dynamic_name(name) else name
            if get_dictionary is not None:
                return get_dictionary(fam)
            if dictionaries is not None and fam in dictionaries:
                return dictionaries[fam]
            return local_dicts.setdefault(fam, Dictionary())

        def convert(name: str, arr: pa.Array) -> Column:
            t = arr.type
            if pa.types.is_dictionary(t):
                t = t.value_type
            if pa.types.is_list(t) or pa.types.is_large_list(t):
                # Lists (reference: pqarrow/builder/listbuilder.go): flat
                # child + offsets; the row values are content hashes (see
                # KIND_LIST) so device kernels treat lists as scalars.
                arr = arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr
                np_valid = np.asarray(arr.is_valid())
                offsets = np.asarray(arr.offsets, dtype=np.int64)
                lo = int(offsets[0])
                child_arr = arr.values.slice(
                    lo, int(offsets[-1]) - lo
                )
                offsets = offsets - lo
                child = convert(name, child_arr)
                elem = _element_hashes(child)
                vals = list_row_hashes(offsets, elem, np_valid)
                return Column(
                    name, KIND_LIST, vals, np_valid,
                    offsets=offsets, child=child,
                )
            if pa.types.is_string(t) or pa.types.is_large_string(t) or pa.types.is_binary(t):
                d = dict_for(name)
                pylist = arr.to_pylist()
                pylist = [
                    v.decode("utf-8", "surrogateescape") if isinstance(v, bytes) else v
                    for v in pylist
                ]
                codes, valid = d.encode(pylist)
                return Column(name, KIND_DICT, codes, valid, d)
            if pa.types.is_boolean(t):
                np_valid = np.asarray(arr.is_valid())
                vals = np.asarray(arr.fill_null(False), dtype=np.bool_)
                return Column(name, KIND_BOOL, vals, np_valid)
            if pa.types.is_floating(t):
                np_valid = np.asarray(arr.is_valid())
                vals = np.asarray(arr.cast(pa.float64()).fill_null(0.0), dtype=np.float64)
                return Column(name, KIND_FLOAT64, vals, np_valid)
            if pa.types.is_unsigned_integer(t):
                np_valid = np.asarray(arr.is_valid())
                vals = np.asarray(arr.cast(pa.uint64()).fill_null(0), dtype=np.uint64)
                return Column(name, KIND_UINT64, vals, np_valid)
            if pa.types.is_integer(t):
                np_valid = np.asarray(arr.is_valid())
                vals = np.asarray(arr.cast(pa.int64()).fill_null(0), dtype=np.int64)
                return Column(name, KIND_INT64, vals, np_valid)
            raise ValueError(f"unsupported arrow type {arr.type} for column {name}")

        def convert_field(name: str, arr: pa.Array) -> list[Column]:
            t = arr.type
            if pa.types.is_struct(t):
                # Nested groups (v1alpha2) flatten to dotted leaf columns;
                # a null struct row nulls every child (parent validity
                # intersects the children's).
                parent_valid = np.asarray(arr.is_valid())
                out: list[Column] = []
                for j in range(t.num_fields):
                    child_name = f"{name}.{t.field(j).name}"
                    for col in convert_field(child_name, arr.field(j)):
                        col.validity = col.validity & parent_valid
                        if col.kind not in (KIND_LIST,):
                            col.values = np.where(
                                col.validity, col.values,
                                col.values.dtype.type(0),
                            )
                        out.append(col)
                return out
            return [convert(name, arr)]

        cols: list[Column] = []
        n = rb.num_rows
        for i, f in enumerate(rb.schema):
            cols.extend(convert_field(f.name, rb.column(i)))
        return ColumnBatch(cols, n)


HASHED_PREFIX = "hashed."


def concat_batches(batches: Sequence[ColumnBatch]) -> ColumnBatch:
    """Concatenate batches with identical signatures."""
    assert batches
    if len(batches) == 1:
        return batches[0]
    sig = batches[0].signature()
    for b in batches[1:]:
        assert b.signature() == sig, "concat requires identical signatures"
    cols = []
    for i, c0 in enumerate(batches[0].columns):
        vals = np.concatenate([b.columns[i].values for b in batches])
        valid = np.concatenate([b.columns[i].validity for b in batches])
        offsets = child = None
        if c0.kind == KIND_LIST:
            parts = [b.columns[i] for b in batches]
            lengths = np.concatenate([np.diff(c.offsets) for c in parts])
            offsets = np.zeros(len(vals) + 1, dtype=np.int64)
            np.cumsum(lengths, out=offsets[1:])
            child = _concat_columns([c.child for c in parts])
        cols.append(
            Column(
                c0.name, c0.kind, vals, valid, c0.dictionary, c0.layout,
                offsets=offsets, child=child,
            )
        )
    return ColumnBatch(cols, sum(b.num_rows for b in batches))


def _concat_columns(cols: Sequence[Column]) -> Column:
    """Concatenate same-kind columns (list children concat recursively)."""
    c0 = cols[0]
    vals = np.concatenate([c.values for c in cols])
    valid = np.concatenate([c.validity for c in cols])
    offsets = child = None
    if c0.kind == KIND_LIST:
        lengths = np.concatenate([np.diff(c.offsets) for c in cols])
        offsets = np.zeros(len(vals) + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        child = _concat_columns([c.child for c in cols])
    return Column(
        c0.name, c0.kind, vals, valid, c0.dictionary, c0.layout,
        offsets=offsets, child=child,
    )
