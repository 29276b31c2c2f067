"""Self-contained Apache Avro codec (Object Container Files + binary
encoding) — the subset Iceberg metadata needs, implemented from the Avro
1.11 specification. No third-party Avro library exists in this image, and
Iceberg manifests/manifest-lists are Avro container files (reference:
storage/iceberg.go uses iceberg-go, whose manifests are Avro per the
Iceberg spec), so this module is the honest native substrate for
iceberg.py.

Supported schema types: null, boolean, int, long, float, double, bytes,
string, fixed, enum, record, array, map, union, and named-type references.
Codecs: null and deflate (raw zlib streams, per the Avro spec). Logical
types are passed through as their underlying type.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, Callable, Optional

MAGIC = b"Obj\x01"
SYNC_SIZE = 16

_PRIMITIVES = {
    "null",
    "boolean",
    "int",
    "long",
    "float",
    "double",
    "bytes",
    "string",
}


class AvroError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Schema model


class _Schema:
    """Parsed schema node: ``type`` is the primitive/complex kind; complex
    kinds carry their sub-schemas."""

    __slots__ = ("type", "fields", "items", "values", "symbols", "size", "name", "branches")

    def __init__(self, type_: str):
        self.type = type_
        self.fields: list[tuple[str, "_Schema", bool, Any]] = []  # (name, schema, has_default, default)
        self.items: Optional[_Schema] = None
        self.values: Optional[_Schema] = None
        self.symbols: list[str] = []
        self.size = 0
        self.name = ""
        self.branches: list[_Schema] = []


def parse_schema(schema_json, named: Optional[dict] = None) -> _Schema:
    """Parse a JSON Avro schema (dict/list/str) into a _Schema tree.
    ``named`` is the registry for named-type references."""
    if named is None:
        named = {}
    s = schema_json
    if isinstance(s, str):
        if s in _PRIMITIVES:
            return _Schema(s)
        if s in named:
            return named[s]
        raise AvroError(f"unknown type reference {s!r}")
    if isinstance(s, list):
        node = _Schema("union")
        node.branches = [parse_schema(b, named) for b in s]
        return node
    if not isinstance(s, dict):
        raise AvroError(f"bad schema node: {s!r}")
    t = s["type"]
    if isinstance(t, (dict, list)):
        # e.g. {"type": {"type": "array", ...}} nesting
        return parse_schema(t, named)
    if t in _PRIMITIVES:
        return _Schema(t)
    if t == "record" or t == "error":
        node = _Schema("record")
        node.name = s.get("name", "")
        full = _fullname(s)
        if full:
            named[full] = node
            named[s.get("name", "")] = node
        for f in s.get("fields", []):
            fs = parse_schema(f["type"], named)
            node.fields.append(
                (f["name"], fs, "default" in f, f.get("default"))
            )
        return node
    if t == "array":
        node = _Schema("array")
        node.items = parse_schema(s["items"], named)
        return node
    if t == "map":
        node = _Schema("map")
        node.values = parse_schema(s["values"], named)
        return node
    if t == "enum":
        node = _Schema("enum")
        node.name = s.get("name", "")
        node.symbols = list(s["symbols"])
        full = _fullname(s)
        if full:
            named[full] = node
            named[s.get("name", "")] = node
        return node
    if t == "fixed":
        node = _Schema("fixed")
        node.name = s.get("name", "")
        node.size = int(s["size"])
        full = _fullname(s)
        if full:
            named[full] = node
            named[s.get("name", "")] = node
        return node
    if t in named:
        return named[t]
    raise AvroError(f"unsupported avro type {t!r}")


def _fullname(s: dict) -> str:
    name = s.get("name", "")
    ns = s.get("namespace", "")
    return f"{ns}.{name}" if ns and name and "." not in name else name


# ---------------------------------------------------------------------------
# Binary decoding


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise AvroError("truncated avro data")
        b = self.data[self.pos : self.pos + n]
        self.pos += n
        return b

    def read_long(self) -> int:
        shift = 0
        acc = 0
        while True:
            b = self.data[self.pos]
            self.pos += 1
            acc |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
            if shift > 70:
                raise AvroError("varint too long")
        return (acc >> 1) ^ -(acc & 1)  # zigzag

    def at_end(self) -> bool:
        return self.pos >= len(self.data)


def _decode(r: _Reader, s: _Schema):
    t = s.type
    if t == "null":
        return None
    if t == "boolean":
        return r.read(1) != b"\x00"
    if t in ("int", "long"):
        return r.read_long()
    if t == "float":
        return struct.unpack("<f", r.read(4))[0]
    if t == "double":
        return struct.unpack("<d", r.read(8))[0]
    if t == "bytes":
        return r.read(r.read_long())
    if t == "string":
        return r.read(r.read_long()).decode("utf-8")
    if t == "fixed":
        return r.read(s.size)
    if t == "enum":
        return s.symbols[r.read_long()]
    if t == "union":
        return _decode(r, s.branches[r.read_long()])
    if t == "record":
        return {name: _decode(r, fs) for name, fs, _hd, _d in s.fields}
    if t == "array":
        out = []
        while True:
            count = r.read_long()
            if count == 0:
                return out
            if count < 0:
                r.read_long()  # block byte size, unused
                count = -count
            for _ in range(count):
                out.append(_decode(r, s.items))
    if t == "map":
        out = {}
        while True:
            count = r.read_long()
            if count == 0:
                return out
            if count < 0:
                r.read_long()
                count = -count
            for _ in range(count):
                k = r.read(r.read_long()).decode("utf-8")
                out[k] = _decode(r, s.values)
    raise AvroError(f"cannot decode type {t}")


# ---------------------------------------------------------------------------
# Binary encoding


def _zigzag(n: int) -> bytes:
    n = (n << 1) ^ (n >> 63) if n < 0 else (n << 1)
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _encode(w: bytearray, s: _Schema, v) -> None:
    t = s.type
    if t == "null":
        return
    if t == "boolean":
        w += b"\x01" if v else b"\x00"
        return
    if t in ("int", "long"):
        w += _zigzag(int(v))
        return
    if t == "float":
        w += struct.pack("<f", float(v))
        return
    if t == "double":
        w += struct.pack("<d", float(v))
        return
    if t == "bytes":
        w += _zigzag(len(v))
        w += bytes(v)
        return
    if t == "string":
        b = v.encode("utf-8")
        w += _zigzag(len(b))
        w += b
        return
    if t == "fixed":
        if len(v) != s.size:
            raise AvroError(f"fixed size mismatch: {len(v)} != {s.size}")
        w += bytes(v)
        return
    if t == "enum":
        w += _zigzag(s.symbols.index(v))
        return
    if t == "union":
        # pick the first branch that accepts the value (null first is the
        # common optional pattern)
        for i, b in enumerate(s.branches):
            if _union_match(b, v):
                w += _zigzag(i)
                _encode(w, b, v)
                return
        raise AvroError(f"no union branch for {v!r}")
    if t == "record":
        for name, fs, has_default, default in s.fields:
            if isinstance(v, dict) and name in v:
                fv = v[name]
            elif has_default:
                fv = default
            else:
                raise AvroError(f"missing record field {name}")
            _encode(w, fs, fv)
        return
    if t == "array":
        if v:
            w += _zigzag(len(v))
            for item in v:
                _encode(w, s.items, item)
        w += _zigzag(0)
        return
    if t == "map":
        if v:
            w += _zigzag(len(v))
            for k, mv in v.items():
                kb = k.encode("utf-8")
                w += _zigzag(len(kb))
                w += kb
                _encode(w, s.values, mv)
        w += _zigzag(0)
        return
    raise AvroError(f"cannot encode type {t}")


def _union_match(s: _Schema, v) -> bool:
    t = s.type
    if t == "null":
        return v is None
    if v is None:
        return False
    if t == "boolean":
        return isinstance(v, bool)
    if t in ("int", "long"):
        return isinstance(v, int) and not isinstance(v, bool)
    if t in ("float", "double"):
        return isinstance(v, float)
    if t in ("bytes", "fixed"):
        return isinstance(v, (bytes, bytearray))
    if t == "string":
        return isinstance(v, str)
    if t == "record":
        return isinstance(v, dict)
    if t == "array":
        return isinstance(v, list)
    if t == "map":
        return isinstance(v, dict)
    if t == "enum":
        return isinstance(v, str)
    return False


# ---------------------------------------------------------------------------
# Object container files


def read_container(data: bytes) -> tuple[dict, list]:
    """Read an Avro Object Container File; returns (file_metadata, records).
    file_metadata values are bytes; the embedded writer schema drives
    decoding."""
    r = _Reader(data)
    if r.read(4) != MAGIC:
        raise AvroError("bad avro magic")
    meta_schema = _Schema("map")
    meta_schema.values = _Schema("bytes")
    meta = _decode(r, meta_schema)
    sync = r.read(SYNC_SIZE)
    schema = parse_schema(json.loads(meta["avro.schema"].decode("utf-8")))
    codec = meta.get("avro.codec", b"null").decode("utf-8")
    records = []
    while not r.at_end():
        count = r.read_long()
        size = r.read_long()
        block = r.read(size)
        if codec == "deflate":
            block = zlib.decompress(block, wbits=-15)
        elif codec != "null":
            raise AvroError(f"unsupported codec {codec}")
        if r.read(SYNC_SIZE) != sync:
            raise AvroError("sync marker mismatch")
        br = _Reader(block)
        for _ in range(count):
            records.append(_decode(br, schema))
    return meta, records


def write_container(
    schema_json,
    records: list,
    metadata: Optional[dict] = None,
    codec: str = "deflate",
) -> bytes:
    """Serialize records into an Avro Object Container File."""
    schema = parse_schema(schema_json)
    meta = {
        "avro.schema": json.dumps(schema_json).encode("utf-8"),
        "avro.codec": codec.encode("utf-8"),
    }
    for k, v in (metadata or {}).items():
        meta[k] = v if isinstance(v, bytes) else str(v).encode("utf-8")
    sync = os.urandom(SYNC_SIZE)

    out = bytearray()
    out += MAGIC
    meta_schema = _Schema("map")
    meta_schema.values = _Schema("bytes")
    _encode(out, meta_schema, meta)
    out += sync

    body = bytearray()
    for rec in records:
        _encode(body, schema, rec)
    block = bytes(body)
    if codec == "deflate":
        co = zlib.compressobj(9, zlib.DEFLATED, -15)
        block = co.compress(block) + co.flush()
    elif codec != "null":
        raise AvroError(f"unsupported codec {codec}")
    out += _zigzag(len(records))
    out += _zigzag(len(block))
    out += block
    out += sync
    return bytes(out)
