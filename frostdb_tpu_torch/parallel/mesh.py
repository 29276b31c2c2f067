"""Device mesh + partitioned tables (reference:
frostdb_tpu/parallel/mesh.py).

A ``Mesh`` is a 1D grid of shards along a named axis, one torch device per
shard; one process drives every shard, as the reference's single
controller drives its ``shard_map`` programs. Several shards may share a
device (all shards of a CPU mesh share the CPU, as XLA's virtual host
devices do); results do not depend on where a shard is placed.

A ``PartitionedTable`` holds a table's columns as row-sharded tensors over
the mesh — the device-resident, always-ready-to-scan representation.
Partitioning is either round-robin by row (scan-only workloads) or hashed
on a key column (aggregation/join workloads need no reshuffling).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..columnbatch import ColumnBatch
from ..config import DEFAULT_DEVICE, ROW_TILE, resolve_device
from ..device import ShardedTensor, _KIND_TORCH_DTYPE, _host_values, upload_shards


@dataclass(frozen=True)
class Mesh:
    """A 1D mesh: one device per shard along one named axis
    (``shape[axis]`` shards)."""

    axis_names: tuple
    devices: tuple

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.devices)}


def make_mesh(
    n_devices: Optional[int] = None, axis: str = "shards", device=DEFAULT_DEVICE
) -> Mesh:
    """1D mesh of ``n_devices`` shards (every visible device of
    ``device``'s type when not given: the GPUs, or the one CPU). Shard ``i``
    lies on device ``(first + i) % count`` of the ``count`` visible ones,
    ``first`` being ``device``'s index, so more shards than devices share
    them round-robin; a CPU mesh puts every shard on the CPU."""
    dev: torch.device = resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        first = torch.cuda.current_device() if dev.index is None else dev.index
        n = count if n_devices is None else int(n_devices)
        devs = tuple(torch.device("cuda", (first + i) % count) for i in range(n))
    else:
        n = 1 if n_devices is None else int(n_devices)
        devs = (dev,) * n
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, not {n}")
    return Mesh((axis,), devs)


def _pad_to(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@dataclass
class ShardedColumn:
    name: str
    kind: str
    data: ShardedTensor  # [n_pad] sharded along the mesh axis
    validity: ShardedTensor  # [n_pad] bool, sharded


class PartitionedTable:
    """Row-sharded device mirror of a column batch.

    Rows are padded so each shard holds an equal, tile-aligned slice;
    padding rows are invalid. ``from_batch`` with a hash key redistributes
    rows so that equal keys land on the same shard (the shuffle happens
    once at load, all queries after that need no repartitioning — the
    analogue of the reference's insert-time pre-hashing,
    dynparquet/hashed.go:38).
    """

    def __init__(self, mesh: Mesh, axis: str = "shards"):
        self.mesh = mesh
        self.axis = axis
        self.columns: dict[str, ShardedColumn] = {}
        self.n_rows = 0
        self.n_pad = 0

    @property
    def n_shards(self) -> int:
        return self.mesh.shape[self.axis]

    @staticmethod
    def from_batch(
        batch: ColumnBatch,
        mesh: Mesh,
        axis: str = "shards",
        hash_key: Optional[str] = None,
    ) -> "PartitionedTable":
        t = PartitionedTable(mesh, axis)
        n = batch.num_rows
        n_shards = mesh.shape[axis]

        if hash_key is not None:
            key_col = batch.column(hash_key)
            assert key_col is not None, hash_key
            keys = key_col.values.astype(np.int64)
            shard_of_row = _hash_int64(keys) % n_shards
            order = np.argsort(shard_of_row, kind="stable")
            batch = batch.take(order)
            shard_of_row = shard_of_row[order]
            counts = np.bincount(shard_of_row, minlength=n_shards)
            per_shard = _pad_to(max(int(counts.max()), 1), ROW_TILE)
            # Scatter rows into equal-size shard slots.
            starts = np.zeros(n_shards, dtype=np.int64)
            starts[1:] = np.cumsum(counts)[:-1]
            dest = (
                shard_of_row * per_shard
                + (np.arange(n, dtype=np.int64) - starts[shard_of_row])
            )
        else:
            per_shard = _pad_to(-(-max(n, 1) // n_shards), ROW_TILE)
            dest = None  # rows packed contiguously

        n_pad = per_shard * n_shards
        for c in batch.columns:
            host = _host_values(c.kind, c.values)
            vals = np.zeros(n_pad, dtype=host.dtype)
            valid = np.zeros(n_pad, dtype=np.bool_)
            if dest is None:
                vals[:n] = host
                valid[:n] = c.validity
            else:
                vals[dest] = host
                valid[dest] = c.validity
            t.columns[c.name] = ShardedColumn(
                c.name,
                c.kind,
                upload_shards(vals, mesh.devices, _KIND_TORCH_DTYPE[c.kind]),
                upload_shards(valid, mesh.devices, torch.bool),
            )
        t.n_rows = n
        t.n_pad = n_pad
        t.host = batch
        return t

    def column(self, name: str) -> ShardedColumn:
        return self.columns[name]


def _hash_int64(x: np.ndarray) -> np.ndarray:
    """Multiply-shift mix (the reference hashes group keys with metro-hash,
    dynparquet/hashed.go:86; any good 64-bit mix works for partitioning)."""
    x = x.astype(np.uint64)
    x = (x ^ (x >> np.uint64(33))) * np.uint64(0xFF51AFD7ED558CCD)
    x = (x ^ (x >> np.uint64(33))) * np.uint64(0xC4CEB9FE1A85EC53)
    x = x ^ (x >> np.uint64(33))
    return (x & np.uint64(0x7FFFFFFFFFFFFFFF)).astype(np.int64)


# The mix's multipliers as the int64 values with the same bits.
_M1 = 0xFF51AFD7ED558CCD - (1 << 64)
_M2 = 0xC4CEB9FE1A85EC53 - (1 << 64)
_LOW31 = (1 << 31) - 1


def _shr33(x: torch.Tensor) -> torch.Tensor:
    """Logical right shift by 33 of int64 bits (torch's >> is arithmetic)."""
    return (x >> 33) & _LOW31


def hash_int64_device(x: torch.Tensor) -> torch.Tensor:
    """``_hash_int64`` on the tensor's device, bit for bit: uint64 emulated
    in int64 (multiplies wrap alike; the shift is made logical)."""
    x = x.to(torch.int64)
    x = (x ^ _shr33(x)) * _M1
    x = (x ^ _shr33(x)) * _M2
    x = x ^ _shr33(x)
    return x & 0x7FFFFFFFFFFFFFFF
