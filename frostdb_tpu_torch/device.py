"""Device-resident column data.

A ``DeviceBatch`` mirrors a host ``ColumnBatch`` as padded torch tensors on
an explicit device: data vector + bool validity per column, padded to
``config.pad_length`` rows. Padding rows are invalid (validity False) and
excluded from every kernel by the selection mask.

uint64 columns are stored as int64 with the sign bit flipped (``v ^ 2^63``),
so signed compares, sorts and scatters keep the unsigned order on every
device (torch's uint64 has no CUDA coverage for those ops); ``to_host``
flips the bit back.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .config import pad_length, resolve_device
from .columnbatch import (
    Column,
    ColumnBatch,
    KIND_BOOL,
    KIND_DICT,
    KIND_FLOAT64,
    KIND_INT64,
    KIND_UINT64,
)

_KIND_TORCH_DTYPE = {
    KIND_INT64: torch.int64,
    KIND_UINT64: torch.int64,  # sign-flipped, see module docstring
    KIND_FLOAT64: torch.float64,
    KIND_BOOL: torch.bool,
    KIND_DICT: torch.int32,
    # Lists upload their per-row content hashes (see columnbatch.KIND_LIST):
    # device kernels group/distinct lists as scalar hash keys while the
    # variable-length payload stays host-side.
    "list": torch.int64,
}

_U64_FLIP = np.uint64(1 << 63)


def _host_values(kind: str, values: np.ndarray) -> np.ndarray:
    """Host values in the device representation (uint64 sign-flipped)."""
    if kind == KIND_UINT64:
        return (np.asarray(values, dtype=np.uint64) ^ _U64_FLIP).view(np.int64)
    return np.asarray(values)


@dataclass
class DeviceColumn:
    name: str
    kind: str
    data: torch.Tensor  # [n_pad]
    validity: torch.Tensor  # [n_pad] bool

    def to_host(self, n_rows: int, host_col: Column) -> Column:
        vals = self.data[:n_rows].cpu().numpy()
        if self.kind == KIND_UINT64:
            vals = vals.view(np.uint64) ^ _U64_FLIP
        return Column(
            self.name,
            self.kind,
            vals,
            self.validity[:n_rows].cpu().numpy(),
            host_col.dictionary if host_col is not None else None,
        )


class DeviceBatch:
    """Padded device mirror of a host batch on ``device``."""

    def __init__(self, cb: ColumnBatch, device):
        self.host = cb
        self.device = resolve_device(device)
        self.n_rows = cb.num_rows
        self.n_pad = pad_length(max(cb.num_rows, 1))
        self._cols: dict[str, DeviceColumn] = {}

    def column(self, name: str) -> DeviceColumn | None:
        dc = self._cols.get(name)
        if dc is not None:
            return dc
        hc = self.host.column(name)
        if hc is None:
            return None
        dc = self._upload(hc)
        self._cols[name] = dc
        return dc

    def upload(self) -> None:
        """Every column on the device now (``column`` uploads a column on
        its first use)."""
        for hc in self.host.columns:
            self.column(hc.name)

    def _padded(self, hc: Column) -> tuple:
        """(values, validity) on the host, padded to ``n_pad`` rows."""
        host = _host_values(hc.kind, hc.values)
        vals = np.zeros(self.n_pad, dtype=host.dtype)
        vals[: self.n_rows] = host
        valid = np.zeros(self.n_pad, dtype=np.bool_)
        valid[: self.n_rows] = hc.validity
        return vals, valid

    def _upload(self, hc: Column) -> DeviceColumn:
        vals, valid = self._padded(hc)
        return DeviceColumn(
            hc.name,
            hc.kind,
            torch.from_numpy(vals).to(device=self.device, dtype=_KIND_TORCH_DTYPE[hc.kind]),
            torch.from_numpy(valid).to(self.device),
        )

    def derived(self, key: str, compute) -> DeviceColumn:
        """Cached upload of a column DERIVED from this batch's host data
        (e.g. float-sum digit planes, floatsum.py): ``compute()`` returns a
        host Column; the upload happens once per (batch, key)."""
        dc = self._cols.get(key)
        if dc is None:
            dc = self._cols[key] = self._upload(compute())
        return dc

    def row_valid_mask(self) -> torch.Tensor:
        """Mask selecting real (non-padding) rows."""
        return torch.arange(self.n_pad, device=self.device) < self.n_rows


class ShardedTensor(tuple):
    """One tensor per mesh shard, each on its shard's device: the port's
    counterpart of a ``jax.Array`` sharded along a 1D mesh axis. Shard ``s``
    of a row-sharded [n_pad] tensor holds rows ``[s * per, (s + 1) * per)``;
    a replicated value holds the whole value on every shard.
    ``numpy()`` (and ``np.asarray``) gives the concatenation, the
    reference's [n_pad] layout slot for slot."""

    @property
    def shape(self) -> tuple:
        return (sum(t.shape[0] for t in self),) + tuple(self[0].shape[1:])

    def numpy(self) -> np.ndarray:
        return np.concatenate([t.cpu().numpy() for t in self])

    def __array__(self, dtype=None, copy=None):
        out = self.numpy()
        return out if dtype is None else out.astype(dtype)


def upload_shards(host: np.ndarray, devices, dtype) -> ShardedTensor:
    """A padded host vector split into equal row ranges, range ``s`` copied
    to ``devices[s]`` as ``dtype``."""
    per = len(host) // len(devices)
    return ShardedTensor(
        torch.from_numpy(host[s * per : (s + 1) * per]).to(device=d, dtype=dtype)
        for s, d in enumerate(devices)
    )


# Process-wide upload accounting of sharded part mirrors (host bytes of the
# padded data and validity vectors) — lets tests assert the mesh scan is
# incremental: an insert between two queries uploads only the new part's
# bytes.
SHARDED_UPLOAD_STATS = {"columns": 0, "bytes": 0}


class ShardedDeviceBatch(DeviceBatch):
    """Row-sharded device mirror of a host batch over a mesh axis.

    The mesh analogue of ``DeviceBatch`` (whose ``column`` and ``derived``
    caches it shares): each column is a ShardedTensor, rows packed
    contiguously (part row r lives on shard ``r // per_shard`` at offset
    ``r % per_shard``, ``per_shard`` rounded up to ROW_TILE), padding rows
    carry validity False and sit past ``n_rows``. Parts cache one of these
    per (mesh, axis) — the incremental upload unit of the mesh scan (the
    role the reference's per-part incremental Scan plays,
    index/lsm.go:401): a part-set change uploads only the NEW parts'
    columns, never the whole table.
    """

    def __init__(self, cb: ColumnBatch, mesh, axis: str):
        from .config import ROW_TILE

        self.host = cb
        self.mesh = mesh
        self.axis = axis
        self.n_rows = cb.num_rows
        n_shards = mesh.shape[axis]
        per = -(-max(cb.num_rows, 1) // n_shards)
        self.per_shard = ((per + ROW_TILE - 1) // ROW_TILE) * ROW_TILE
        self.n_pad = self.per_shard * n_shards
        self._cols: dict[str, DeviceColumn] = {}

    def _upload(self, hc: Column) -> DeviceColumn:
        vals, valid = self._padded(hc)
        dc = DeviceColumn(
            hc.name,
            hc.kind,
            upload_shards(vals, self.mesh.devices, _KIND_TORCH_DTYPE[hc.kind]),
            upload_shards(valid, self.mesh.devices, torch.bool),
        )
        SHARDED_UPLOAD_STATS["columns"] += 1
        SHARDED_UPLOAD_STATS["bytes"] += vals.nbytes + valid.nbytes
        return dc
