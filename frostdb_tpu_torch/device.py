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

    def _upload(self, hc: Column) -> DeviceColumn:
        dtype = _KIND_TORCH_DTYPE[hc.kind]
        host = _host_values(hc.kind, hc.values)
        vals = np.zeros(self.n_pad, dtype=host.dtype)
        vals[: self.n_rows] = host
        valid = np.zeros(self.n_pad, dtype=np.bool_)
        valid[: self.n_rows] = hc.validity
        return DeviceColumn(
            hc.name,
            hc.kind,
            torch.from_numpy(vals).to(device=self.device, dtype=dtype),
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
