"""Device mesh record.

The reference's ``make_mesh`` builds a ``jax.sharding.Mesh``: a 1D grid of
devices along a named axis that its SPMD programs shard rows over. This
package runs on one device so far: ``make_mesh`` returns a one-device mesh
record, on which every cross-shard combine is the identity. Row-sharded
tables (``PartitionedTable``) and meshes of more than one device come with
multi-device execution.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..config import DEFAULT_DEVICE, resolve_device


@dataclass(frozen=True)
class Mesh:
    """A 1D mesh: ``devices`` along one named axis (``shape[axis]`` devices
    on it)."""

    axis_names: tuple
    devices: tuple

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.devices)}


def make_mesh(
    n_devices: Optional[int] = None, axis: str = "shards", device=DEFAULT_DEVICE
) -> Mesh:
    """A 1D mesh over ``n_devices`` devices (one when not given) starting
    at ``device``. Only one-device meshes exist so far; more raise
    NotImplementedError."""
    n = 1 if n_devices is None else int(n_devices)
    if n != 1:
        raise NotImplementedError(
            f"a mesh of {n} devices: multi-device execution is not ported"
        )
    dev: torch.device = resolve_device(device)
    return Mesh((axis,), (dev,))
