"""Cross-shard collectives over lists of per-shard tensors.

The reference's shard programs call ``jax.lax.psum``/``pmin``/``pmax``,
``all_to_all``, ``all_gather`` and ``axis_index`` inside ``shard_map``. Here
one controller drives every shard, so a shard program is a sequence of
phases over the list of shards, split at each collective, and a collective
is a function from the list of per-shard inputs to the list of per-shard
outputs. Every input and output ``xs[s]`` lies on shard ``s``'s device;
data moves with ``.to(dest_device)``, a no-op where the devices coincide,
so shards that share a device run the same code as shards on separate
devices.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _devices(xs: Sequence[torch.Tensor]) -> list:
    return [x.device for x in xs]


def _reduce(xs: Sequence[torch.Tensor], op) -> list:
    """``op``-fold of every shard's value on shard 0's device, then a copy
    to every shard (the all-reduce's result is replicated)."""
    acc = xs[0]
    for x in xs[1:]:
        acc = op(acc, x.to(acc.device))
    return [acc.to(d) for d in _devices(xs)]


def psum(xs: Sequence[torch.Tensor]) -> list:
    """Elementwise sum over shards (int64 adds wrap, as XLA's do)."""
    return _reduce(xs, torch.add)


def pmin(xs: Sequence[torch.Tensor]) -> list:
    return _reduce(xs, torch.minimum)


def pmax(xs: Sequence[torch.Tensor]) -> list:
    return _reduce(xs, torch.maximum)


def all_to_all(xs: Sequence[torch.Tensor]) -> list:
    """Non-tiled all_to_all over dim 0: every ``xs[s]`` has shape
    [n_shards, ...]; block ``s`` of output ``d`` is block ``d`` of input
    ``s``."""
    return [
        torch.stack([x[d].to(dev) for x in xs])
        for d, dev in enumerate(_devices(xs))
    ]


def all_gather(xs: Sequence[torch.Tensor]) -> list:
    """Tiled all_gather over dim 0: every shard gets the concatenation of
    all shards' values in shard order."""
    return [torch.cat([x.to(dev) for x in xs]) for dev in _devices(xs)]


def axis_index(n_shards: int) -> range:
    """Each shard's position along the mesh axis."""
    return range(n_shards)
