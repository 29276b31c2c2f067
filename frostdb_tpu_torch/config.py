"""Global configuration for frostdb_tpu_torch: row padding and the device
rule.

Device rule: every entry point takes an explicit ``device``. The default is
``"cuda"``; with it and no visible GPU, ``resolve_device`` raises instead of
dropping to the CPU. Callers that want the CPU (the tests) pass
``device="cpu"``.
"""

from __future__ import annotations

import torch

# Row-count padding: device batches are padded up to a multiple of ROW_TILE
# rows so every kernel sees aligned shapes.
ROW_TILE = 1024

# Minimum padded batch size.
MIN_PAD_ROWS = 1024


def pad_length(n: int) -> int:
    """Padded length for a batch of n rows: next power of two of the row
    tile, so padded shapes take O(log n) distinct values."""
    if n <= MIN_PAD_ROWS:
        return MIN_PAD_ROWS
    p = MIN_PAD_ROWS
    while p < n:
        p *= 2
    return p


# Scan fan-out: minimum total surviving rows before a query's part stream is
# split across lane threads (below this, thread spawn overhead exceeds the
# numpy GIL-released overlap win; results are byte-identical either way —
# see Table._iterate).
PARALLEL_SCAN_MIN_ROWS = 32768

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """The torch device an entry point runs on. A CUDA device with no
    visible GPU raises: the port never drops silently to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is visible; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
