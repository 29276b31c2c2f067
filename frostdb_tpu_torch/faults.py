"""Write-fault injection (reference: dst/vfs/fs.go:24 — the DST's vfs
returns EIO on writes while the system keeps running, exercising the error
paths a kill-only model never reaches: failed fsync, partial appends
mid-operation, snapshot write failures).

A ``FaultInjector`` is wired through ColumnStore into the WAL, disk index
levels, and snapshot writer. When it fires, the site writes a random
PREFIX of the buffer first (a real EIO can land mid-write), then raises
``OSError(EIO)``; every durable writer recovers by truncating back to its
pre-write size, so an injected fault can tear only the tail it just wrote.
"""

from __future__ import annotations

import errno
from typing import Optional

import numpy as np


class FaultInjector:
    """Seeded probabilistic EIO injection, one decision per (op) call."""

    def __init__(
        self,
        seed: int = 0,
        p_write: float = 0.0,
        p_fsync: float = 0.0,
        p_snapshot: float = 0.0,
    ):
        self.rng = np.random.default_rng(seed)
        self.p_write = p_write
        self.p_fsync = p_fsync
        self.p_snapshot = p_snapshot
        self.injected = 0

    def _fire(self, p: float) -> bool:
        if p <= 0.0:
            return False
        if self.rng.random() < p:
            self.injected += 1
            return True
        return False

    def partial_len(self, n: int) -> int:
        """How many bytes of an n-byte buffer land before the fault."""
        return int(self.rng.integers(0, max(n, 1)))

    def write_fails(self) -> bool:
        return self._fire(self.p_write)

    def fsync_fails(self) -> bool:
        return self._fire(self.p_fsync)

    def snapshot_fails(self) -> bool:
        return self._fire(self.p_snapshot)


def eio(op: str) -> OSError:
    return OSError(errno.EIO, f"injected I/O error during {op}")


def faulty_append(f, data: bytes, injector: Optional[FaultInjector], op: str):
    """Append ``data`` to file object ``f``; under injection, write a random
    prefix then raise EIO (callers truncate back to their recorded size)."""
    if injector is not None and injector.write_fails():
        k = injector.partial_len(len(data))
        if k:
            f.write(data[:k])
            f.flush()
        raise eio(op)
    f.write(data)


def faulty_fsync(fileno: int, injector: Optional[FaultInjector], op: str):
    import os

    os.fsync(fileno)
    if injector is not None and injector.fsync_fails():
        # The data may or may not be durable after a failed fsync; the
        # conservative caller treats the write as failed.
        raise eio(op)
