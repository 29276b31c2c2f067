"""Per-query memory limiting (reference: query/memory.go LimitAllocator).

Byte-accounting allocator: operators reserve bytes before materializing
host/device buffers; exceeding the limit raises MemoryLimitExceeded, which
the engine surfaces as a query error (the reference panics with "memory
limit exceeded" and recovers it via recovery.Do, query/memory.go:64,
recovery/recovery.go:13).
"""

from __future__ import annotations

import threading


class MemoryLimitExceeded(RuntimeError):
    def __init__(self) -> None:
        super().__init__("memory limit exceeded")


class LimitAllocator:
    def __init__(self, limit_bytes: int):
        self.limit = limit_bytes
        self._allocated = 0
        self._lock = threading.Lock()

    def allocate(self, size: int) -> None:
        with self._lock:
            if self._allocated + size > self.limit:
                raise MemoryLimitExceeded()
            self._allocated += size

    def free(self, size: int) -> None:
        with self._lock:
            self._allocated = max(0, self._allocated - size)

    def allocated(self) -> int:
        with self._lock:
            return self._allocated
