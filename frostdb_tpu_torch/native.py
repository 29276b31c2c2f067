"""Loader for the native C++ runtime (native/frostdb_native.cpp).

Compiles on first use into a source-hash-keyed file under the checkout's
``build/native/`` (no pip / prebuilt binaries needed) and exposes the C
ABI via ctypes. All callers fall back to pure-Python implementations when the toolchain is missing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_ROOT = os.path.join(os.path.dirname(__file__), "..")
# The C++ runtime is shared with the JAX package; it sits outside both.
_SRC = os.path.join(_ROOT, "native", "frostdb_native.cpp")
# Built objects stay inside the checkout (``build/`` is git-ignored).
_CACHE = os.path.join(_ROOT, "build", "native")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        src_path = os.path.abspath(_SRC)
        if not os.path.exists(src_path):
            return None
        with open(src_path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        os.makedirs(_CACHE, exist_ok=True)
        so_path = os.path.join(_CACHE, f"libfrostdb_native-{digest}.so")
        if not os.path.exists(so_path):
            tmp = so_path + ".tmp"
            subprocess.run(
                [
                    "g++",
                    "-O3",
                    "-std=c++17",
                    "-fPIC",
                    "-shared",
                    "-o",
                    tmp,
                    src_path,
                ],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(so_path)
        lib.fdb_dict_new.restype = ctypes.c_void_p
        lib.fdb_dict_free.argtypes = [ctypes.c_void_p]
        lib.fdb_dict_size.argtypes = [ctypes.c_void_p]
        lib.fdb_dict_size.restype = ctypes.c_int64
        lib.fdb_dict_encode.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.fdb_dict_lookup.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_int64,
        ]
        lib.fdb_dict_lookup.restype = ctypes.c_int32
        lib.fdb_dict_arena_size.argtypes = [ctypes.c_void_p]
        lib.fdb_dict_arena_size.restype = ctypes.c_int64
        lib.fdb_dict_export.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.fdb_dict_hashes.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.fdb_hash64.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.fdb_hash64.restype = ctypes.c_int64
        lib.fdb_crc32.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_uint32,
        ]
        lib.fdb_crc32.restype = ctypes.c_uint32
        _lib = lib
    except Exception:
        _lib = None
    return _lib


class NativeDict:
    """C++-owned append-only string dictionary (see columnbatch.Dictionary
    for the role it plays). Values are exported lazily for host formatting
    and sort-rank computation."""

    def __init__(self):
        lib = load()
        assert lib is not None
        self._lib = lib
        self._h = ctypes.c_void_p(lib.fdb_dict_new())
        self._values_cache: list[str] = []

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.fdb_dict_free(self._h)
        except Exception:
            pass

    def __len__(self) -> int:
        return int(self._lib.fdb_dict_size(self._h))

    def encode_batch(
        self, values: list[str | None]
    ) -> tuple[np.ndarray, np.ndarray]:
        n = len(values)
        parts = []
        offsets = np.zeros(n + 1, dtype=np.int64)
        nulls = np.zeros(n, dtype=np.uint8)
        total = 0
        for i, v in enumerate(values):
            if v is None:
                nulls[i] = 1
                offsets[i + 1] = total
                continue
            b = v.encode("utf-8", "surrogateescape")
            parts.append(b)
            total += len(b)
            offsets[i + 1] = total
        blob = b"".join(parts)
        out = np.zeros(n, dtype=np.int32)
        self._lib.fdb_dict_encode(
            self._h,
            blob,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            nulls.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return out, nulls == 0

    def lookup(self, value: str) -> int | None:
        b = value.encode("utf-8", "surrogateescape")
        c = int(self._lib.fdb_dict_lookup(self._h, b, len(b)))
        return None if c < 0 else c

    def values(self) -> list[str]:
        n = len(self)
        if len(self._values_cache) == n:
            return self._values_cache
        arena_size = int(self._lib.fdb_dict_arena_size(self._h))
        arena = ctypes.create_string_buffer(max(arena_size, 1))
        offsets = np.zeros(n + 1, dtype=np.uint64)
        self._lib.fdb_dict_export(
            self._h,
            arena,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        )
        raw = arena.raw[:arena_size]
        self._values_cache = [
            raw[int(offsets[i]) : int(offsets[i + 1])].decode(
                "utf-8", "surrogateescape"
            )
            for i in range(n)
        ]
        return self._values_cache

    def hashes(self) -> np.ndarray:
        n = len(self)
        out = np.zeros(n, dtype=np.int64)
        if n:
            self._lib.fdb_dict_hashes(
                self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
            )
        return out


def crc32(data: bytes, seed: int = 0) -> int:
    lib = load()
    if lib is None:
        import zlib

        return zlib.crc32(data, seed) & 0xFFFFFFFF
    return int(lib.fdb_crc32(data, len(data), seed)) & 0xFFFFFFFF


def available() -> bool:
    return load() is not None
