"""Hand-written CUDA kernels of the compiled serving path, with their
wrappers, plain PyTorch versions and launch counters.

The counterpart of ``frostdb_tpu/ops/pallas_agg.py``. Source:
``csrc/agg.cu``, built for ``sm_90a`` with ``nvcc`` into a shared library
with a plain C interface at first use (under the checkout's
``build/kernels/``, keyed by a hash of the source and flags), and loaded
with ``ctypes``. Importing this module builds and loads nothing.

| wrapper                       | replaces (pallas_agg.py)               |
| ----------------------------- | -------------------------------------- |
| ``group_sum_count``           | ``pallas_group_sum_count``             |
| ``fused_band_group_sum_count``| ``pallas_fused_band_group_sum_count``  |
| ``fused_cmp_group_sum_count`` | ``pallas_fused_cmp_group_sum_count``   |
| ``group_min_max``             | ``pallas_group_min_max``               |

Bound on the card: memory bandwidth. Per row, the sum/count kernels read
the code, the value and one predicate plane per clause (12 B/row for one
plane, 13 B/row with the int8 base plane); min/max reads codes, values and
the selection (12 B/row). Their arithmetic is a handful of integer ops per
row, far below the card's rate, so the bound is bytes / 3.35 TB/s. The
design reads each plane once, evaluates the predicate in registers (no
selection plane is written), and keeps the per-code table in shared
memory; only [K]-sized partials reach device memory. Its shared atomics
keep it from that bound where a warp's rows share a code (compacted parts
are sorted by label): see ``csrc/agg.cu`` and PERF.md.

Contract differences from the Pallas entries: the third result is the
EXACT first selected row per code (INT32_MAX when absent), not the first
8192-row superblock; inputs are any same-shape contiguous int32 planes
(the compiled layer's ``[slabs, 128]`` layout reads as flat rows).

A wrapper takes its plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel or raises; a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Sequence

import torch

from . import fused

MAX_CODES = 2048
_I32_MIN = -(2**31)
_I32_MAX = 2**31 - 1

# Launches of each kernel (counted only where the kernel is launched; the
# plain versions do not count).
LAUNCHES: dict[str, int] = {
    "group_sum_count": 0,
    "fused_band_group_sum_count": 0,
    "fused_cmp_group_sum_count": 0,
    "group_min_max": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_OPS = {"<": 0, "<=": 1, ">": 2, ">=": 3, "==": 4, "!=": 5}
_MODE_SEL, _MODE_BAND, _MODE_CMP8 = 0, 1, 2

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "agg.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-O3",
    "-std=c++17",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build() -> str:
    """Compile ``csrc/agg.cu`` (once per source and flag set) and return the
    shared library's path. Raises with the compiler's output on failure.
    ``-Xptxas -v``'s report is kept beside the library."""
    with open(SOURCE, "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so_path = os.path.join(BUILD_DIR, f"libagg-{digest}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    with open(so_path[:-3] + ".ptxas.txt", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, so_path)
    return so_path


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.fdb_group_sum_count.argtypes = (
                [i, i] + [p] * 6 + [i] * 6
                + [ctypes.c_longlong, i, ctypes.c_uint] + [p] * 3 + [i, p]
            )
            lib.fdb_group_sum_count.restype = i
            lib.fdb_group_min_max.argtypes = (
                [p] * 3 + [ctypes.c_longlong, i] + [p] * 2 + [i, p]
            )
            lib.fdb_group_min_max.restype = i
            _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# Input checks


def _check_planes(named: Sequence[tuple[str, torch.Tensor, torch.dtype]]):
    ref_name, ref, _ = named[0]
    for name, t, dtype in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, {ref_name} on {ref.device}")
        if t.shape != ref.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(ref.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if ref.numel() >= 2**31:
        raise ValueError("planes hold at most 2^31 - 1 rows")
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {ref.device}")


def _check_codes(num_codes: int) -> None:
    if not 1 <= int(num_codes) <= MAX_CODES:
        raise ValueError(f"num_codes must be in [1, {MAX_CODES}], got {num_codes}")


def _check_digits(num_digits: int) -> None:
    if not 1 <= int(num_digits) <= 7:
        raise ValueError(f"num_digits must be in [1, 7], got {num_digits}")


def _check_literal(lit) -> int:
    v = int(lit)
    if not _I32_MIN <= v <= _I32_MAX:
        raise ValueError(f"literal {v} outside int32")
    return v


def _value_mask(num_digits: int) -> int:
    """The bits of an int32 value that ``num_digits`` base-128 digits keep
    (the Pallas digit split reads the value as unsigned 32-bit)."""
    return (1 << min(7 * int(num_digits), 32)) - 1


_CMP = {
    "<": torch.lt,
    "<=": torch.le,
    ">": torch.gt,
    ">=": torch.ge,
    "==": torch.eq,
    "!=": torch.ne,
}


# ---------------------------------------------------------------------------
# Plain versions: the same functions as the wrappers, with the same
# signatures, in plain PyTorch (the CPU path, and what the kernels are held
# against on the card)


def _sum_count(codes, values, sel, num_codes: int, num_digits: int):
    """(sums, counts, first) over rows where the bool ``sel`` holds: the
    values masked to ``num_digits`` digits, rows with codes outside
    ``[0, num_codes)`` dropped."""
    c = codes.reshape(-1)
    s = sel.reshape(-1) & (c >= 0) & (c < num_codes)
    v = (values.reshape(-1).to(torch.int64) & 0xFFFFFFFF) & _value_mask(
        num_digits
    )
    sums, counts = fused.filter_group_scatter(c, v, s, num_codes)
    first = fused.first_selected_row(c, s, num_codes)
    return sums, counts, first


def group_sum_count_plain(codes, values, sel, num_codes, num_digits=2):
    return _sum_count(codes, values, sel != 0, num_codes, num_digits)


def fused_band_group_sum_count_plain(
    codes, values, planes, literals, num_codes, num_digits, cmp_ops
):
    sel = None
    for plane, lit, op in zip(planes, literals, cmp_ops):
        m = _CMP[op](plane, int(lit))
        sel = m if sel is None else sel & m
    return _sum_count(codes, values, sel, num_codes, num_digits)


def fused_cmp_group_sum_count_plain(
    codes, values, ts, base8, literal, num_codes, num_digits, cmp_op
):
    sel = (base8 != 0) & _CMP[cmp_op](ts, int(literal))
    return _sum_count(codes, values, sel, num_codes, num_digits)


def group_min_max_plain(codes, values, sel, num_codes):
    c = codes.reshape(-1)
    s = (sel.reshape(-1) > 0) & (c >= 0) & (c < num_codes)
    return fused.group_min_max_scatter(c, values.reshape(-1), s, num_codes)


# ---------------------------------------------------------------------------
# Wrappers


def _launch_sum_count(
    name, mode, n_cl, codes, values, planes, base8, ops, lits, num_codes,
    num_digits,
):
    """Launch the sum/count kernel into pre-filled outputs and count the
    launch under ``name``. With no rows there is nothing to launch: the
    pre-filled outputs are the result and nothing is counted."""
    n = codes.numel()
    dev = codes.device
    sums = torch.zeros(num_codes, dtype=torch.int64, device=dev)
    counts = torch.zeros(num_codes, dtype=torch.int64, device=dev)
    first = torch.full((num_codes,), _I32_MAX, dtype=torch.int32, device=dev)
    if n == 0:
        return sums, counts, first
    lib = _load()
    ptrs = [p.data_ptr() for p in planes] + [0] * (3 - len(planes))
    ops = list(ops) + [0] * (3 - len(ops))
    lits = list(lits) + [0] * (3 - len(lits))
    with torch.cuda.device(dev):
        num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fdb_group_sum_count(
            mode,
            n_cl,
            codes.data_ptr(),
            values.data_ptr(),
            *ptrs,
            base8.data_ptr() if base8 is not None else 0,
            *ops,
            *lits,
            n,
            num_codes,
            _value_mask(num_digits),
            sums.data_ptr(),
            counts.data_ptr(),
            first.data_ptr(),
            num_sms,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cuda error {err}")
    LAUNCHES[name] += 1
    return sums, counts, first


def _launch_min_max(codes, values, sel, num_codes):
    """Launch the min/max kernel into sentinel-filled outputs and count the
    launch; with no rows nothing is launched or counted."""
    dev = codes.device
    mins = torch.full((num_codes,), _I32_MAX, dtype=torch.int32, device=dev)
    maxs = torch.full((num_codes,), _I32_MIN, dtype=torch.int32, device=dev)
    if codes.numel() == 0:
        return mins, maxs
    lib = _load()
    with torch.cuda.device(dev):
        num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fdb_group_min_max(
            codes.data_ptr(),
            values.data_ptr(),
            sel.data_ptr(),
            codes.numel(),
            num_codes,
            mins.data_ptr(),
            maxs.data_ptr(),
            num_sms,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"group_min_max kernel launch failed: cuda error {err}")
    LAUNCHES["group_min_max"] += 1
    return mins, maxs


def group_sum_count(codes, values, sel, num_codes: int, num_digits: int = 2):
    """Exact (sums[K] int64, counts[K] int64, first[K] int32) over rows
    with ``sel != 0``: ``first`` is the first selected row per code
    (INT32_MAX when absent). codes/values/sel: same-shape contiguous int32 planes; values
    are summed masked to ``num_digits`` base-128 digits."""
    _check_planes(
        [("codes", codes, torch.int32), ("values", values, torch.int32),
         ("sel", sel, torch.int32)]
    )
    _check_codes(num_codes)
    _check_digits(num_digits)
    if codes.device.type == "cpu":
        return group_sum_count_plain(codes, values, sel, num_codes, num_digits)
    return _launch_sum_count(
        "group_sum_count", _MODE_SEL, 1, codes, values, [sel], None, [], [],
        num_codes, num_digits,
    )


def fused_band_group_sum_count(
    codes, values, planes, literals, num_codes: int, num_digits: int,
    cmp_ops: tuple,
):
    """Sums/counts/first over rows where every int32 ``planes[j] <op_j>
    literals[j]`` holds (1-3 clauses; ops <, <=, >, >=, ==), the predicate
    evaluated in the kernel."""
    planes = tuple(planes)
    cmp_ops = tuple(cmp_ops)
    if not 1 <= len(planes) <= 3 or len(planes) != len(cmp_ops):
        raise ValueError("1-3 compare planes, one op each")
    if len(literals) != len(planes):
        raise ValueError("one literal per compare plane")
    for op in cmp_ops:
        if op not in ("<", "<=", ">", ">=", "=="):
            raise ValueError(f"band op {op!r}")
    lits = [_check_literal(l) for l in literals]
    _check_planes(
        [("codes", codes, torch.int32), ("values", values, torch.int32)]
        + [(f"planes[{j}]", p, torch.int32) for j, p in enumerate(planes)]
    )
    _check_codes(num_codes)
    _check_digits(num_digits)
    if codes.device.type == "cpu":
        return fused_band_group_sum_count_plain(
            codes, values, planes, lits, num_codes, num_digits, cmp_ops
        )
    return _launch_sum_count(
        "fused_band_group_sum_count", _MODE_BAND, len(planes), codes, values,
        list(planes), None, [_OPS[o] for o in cmp_ops], lits, num_codes,
        num_digits,
    )


def fused_cmp_group_sum_count(
    codes, values, ts, base8, literal, num_codes: int, num_digits: int,
    cmp_op: str,
):
    """Sums/counts/first over rows where ``base8 != 0`` and ``ts <op>
    literal`` (op in <, <=, >, >=, ==, !=), evaluated in the kernel."""
    if cmp_op not in _OPS:
        raise ValueError(f"compare op {cmp_op!r}")
    lit = _check_literal(literal)
    _check_planes(
        [("codes", codes, torch.int32), ("values", values, torch.int32),
         ("ts", ts, torch.int32), ("base8", base8, torch.int8)]
    )
    _check_codes(num_codes)
    _check_digits(num_digits)
    if codes.device.type == "cpu":
        return fused_cmp_group_sum_count_plain(
            codes, values, ts, base8, lit, num_codes, num_digits, cmp_op
        )
    return _launch_sum_count(
        "fused_cmp_group_sum_count", _MODE_CMP8, 1, codes, values, [ts],
        base8, [_OPS[cmp_op]], [lit], num_codes, num_digits,
    )


def group_min_max(codes, values, sel, num_codes: int):
    """Exact (mins[K] int32, maxs[K] int32) over rows with ``sel > 0``;
    INT32_MAX / INT32_MIN for codes with no selected row."""
    _check_planes(
        [("codes", codes, torch.int32), ("values", values, torch.int32),
         ("sel", sel, torch.int32)]
    )
    _check_codes(num_codes)
    if codes.device.type == "cpu":
        return group_min_max_plain(codes, values, sel, num_codes)
    return _launch_min_max(codes, values, sel, num_codes)
