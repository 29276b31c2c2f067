"""Hand-written CUDA kernels of the compiled serving paths, with their
wrappers, plain PyTorch versions and launch counters.

The counterpart of ``frostdb_tpu/ops/pallas_agg.py``. Sources:
``csrc/agg.cu`` (the aggregation kernels), ``csrc/compact.cu`` (block
compaction) and ``csrc/dense.cu`` (the dense tier's segment reduction),
each built for ``sm_90a`` with its own ``nvcc`` (all started
together) into a shared library with a plain C interface at first use
(under the checkout's ``build/kernels/``, keyed by a hash of the source and
flags), and loaded with ``ctypes``. Importing this module builds and loads
nothing.

| wrapper                       | replaces (pallas_agg.py)               |
| ----------------------------- | -------------------------------------- |
| ``group_sum_count``           | ``pallas_group_sum_count``             |
| ``fused_band_group_sum_count``| ``pallas_fused_band_group_sum_count``  |
| ``fused_cmp_group_sum_count`` | ``pallas_fused_cmp_group_sum_count``   |
| ``group_min_max``             | ``pallas_group_min_max``               |
| ``filter_group_sum_count``    | ``pallas_filter_group_sum_count``      |
| ``block_compact``             | ``pallas_block_compact``               |
| ``dense_segment_sum_count``   | none (XLA's ``segment_sum``)           |

Bound on the card: memory bandwidth. The sum/count kernels read one
predicate plane per clause (4 B/row, plus 1 B/row for the int8 base plane)
and the code and value of each selected row (no value with ``values=None``,
the count-only pass); min/max reads the selection (4 B/row) and the code
and value of each selected row; block compaction reads the selection (4
B/row) and writes ``n_blocks x (1 + capb)`` int32; the dense segment
reduction reads the code, the selection byte and the int64 value of each
live row (13 B/row). Their arithmetic is a
handful of integer ops per row, far below the card's rate, so the bound is
bytes / 3.35 TB/s. The sum/count and min/max kernels are one template:
each plane is read once in 16-byte vectors, the predicate evaluated in
registers (no selection plane is written), runs of equal codes kept in
registers and written out with 32-bit shared atomics into per-code tables
in shared memory; only [K]-sized partials reach device memory. See
``csrc/agg.cu`` and PERF.md.

Contract differences from the Pallas entries: the third result of the
sum/count kernels is the EXACT first selected row per code (INT32_MAX when
absent), not the first 8192-row superblock; inputs are any same-shape
contiguous int32 planes (the compiled layer's ``[slabs, 128]`` layout reads
as flat rows). ``block_compact`` takes a flat plane whose last 8192-row
block may be partial, and fills the slots past a block's count with -1 (the
Pallas kernel leaves them undefined).

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
import types
from typing import Optional, Sequence

import torch

from . import fused
from . import kernels as K

MAX_CODES = 2048
# The dense segment reduction's code limit (the segment route's,
# parallel/mesh_exec._SORTED_THRESHOLD).
DENSE_MAX_CODES = 4096
_I64_MAX = 2**63 - 1
_I32_MIN = -(2**31)
_I32_MAX = 2**31 - 1

# Launches of each kernel (counted only where the kernel is launched; the
# plain versions do not count), and of each sum/count template variant
# under "name[variant]" (the band's clause count, the compare's op).
# Queries on several threads launch at once, so both count under one lock
# (count_launch).
LAUNCHES: dict[str, int] = {
    "group_sum_count": 0,
    "fused_band_group_sum_count": 0,
    "fused_cmp_group_sum_count": 0,
    "group_min_max": 0,
    "filter_group_sum_count": 0,
    "block_compact": 0,
    "dense_segment_sum_count": 0,
}
TEMPLATE_LAUNCHES: dict[str, int] = {}
_launch_lock = threading.Lock()

# Rows per block of block_compact (pallas_agg.ROWS_PER_SUPER).
BLOCK_ROWS = 8192


def count_launch(name: str, variant: Optional[str] = None) -> None:
    """Count one launch of kernel ``name`` (and of ``name[variant]``)."""
    with _launch_lock:
        LAUNCHES[name] += 1
        if variant is not None:
            key = f"{name}[{variant}]"
            TEMPLATE_LAUNCHES[key] = TEMPLATE_LAUNCHES.get(key, 0) + 1


def reset_launches() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        TEMPLATE_LAUNCHES.clear()


_OPS = {"<": 0, "<=": 1, ">": 2, ">=": 3, "==": 4, "!=": 5}
_MODE_SEL, _MODE_BAND, _MODE_CMP8 = 0, 1, 2

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# library name -> CUDA source
SOURCES = {
    "agg": os.path.join(_PKG, "csrc", "agg.cu"),
    "compact": os.path.join(_PKG, "csrc", "compact.cu"),
    "dense": os.path.join(_PKG, "csrc", "dense.cu"),
}
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

_lib: Optional[types.SimpleNamespace] = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _so_path(name: str, source: str) -> str:
    with open(source, "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build() -> dict[str, str]:
    """Compile every source of ``SOURCES`` not built yet (once per source
    and flag set), one ``nvcc`` per source, all started together, and
    return each shared library's path by name. Raises with the compiler's
    output on failure. ``-Xptxas -v``'s report is kept beside each
    library."""
    paths = {name: _so_path(name, src) for name, src in SOURCES.items()}
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, so_path in todo.items():
        tmp = f"{so_path}.{os.getpid()}.tmp"
        procs[name] = (
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, SOURCES[name]],
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
            ),
            tmp,
        )
    failed = []
    for name, (proc, tmp) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {SOURCES[name]} failed ({proc.returncode}):\n{out}\n{err}")
            continue
        so_path = todo[name]
        with open(so_path[:-3] + ".ptxas.txt", "w") as f:
            f.write(out + err)
        os.replace(tmp, so_path)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def _load() -> types.SimpleNamespace:
    """The C entries of every kernel library, built at first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            paths = build()
            agg = ctypes.CDLL(paths["agg"])
            compact = ctypes.CDLL(paths["compact"])
            dense = ctypes.CDLL(paths["dense"])
            p, i = ctypes.c_void_p, ctypes.c_int
            ll, u = ctypes.c_longlong, ctypes.c_uint
            agg.fdb_group_sum_count.argtypes = (
                [i, i] + [p] * 6 + [i] * 6 + [ll, i, u] + [p] * 3 + [i, p]
            )
            agg.fdb_group_sum_count.restype = i
            agg.fdb_group_min_max.argtypes = [p] * 3 + [ll, i] + [p] * 2 + [i, p]
            agg.fdb_group_min_max.restype = i
            agg.fdb_filter_group_sum_count.argtypes = (
                [p] * 3 + [i, ll, i, u] + [p] * 2 + [i, p]
            )
            agg.fdb_filter_group_sum_count.restype = i
            compact.fdb_block_compact.argtypes = [p, ll, i, p, p, p]
            compact.fdb_block_compact.restype = i
            dense.fdb_dense_segment_sum_count.argtypes = (
                [p] * 3 + [ll, ll, i] + [p] * 3 + [i, p]
            )
            dense.fdb_dense_segment_sum_count.restype = i
            _lib = types.SimpleNamespace(
                fdb_group_sum_count=agg.fdb_group_sum_count,
                fdb_group_min_max=agg.fdb_group_min_max,
                fdb_filter_group_sum_count=agg.fdb_filter_group_sum_count,
                fdb_block_compact=compact.fdb_block_compact,
                fdb_dense_segment_sum_count=dense.fdb_dense_segment_sum_count,
            )
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


def _value_plane(values) -> list:
    """The value plane's entry for ``_check_planes``; none for the
    count-only pass (``values=None``)."""
    return [] if values is None else [("values", values, torch.int32)]


def _check_codes(num_codes: int) -> None:
    if not 1 <= int(num_codes) <= MAX_CODES:
        raise ValueError(f"num_codes must be in [1, {MAX_CODES}], got {num_codes}")


def _check_dense_codes(num_codes: int) -> None:
    if not 1 <= int(num_codes) <= DENSE_MAX_CODES:
        raise ValueError(
            f"num_codes must be in [1, {DENSE_MAX_CODES}], got {num_codes}"
        )


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
    ``[0, num_codes)`` dropped. With ``values=None`` the sums are 0."""
    c = codes.reshape(-1)
    s = sel.reshape(-1) & (c >= 0) & (c < num_codes)
    if values is None:
        v = torch.zeros_like(c, dtype=torch.int64)
    else:
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


def filter_group_sum_count_plain(
    codes, values, ts, literal, num_codes, num_digits=2
):
    sums, counts, _first = _sum_count(
        codes, values, ts >= int(literal), num_codes, num_digits
    )
    return sums, counts


def block_compact_plain(sel, capb):
    """Per 8192-row block: the selected count, and the first ``capb``
    selected offsets by a per-block ``cumsum`` rank and a scatter (-1 past
    the count)."""
    flat = sel.reshape(-1) != 0
    n = flat.numel()
    n_blocks = -(-n // BLOCK_ROWS)
    m = torch.zeros(n_blocks * BLOCK_ROWS, dtype=torch.int32, device=sel.device)
    m[:n] = flat.to(torch.int32)
    m = m.reshape(n_blocks, BLOCK_ROWS)
    bc = m.sum(dim=1, dtype=torch.int32)
    rank = torch.cumsum(m, dim=1, dtype=torch.int64) - 1
    keep = (m != 0) & (rank < capb)
    blk = torch.arange(n_blocks, device=sel.device).unsqueeze(1)
    off = torch.arange(BLOCK_ROWS, dtype=torch.int32, device=sel.device)
    idx = torch.full((n_blocks * capb,), -1, dtype=torch.int32, device=sel.device)
    idx[(blk * capb + rank)[keep]] = off.expand(n_blocks, -1)[keep]
    return bc, idx.reshape(n_blocks, capb)


def dense_segment_sum_count_plain(codes, sel, values, n, row_base, num_codes):
    """The dense tier's segment reduction as it was before its kernel: a
    ``kernels.dense_group_reduce`` each for the count, the first selected
    row (``row_base`` + its index) and the sum, over the first ``n`` rows."""
    local = torch.arange(codes.shape[0], device=codes.device)
    s = sel & (local < int(n))
    counts = K.dense_group_reduce(codes, None, s, num_codes, K.AGG_COUNT)
    first = K.dense_group_reduce(codes, local + int(row_base), s, num_codes, K.AGG_MIN)
    if values is None:
        sums = torch.zeros(num_codes, dtype=torch.int64, device=codes.device)
    else:
        sums = K.dense_group_reduce(codes, values, s, num_codes, K.AGG_SUM)
    return counts, first, sums


# ---------------------------------------------------------------------------
# Wrappers


def _launch_sum_count(
    name, mode, n_cl, codes, values, planes, base8, ops, lits, num_codes,
    num_digits, variant=None,
):
    """Launch the sum/count kernel into pre-filled outputs and count the
    launch under ``name`` (and ``variant``). With no rows there is nothing
    to launch: the pre-filled outputs are the result and nothing is
    counted."""
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
            values.data_ptr() if values is not None else 0,
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
    count_launch(name, variant)
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
    count_launch("group_min_max")
    return mins, maxs


def group_sum_count(codes, values, sel, num_codes: int, num_digits: int = 2):
    """Exact (sums[K] int64, counts[K] int64, first[K] int32) over rows
    with ``sel != 0``: ``first`` is the first selected row per code
    (INT32_MAX when absent). codes/values/sel: same-shape contiguous int32 planes; values
    are summed masked to ``num_digits`` base-128 digits. ``values=None``
    counts only: no value plane is read and the sums are 0."""
    _check_planes(
        [("codes", codes, torch.int32), ("sel", sel, torch.int32)]
        + _value_plane(values)
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
    evaluated in the kernel; ``values=None`` counts only."""
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
        [("codes", codes, torch.int32)]
        + _value_plane(values)
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
        num_digits, variant=str(len(planes)),
    )


def fused_cmp_group_sum_count(
    codes, values, ts, base8, literal, num_codes: int, num_digits: int,
    cmp_op: str,
):
    """Sums/counts/first over rows where ``base8 != 0`` and ``ts <op>
    literal`` (op in <, <=, >, >=, ==, !=), evaluated in the kernel;
    ``values=None`` counts only."""
    if cmp_op not in _OPS:
        raise ValueError(f"compare op {cmp_op!r}")
    lit = _check_literal(literal)
    _check_planes(
        [("codes", codes, torch.int32), ("ts", ts, torch.int32),
         ("base8", base8, torch.int8)]
        + _value_plane(values)
    )
    _check_codes(num_codes)
    _check_digits(num_digits)
    if codes.device.type == "cpu":
        return fused_cmp_group_sum_count_plain(
            codes, values, ts, base8, lit, num_codes, num_digits, cmp_op
        )
    return _launch_sum_count(
        "fused_cmp_group_sum_count", _MODE_CMP8, 1, codes, values, [ts],
        base8, [_OPS[cmp_op]], [lit], num_codes, num_digits, variant=cmp_op,
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


def filter_group_sum_count(
    codes, values, ts, literal, num_codes: int, num_digits: int = 2
):
    """Exact (sums[K] int64, counts[K] int64) over rows with ``ts >=
    literal``, the compare evaluated in the kernel; codes/values/ts are
    same-shape contiguous int32 planes, values summed masked to
    ``num_digits`` base-128 digits (K5's bench entry)."""
    lit = _check_literal(literal)
    _check_planes(
        [("codes", codes, torch.int32), ("values", values, torch.int32),
         ("ts", ts, torch.int32)]
    )
    _check_codes(num_codes)
    _check_digits(num_digits)
    if codes.device.type == "cpu":
        return filter_group_sum_count_plain(
            codes, values, ts, lit, num_codes, num_digits
        )
    dev = codes.device
    sums = torch.zeros(num_codes, dtype=torch.int64, device=dev)
    counts = torch.zeros(num_codes, dtype=torch.int64, device=dev)
    if codes.numel() == 0:
        return sums, counts
    lib = _load()
    with torch.cuda.device(dev):
        num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
        err = lib.fdb_filter_group_sum_count(
            codes.data_ptr(), values.data_ptr(), ts.data_ptr(), lit,
            codes.numel(), num_codes, _value_mask(num_digits),
            sums.data_ptr(), counts.data_ptr(), num_sms,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"filter_group_sum_count kernel launch failed: cuda error {err}"
        )
    count_launch("filter_group_sum_count")
    return sums, counts


def block_compact(sel, capb: int):
    """(bc int32[n_blocks], idx int32[n_blocks, capb]) over 8192-row
    blocks of the 0/1 int32 plane ``sel`` (any contiguous shape, read as
    flat rows; the last block may be partial): ``bc[b]`` is block b's
    selected count and ``idx[b]`` its first ``capb`` selected block-local
    offsets in ascending order, -1 past ``bc[b]``."""
    _check_planes([("sel", sel, torch.int32)])
    capb = int(capb)
    if not 1 <= capb <= BLOCK_ROWS:
        raise ValueError(f"capb must be in [1, {BLOCK_ROWS}], got {capb}")
    if sel.device.type == "cpu":
        return block_compact_plain(sel, capb)
    n = sel.numel()
    n_blocks = -(-n // BLOCK_ROWS)
    dev = sel.device
    bc = torch.empty(n_blocks, dtype=torch.int32, device=dev)
    idx = torch.empty((n_blocks, capb), dtype=torch.int32, device=dev)
    if n == 0:
        return bc, idx
    lib = _load()
    with torch.cuda.device(dev):
        err = lib.fdb_block_compact(
            sel.data_ptr(), n, capb, bc.data_ptr(), idx.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"block_compact kernel launch failed: cuda error {err}")
    count_launch("block_compact")
    return bc, idx


def dense_segment_sum_count(codes, sel, values, n: int, row_base: int, num_codes: int):
    """Exact (counts[K], first[K], sums[K]) int64 over the first ``n`` rows
    where the bool ``sel`` holds: ``first`` is ``row_base`` plus the first
    selected row per code (INT64_MAX when absent), ``sums`` the int64
    ``values`` added modulo 2^64. codes: int32; sel: bool; values: int64
    or None (counts only, the sums are 0); one contiguous flat shape. Rows
    at or past ``n`` are not read; selected codes lie in [0, num_codes),
    num_codes <= 4,096."""
    _check_planes(
        [("codes", codes, torch.int32), ("sel", sel, torch.bool)]
        + ([] if values is None else [("values", values, torch.int64)])
    )
    if codes.dim() != 1:
        raise ValueError("dense_segment_sum_count takes flat planes")
    _check_dense_codes(num_codes)
    n = int(n)
    if not 0 <= n <= codes.numel():
        raise ValueError(f"n must be in [0, {codes.numel()}], got {n}")
    if codes.device.type == "cpu":
        return dense_segment_sum_count_plain(codes, sel, values, n, row_base, num_codes)
    dev = codes.device
    counts = torch.zeros(num_codes, dtype=torch.int64, device=dev)
    first = torch.full((num_codes,), _I64_MAX, dtype=torch.int64, device=dev)
    sums = torch.zeros(num_codes, dtype=torch.int64, device=dev)
    if n == 0:
        return counts, first, sums
    lib = _load()
    with torch.cuda.device(dev):
        num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
        err = lib.fdb_dense_segment_sum_count(
            codes.data_ptr(), sel.data_ptr(),
            values.data_ptr() if values is not None else 0,
            n, int(row_base), num_codes,
            counts.data_ptr(), first.data_ptr(), sums.data_ptr(), num_sms,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"dense_segment_sum_count kernel launch failed: cuda error {err}"
        )
    count_launch("dense_segment_sum_count")
    return counts, first, sums
