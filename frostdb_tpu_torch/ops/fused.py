"""Scatter formulations of the fused filter + group-aggregate — the plain
PyTorch versions that the hand-written kernels of ``ops/agg_kernels.py``
are held against (and that run for tensors on the CPU).

Contract (the compiled layer's, ``compiled.py``): ``codes`` are dense group
codes in ``[0, num_codes)`` for every selected row, ``sel`` is a bool
selection, ``values`` are int32. Results are exact int64 sums and counts,
the exact first selected row per code, and int32 min/max; codes with no
selected row hold INT32_MAX as first row and INT32_MAX/INT32_MIN as
min/max.
"""

from __future__ import annotations

import torch

_I32_MAX = 2**31 - 1
_I32_MIN = -(2**31)


def _safe_codes(codes, sel, num_codes: int):
    """Selected rows keep their code; the rest route to the spill slot
    ``num_codes``, sliced off after the scatter."""
    return torch.where(sel, codes, num_codes).long()


def first_selected_row(codes, sel, num_codes: int):
    """Exact first selected row index per code — the first-occurrence group
    emission order. Codes with no selected row hold INT32_MAX (the
    segment-min identity, as the XLA original gives)."""
    n = codes.shape[0]
    rowidx = torch.arange(n, dtype=torch.int32, device=codes.device)
    out = torch.full(
        (num_codes + 1,), _I32_MAX, dtype=torch.int32, device=codes.device
    )
    out.scatter_reduce_(
        0,
        _safe_codes(codes, sel, num_codes),
        torch.where(sel, rowidx, n),
        reduce="amin",
    )
    return out[:num_codes]


def group_min_max_scatter(codes, values, sel, num_codes: int):
    """Grouped min/max over selected rows via scatter reductions (the plain
    version of the min/max kernel; same int32 sentinel contract)."""
    safe = _safe_codes(codes, sel, num_codes)
    dev = codes.device
    mins = torch.full((num_codes + 1,), _I32_MAX, dtype=torch.int32, device=dev)
    maxs = torch.full((num_codes + 1,), _I32_MIN, dtype=torch.int32, device=dev)
    mins.scatter_reduce_(0, safe, torch.where(sel, values, _I32_MAX), "amin")
    maxs.scatter_reduce_(0, safe, torch.where(sel, values, _I32_MIN), "amax")
    return mins[:num_codes], maxs[:num_codes]


def filter_group_scatter(codes, values, sel, num_codes: int):
    """Scatter-add formulation: exact int64 (sums, counts) per code over the
    selected rows."""
    safe = _safe_codes(codes, sel, num_codes)
    dev = codes.device
    sums = torch.zeros(num_codes + 1, dtype=torch.int64, device=dev)
    counts = torch.zeros(num_codes + 1, dtype=torch.int64, device=dev)
    sums.scatter_add_(0, safe, torch.where(sel, values.to(torch.int64), 0))
    counts.scatter_add_(0, safe, sel.to(torch.int64))
    return sums[:num_codes], counts[:num_codes]
