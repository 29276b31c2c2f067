"""Exact float64 group sums (VERDICT r3 item 5).

The reference accumulates float64 sums sequentially (aggregate.go:778), so
its result depends on row order; device reductions add in their own
(on the GPU, atomic and unordered) order, so a lane split or a device/host
boundary would change low-order bits. This package defines
``sum(float64)`` as the
CORRECTLY-ROUNDED EXACT sum: every finite double is an integer multiple of
2^S (S = the smallest ulp exponent over the column), so the whole column
decomposes into base-2^28 integer digit planes that sum exactly in int64;
the planes recombine into an arbitrary-precision integer on the host and
round to float64 ONCE. The result is identical on every path (generic /
compiled / dense / mesh), every lane count, and every device — and at
least as accurate as any accumulation order.

Decomposition (all steps are exact f64 ops — power-of-two scaling, floor,
and differences < 2^28 of nearby integers):

    u   = v * 2^-S                    (exact: same mantissa, shifted)
    q1  = floor(u  * 2^-28); d0 = u  - q1 * 2^28   in [0, 2^28)
    q2  = floor(q1 * 2^-28); d1 = q1 - q2 * 2^28   in [0, 2^28)
    q3  = floor(q2 * 2^-28); d2 = q2 - q3 * 2^28   in [0, 2^28)
    top = q3                           (signed; |top| < 2^(bits-84))

    sum = ldexp(float(S0 + (S1<<28) + (S2<<56) + (S3<<84)), S)

Gate (checked identically from numpy values on the generic path and from
cached part metadata on the compiled/mesh paths): all slots finite, no
subnormals, and the fixed-point width fits the four planes with int64
summation headroom. Outside the gate the IEEE reduction applies and only
the generic engine serves (the fast paths decline).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

_D = 28  # digit width
_MASK = (1 << _D) - 1
# fixed-point width admitted: 3 digit planes + a signed top plane that
# keeps |top| <= 2^20 so int64 plane sums have >= 2^43 rows of headroom.
_MAX_BITS = 3 * _D + 20


class FloatSumPlan:
    """S (ulp exponent) + top-plane bounds for one column over one row set."""

    __slots__ = ("scale", "top_min", "top_max")

    def __init__(self, scale: int, top_min: int, top_max: int):
        self.scale = scale
        self.top_min = top_min
        self.top_max = top_max


def column_meta(values: np.ndarray):
    """(finite_and_normal, min_ulp_exp, vmin, vmax) over raw slots —
    the per-part cached metadata (zeros are exact at any scale and carry
    no ulp constraint; subnormals would need S < -1074 scaling that
    overflows the u plane, so they fail the gate)."""
    v = np.asarray(values, dtype=np.float64)
    if len(v) == 0:
        return True, None, None, None
    if not np.isfinite(v).all():
        return False, None, None, None
    bits = v.view(np.int64)
    expo = (bits >> 52) & 0x7FF
    nz = v != 0.0
    if bool((expo[nz] == 0).any()):
        return False, None, None, None  # subnormal
    if not nz.any():
        return True, None, float(v.min()), float(v.max())
    s = int(expo[nz].min()) - 1075
    return True, s, float(v.min()), float(v.max())


def make_plan(
    metas, n_rows: int
) -> Optional[FloatSumPlan]:
    """Combine per-part/per-batch ``column_meta`` tuples into a plan, or
    None when the gate fails (non-finite/subnormal values, fixed-point
    width past the planes, or too many rows for int64 headroom)."""
    s = None
    vmin = vmax = None
    for ok, s_p, lo, hi in metas:
        if not ok:
            return None
        if s_p is not None:
            s = s_p if s is None else min(s, s_p)
        if lo is not None:
            vmin = lo if vmin is None else min(vmin, lo)
            vmax = hi if vmax is None else max(vmax, hi)
    if s is None:
        # all zeros: any scale works
        return FloatSumPlan(0, 0, 0)
    amax = max(abs(vmin), abs(vmax))
    # bits needed for |u| = |v| * 2^-s
    bits = max(int(math.frexp(amax)[1]) - s, 1)
    if bits > _MAX_BITS:
        return None
    if n_rows >= 1 << 43:
        return None
    top_min = math.floor(math.ldexp(vmin, -s) / float(1 << (3 * _D)))
    top_max = math.floor(math.ldexp(vmax, -s) / float(1 << (3 * _D)))
    return FloatSumPlan(s, int(top_min), int(top_max))


def decompose_np(values: np.ndarray, plan: FloatSumPlan):
    """numpy plane decomposition: 3 digit planes in [0, 2^28) + the signed
    top plane, all int64."""
    u = np.ldexp(np.asarray(values, dtype=np.float64), -plan.scale)
    inv = math.ldexp(1.0, -_D)
    w = float(1 << _D)
    q1 = np.floor(u * inv)
    d0 = u - q1 * w
    q2 = np.floor(q1 * inv)
    d1 = q1 - q2 * w
    q3 = np.floor(q2 * inv)
    d2 = q2 - q3 * w
    return [
        d0.astype(np.int64),
        d1.astype(np.int64),
        d2.astype(np.int64),
        q3.astype(np.int64),
    ]


def decompose_dev(vdata, plan: FloatSumPlan):
    """The same decomposition as torch ops on a float64 tensor (float64 is
    exact on both the CPU and the GPU)."""
    import torch

    u = vdata * math.ldexp(1.0, -plan.scale)
    inv = math.ldexp(1.0, -_D)
    w = float(1 << _D)
    q1 = torch.floor(u * inv)
    d0 = u - q1 * w
    q2 = torch.floor(q1 * inv)
    d1 = q1 - q2 * w
    q3 = torch.floor(q2 * inv)
    d2 = q2 - q3 * w
    return [
        d0.to(torch.int64),
        d1.to(torch.int64),
        d2.to(torch.int64),
        q3.to(torch.int64),
    ]


def recombine(
    plane_sums, plan: FloatSumPlan, top_bias: int = 0, counts=None
) -> np.ndarray:
    """[K]-shaped int64 plane sums -> exact float64 group sums (one
    rounding, via arbitrary-precision integers). ``top_bias``/``counts``
    undo a kernel-side top-plane bias shift (the digit kernels take
    non-negative values): true_top = s3 + top_bias * count."""
    s0, s1, s2, s3 = [np.asarray(p) for p in plane_sums]
    out = np.empty(len(s0), dtype=np.float64)
    for i in range(len(s0)):
        top = int(s3[i])
        if counts is not None:
            top += int(top_bias) * int(counts[i])
        exact = (
            int(s0[i])
            + (int(s1[i]) << _D)
            + (int(s2[i]) << (2 * _D))
            + (top << (3 * _D))
        )
        out[i] = math.ldexp(float(exact), plan.scale)
    return out
