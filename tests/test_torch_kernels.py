"""The plain versions of the port's aggregation kernels
(frostdb_tpu_torch/ops/agg_kernels.py) against the JAX package's Pallas
kernels (run in interpret mode) and their XLA twins (ops/fused.py), on the
same inputs made from a seed. Tolerance: none — every result is integer and
must be equal.

The port's third result is the exact first selected row per code; the
Pallas kernels return the first 8192-row superblock, so that is compared as
``row // 8192`` wherever the count is positive, and exactly against the
XLA ``first_selected_row``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frostdb_tpu.ops import fused as JF
from frostdb_tpu.ops import pallas_agg as PA
from frostdb_tpu_torch.ops import agg_kernels as AK

ROWS_PER_SUPER = PA.ROWS_PER_SUPER
I32_MIN, I32_MAX = -(2**31), 2**31 - 1


@pytest.fixture
def interpret(monkeypatch):
    """Pallas kernels in interpret mode (they target the TPU)."""
    monkeypatch.setattr(
        PA.pl, "pallas_call", functools.partial(PA.pl.pallas_call, interpret=True)
    )


def _planes(seed, n_super, num_codes, vmax, sel_p=0.5, live_rows=None):
    """codes, values, ts, sel, base8 as numpy [slabs, 128] planes; rows at
    and past ``live_rows`` are unselected (a partial last block)."""
    rng = np.random.default_rng(seed)
    n = n_super * ROWS_PER_SUPER
    codes = rng.integers(0, num_codes, n).astype(np.int32)
    values = rng.integers(0, vmax, n, dtype=np.int64).astype(np.int32)
    ts = rng.integers(0, 100, n).astype(np.int32)
    sel = (rng.random(n) < sel_p).astype(np.int32)
    base8 = (rng.random(n) < 0.8).astype(np.int8)
    if live_rows is not None:
        sel[live_rows:] = 0
        base8[live_rows:] = 0
    return [a.reshape(-1, 128) for a in (codes, values, ts, sel, base8)]


def _check_sum_count(port, pallas, first_exact=None):
    ps, pc, pf = (t.numpy() for t in port)
    js, jc, jsup = (np.asarray(a) for a in pallas)
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pc, jc)
    live = pc > 0
    np.testing.assert_array_equal(pf[live] // ROWS_PER_SUPER, jsup[live])
    if first_exact is not None:
        np.testing.assert_array_equal(pf, np.asarray(first_exact))


# ---------------------------------------------------------------------------
# K2: group_sum_count vs pallas_group_sum_count


@pytest.mark.parametrize(
    "num_codes,n_super,num_digits,vmax,sel_p,live",
    [
        (1, 1, 2, 1 << 14, 0.5, None),
        (127, 2, 2, 1 << 14, 0.5, None),
        (128, 1, 3, 1 << 21, 0.5, 5000),  # partial last block
        (129, 2, 1, 128, 0.3, None),
        (256, 1, 2, 1 << 14, 0.0, None),  # every row filtered out
        (64, 2, 5, 2**31 - 1, 0.9, None),  # values near 2^31
    ],
)
def test_group_sum_count_vs_pallas(
    interpret, num_codes, n_super, num_digits, vmax, sel_p, live
):
    c, v, _ts, s, _b = _planes(1, n_super, num_codes, vmax, sel_p, live)
    port = AK.group_sum_count(
        torch.from_numpy(c), torch.from_numpy(v), torch.from_numpy(s),
        num_codes, num_digits,
    )
    pallas = PA.pallas_group_sum_count(
        jnp.asarray(c), jnp.asarray(v), jnp.asarray(s), num_codes, num_digits
    )
    first = JF.first_selected_row(
        jnp.asarray(c.reshape(-1)), jnp.asarray(s.reshape(-1) > 0), num_codes
    )
    _check_sum_count(port, pallas, first)


@pytest.mark.divergence
def test_first_row_is_exact_where_pallas_gives_the_superblock(interpret):
    """Expected divergence (ROADMAP.md Queue 3): the port's third result is
    each code's exact first selected row (INT32_MAX when absent), where the
    Pallas kernel gives the first 8192-row superblock. Sparse selection, so
    some codes first appear in the second superblock."""
    c, v, _ts, s, _b = _planes(12, 2, 64, 1 << 14, sel_p=0.02)
    _sums, counts, first = (
        t.numpy()
        for t in AK.group_sum_count(
            torch.from_numpy(c), torch.from_numpy(v), torch.from_numpy(s), 64, 2
        )
    )
    jsup = np.asarray(
        PA.pallas_group_sum_count(
            jnp.asarray(c), jnp.asarray(v), jnp.asarray(s), 64, 2
        )[2]
    )
    live = counts > 0
    flat_c, flat_s = c.reshape(-1), s.reshape(-1) > 0
    exact = [np.flatnonzero(flat_s & (flat_c == k))[0] for k in np.flatnonzero(live)]
    np.testing.assert_array_equal(first[live], exact)
    np.testing.assert_array_equal(first[~live], I32_MAX)
    assert (first[live] != jsup[live]).any()
    assert (jsup[live] == 1).any()
    np.testing.assert_array_equal(first[live] // ROWS_PER_SUPER, jsup[live])


def test_group_sum_count_masks_like_pallas(interpret):
    """Values past ``num_digits`` base-128 digits (outside the contract)
    keep exactly the bits the Pallas digit split keeps."""
    c, v, _ts, s, _b = _planes(2, 1, 64, 2**31 - 1)
    port = AK.group_sum_count(
        torch.from_numpy(c), torch.from_numpy(v), torch.from_numpy(s), 64, 2
    )
    pallas = PA.pallas_group_sum_count(
        jnp.asarray(c), jnp.asarray(v), jnp.asarray(s), 64, 2
    )
    _check_sum_count(port, pallas)


# ---------------------------------------------------------------------------
# K1: fused_band_group_sum_count vs pallas_fused_band_group_sum_count


@pytest.mark.parametrize(
    "ops,lits,num_codes",
    [
        ((">=",), (50,), 64),
        (("<",), (I32_MAX,), 129),
        ((">", "<="), (20, 80), 128),
        ((">=", "<", "=="), (10, 90, 3), 127),  # "==" compares dict codes
    ],
)
def test_band_vs_pallas(interpret, ops, lits, num_codes):
    c, v, ts, _s, _b = _planes(3, 2, num_codes, 1 << 14)
    rng = np.random.default_rng(4)
    # sentinel-masked invalid rows, as the compiled layer builds them
    invalid = rng.random(ts.shape) < 0.1
    planes = []
    for op in ops:
        if op == "==":
            p = np.where(invalid, I32_MIN, c % 5).astype(np.int32)
        else:
            sent = I32_MIN if op in (">", ">=") else I32_MAX
            p = np.where(invalid, sent, ts).astype(np.int32)
        planes.append(p)
    port = AK.fused_band_group_sum_count(
        torch.from_numpy(c), torch.from_numpy(v),
        tuple(torch.from_numpy(p) for p in planes), lits, num_codes, 2, ops,
    )
    pallas = PA.pallas_fused_band_group_sum_count(
        jnp.asarray(c), jnp.asarray(v), tuple(jnp.asarray(p) for p in planes),
        tuple(jnp.asarray(l, jnp.int32) for l in lits), num_codes, 2, ops,
    )
    _check_sum_count(port, pallas)


# ---------------------------------------------------------------------------
# K1 and K2 on the code layouts the CUDA template is designed for: sorted
# runs (compacted parts are sorted by label), few codes, out-of-range codes
# inside runs, a partial last block

# Run lengths that cross the kernel's 4-row vectors, 32-lane warps and
# 512-row block steps.
_RUNS = (1, 3, 4, 5, 31, 32, 33, 511, 512, 513, 4099)
_LAYOUTS = {
    # layout: (num_codes, live rows of the 2 superblocks or None)
    "uniform": (64, None),
    "sorted_runs": (64, None),
    "one_code": (64, None),
    "two_random_codes": (2, None),
    "out_of_range_in_runs": (64, None),
    "partial_last_block": (64, 2 * ROWS_PER_SUPER - 3001),
}


def _layout_planes(layout, seed=21):
    """codes, values, ts, sel as [slabs, 128] int32 planes of 2 superblocks
    with codes in ``layout``; sel and ts past the live rows are unselected
    (sel 0, ts -1)."""
    num_codes, live = _LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    n = 2 * ROWS_PER_SUPER
    if layout in ("uniform", "two_random_codes"):
        codes = rng.integers(0, num_codes, n)
    elif layout == "one_code":
        codes = np.full(n, num_codes - 1)
    else:
        lengths = np.resize(np.array(_RUNS), n)
        lengths = lengths[: np.searchsorted(np.cumsum(lengths), n) + 1]
        codes = np.repeat(rng.integers(0, num_codes, len(lengths)), lengths)[:n]
        if layout == "out_of_range_in_runs":
            bad = rng.random(n) < 0.05
            junk = np.array([-1, num_codes, num_codes + 1000, I32_MIN])
            codes = np.where(bad, junk[rng.integers(0, 4, n)], codes)
    codes = codes.astype(np.int32)
    values = rng.integers(0, 1 << 21, n).astype(np.int32)
    ts = rng.integers(0, 100, n).astype(np.int32)
    sel = (rng.random(n) < 0.6).astype(np.int32)
    if live is not None:
        sel[live:] = 0
        ts[live:] = -1
    return [a.reshape(-1, 128) for a in (codes, values, ts, sel)], num_codes


def _first_exact(codes, sel, num_codes):
    c = codes.reshape(-1)
    s = (sel.reshape(-1) > 0) & (c >= 0) & (c < num_codes)
    return JF.first_selected_row(jnp.asarray(c), jnp.asarray(s), num_codes)


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
def test_group_sum_count_layouts_vs_pallas(interpret, layout):
    (c, v, _ts, s), k = _layout_planes(layout)
    port = AK.group_sum_count(
        torch.from_numpy(c), torch.from_numpy(v), torch.from_numpy(s), k, 3
    )
    pallas = PA.pallas_group_sum_count(
        jnp.asarray(c), jnp.asarray(v), jnp.asarray(s), k, 3
    )
    _check_sum_count(port, pallas, _first_exact(c, s, k))


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
def test_band_layouts_vs_pallas(interpret, layout):
    (c, v, ts, _s), k = _layout_planes(layout)
    ops, lits = (">=", "<"), (20, 90)
    port = AK.fused_band_group_sum_count(
        torch.from_numpy(c), torch.from_numpy(v),
        (torch.from_numpy(ts), torch.from_numpy(ts)), lits, k, 3, ops,
    )
    pallas = PA.pallas_fused_band_group_sum_count(
        jnp.asarray(c), jnp.asarray(v), (jnp.asarray(ts), jnp.asarray(ts)),
        tuple(jnp.asarray(l, jnp.int32) for l in lits), k, 3, ops,
    )
    sel = ((ts >= 20) & (ts < 90)).astype(np.int32)
    _check_sum_count(port, pallas, _first_exact(c, sel, k))


# The count-only pass (values=None) against the JAX package's kernels over a
# zero value plane, as its compiled tier runs min/max and distinct queries.
@pytest.mark.parametrize("kernel", ["group_sum_count", "band", "cmp8"])
@pytest.mark.parametrize("layout", ["sorted_runs", "two_random_codes"])
def test_count_only_vs_pallas_on_a_zero_plane(interpret, kernel, layout):
    (c, _v, ts, s), k = _layout_planes(layout, seed=22)
    b8 = (s != 0).astype(np.int8)
    zero = np.zeros_like(c)
    tc, tts = torch.from_numpy(c), torch.from_numpy(ts)
    if kernel == "group_sum_count":
        port = AK.group_sum_count(tc, None, torch.from_numpy(s), k)
        pallas = PA.pallas_group_sum_count(
            jnp.asarray(c), jnp.asarray(zero), jnp.asarray(s), k, 1
        )
        sel = s
    elif kernel == "band":
        port = AK.fused_band_group_sum_count(tc, None, (tts,), (30,), k, 1, (">=",))
        pallas = PA.pallas_fused_band_group_sum_count(
            jnp.asarray(c), jnp.asarray(zero), (jnp.asarray(ts),),
            (jnp.asarray(30, jnp.int32),), k, 1, (">=",),
        )
        sel = (ts >= 30).astype(np.int32)
    else:
        port = AK.fused_cmp_group_sum_count(
            tc, None, tts, torch.from_numpy(b8), 7, k, 1, "!="
        )
        pallas = PA.pallas_fused_cmp_group_sum_count(
            jnp.asarray(c), jnp.asarray(zero), jnp.asarray(ts), jnp.asarray(b8),
            jnp.asarray(7), k, 1, "!=",
        )
        sel = ((b8 != 0) & (ts != 7)).astype(np.int32)
    assert port[0].dtype == torch.int64 and not port[0].any()
    _check_sum_count(port, pallas, _first_exact(c, sel, k))


# ---------------------------------------------------------------------------
# K4: fused_cmp_group_sum_count vs pallas_fused_cmp_group_sum_count


@pytest.mark.parametrize("op,lit", [("==", 7), ("!=", 7), ("!=", 1000)])
def test_cmp8_vs_pallas(interpret, op, lit):
    c, v, ts, _s, b8 = _planes(5, 2, 96, 1 << 14, live_rows=12000)
    port = AK.fused_cmp_group_sum_count(
        torch.from_numpy(c), torch.from_numpy(v), torch.from_numpy(ts),
        torch.from_numpy(b8), lit, 96, 2, op,
    )
    pallas = PA.pallas_fused_cmp_group_sum_count(
        jnp.asarray(c), jnp.asarray(v), jnp.asarray(ts), jnp.asarray(b8),
        jnp.asarray(lit), 96, 2, op,
    )
    _check_sum_count(port, pallas)


# ---------------------------------------------------------------------------
# K3: group_min_max vs pallas_group_min_max


@pytest.mark.parametrize(
    "num_codes,sel_p,lo,hi",
    [
        (1, 0.5, 0, 1000),
        (127, 0.2, I32_MIN, I32_MAX),  # values near both int32 ends
        (129, 0.0, 0, 1000),  # every row filtered out: sentinels
        (256, 0.5, -(2**30), 2**30),
    ],
)
def test_min_max_vs_pallas(interpret, num_codes, sel_p, lo, hi):
    c, _v, _ts, s, _b = _planes(6, 1, num_codes, 2, sel_p)
    rng = np.random.default_rng(7)
    v = rng.integers(lo, hi, c.shape, dtype=np.int64, endpoint=True)
    v = v.astype(np.int32)
    mins, maxs = AK.group_min_max(
        torch.from_numpy(c), torch.from_numpy(v), torch.from_numpy(s), num_codes
    )
    jmin, jmax = PA.pallas_group_min_max(
        jnp.asarray(c), jnp.asarray(v), jnp.asarray(s), num_codes
    )
    np.testing.assert_array_equal(mins.numpy(), np.asarray(jmin))
    np.testing.assert_array_equal(maxs.numpy(), np.asarray(jmax))


# K3 on the code layouts of the shared CUDA template, and on a selection
# plane holding negative values, which select no row (sel > 0 only).
@pytest.mark.parametrize("layout", sorted(_LAYOUTS) + ["negative_sel"])
def test_min_max_layouts_vs_pallas(interpret, layout):
    (c, v, _ts, s), k = _layout_planes("sorted_runs" if layout == "negative_sel" else layout)
    v = (v - (1 << 20)).astype(np.int32)  # values of both signs
    if layout == "negative_sel":
        s = np.random.default_rng(23).integers(-3, 3, s.shape).astype(np.int32)
    mins, maxs = AK.group_min_max(
        torch.from_numpy(c), torch.from_numpy(v), torch.from_numpy(s), k
    )
    jmin, jmax = PA.pallas_group_min_max(
        jnp.asarray(c), jnp.asarray(v), jnp.asarray(s), k
    )
    np.testing.assert_array_equal(mins.numpy(), np.asarray(jmin))
    np.testing.assert_array_equal(maxs.numpy(), np.asarray(jmax))
    assert (mins.numpy() != I32_MAX).any()


# ---------------------------------------------------------------------------
# K = 2048 and ragged lengths against the XLA twins (ops/fused.py)


def _flat(seed, n, num_codes):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, num_codes, n).astype(np.int32)
    values = rng.integers(0, 1 << 21, n).astype(np.int32)
    sel = rng.random(n) < 0.4
    return codes, values, sel


@pytest.mark.parametrize("num_codes,n", [(2048, 100_003), (2048, 7), (1, 4097)])
def test_sum_count_vs_xla_twins(num_codes, n):
    c, v, s = _flat(8, n, num_codes)
    sums, counts, first = AK.group_sum_count(
        torch.from_numpy(c), torch.from_numpy(v),
        torch.from_numpy(s.astype(np.int32)), num_codes, 3,
    )
    js, jc = JF.filter_group_scatter(
        jnp.asarray(c), jnp.asarray(v), jnp.asarray(s), num_codes
    )
    jf = JF.first_selected_row(jnp.asarray(c), jnp.asarray(s), num_codes)
    np.testing.assert_array_equal(sums.numpy(), np.asarray(js))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(first.numpy(), np.asarray(jf))


@pytest.mark.parametrize("num_codes,n", [(2048, 100_003), (3, 5)])
def test_min_max_vs_xla_twin(num_codes, n):
    c, v, s = _flat(9, n, num_codes)
    mins, maxs = AK.group_min_max(
        torch.from_numpy(c), torch.from_numpy(v),
        torch.from_numpy(s.astype(np.int32)), num_codes,
    )
    jmin, jmax = JF.group_min_max_scatter(
        jnp.asarray(c), jnp.asarray(v), jnp.asarray(s), num_codes
    )
    np.testing.assert_array_equal(mins.numpy(), np.asarray(jmin))
    np.testing.assert_array_equal(maxs.numpy(), np.asarray(jmax))


def test_port_fused_matches_xla_twins():
    """ops/fused.py's torch ports against their XLA originals."""
    from frostdb_tpu_torch.ops import fused as TF

    c, v, s = _flat(10, 50_000, 300)
    tc, tv, ts_ = torch.from_numpy(c), torch.from_numpy(v), torch.from_numpy(s)
    jc, jv, js = jnp.asarray(c), jnp.asarray(v), jnp.asarray(s)
    for a, b in zip(
        TF.filter_group_scatter(tc, tv, ts_, 300),
        JF.filter_group_scatter(jc, jv, js, 300),
    ):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(
        TF.group_min_max_scatter(tc, tv, ts_, 300),
        JF.group_min_max_scatter(jc, jv, js, 300),
    ):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        TF.first_selected_row(tc, ts_, 300).numpy(),
        np.asarray(JF.first_selected_row(jc, js, 300)),
    )


# ---------------------------------------------------------------------------
# Wrapper contract


def test_cpu_tensors_take_the_plain_version_without_counting():
    AK.reset_launches()
    c, v, s = _flat(11, 1000, 16)
    tc, tv = torch.from_numpy(c), torch.from_numpy(v)
    ts_ = torch.from_numpy(s.astype(np.int32))
    AK.group_sum_count(tc, tv, ts_, 16)
    AK.group_min_max(tc, tv, ts_, 16)
    AK.fused_band_group_sum_count(tc, tv, (tv,), (5,), 16, 3, (">",))
    AK.fused_cmp_group_sum_count(
        tc, tv, tv, ts_.to(torch.int8), 5, 16, 3, "=="
    )
    assert all(n == 0 for n in AK.LAUNCHES.values())


@pytest.mark.parametrize("kernel", ["sum_count", "min_max"])
def test_empty_input_launches_and_counts_nothing(monkeypatch, kernel):
    """With no rows the launch helpers return their pre-filled outputs
    without loading the library, launching or counting."""

    def no_load():
        raise AssertionError("library loaded for an empty input")

    monkeypatch.setattr(AK, "_load", no_load)
    AK.reset_launches()
    e = torch.zeros(0, dtype=torch.int32)
    if kernel == "sum_count":
        sums, counts, first = AK._launch_sum_count(
            "group_sum_count", AK._MODE_SEL, 1, e, e, [e], None, [], [], 5, 2
        )
        assert sums.tolist() == [0] * 5 and counts.tolist() == [0] * 5
        assert first.tolist() == [2**31 - 1] * 5
    else:
        mins, maxs = AK._launch_min_max(e, e, e, 5)
        assert mins.tolist() == [2**31 - 1] * 5
        assert maxs.tolist() == [-(2**31)] * 5
    assert all(n == 0 for n in AK.LAUNCHES.values())


def test_launch_counts_are_exact_under_threads():
    """Queries on several threads launch at once: 8 threads counting
    10,000 launches each (with the interpreter switching threads as often
    as it can) leave exact totals, by kernel and by variant."""
    import sys
    import threading

    AK.reset_launches()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [
            threading.Thread(
                target=lambda: [AK.count_launch("group_sum_count", "2") for _ in range(10_000)]
            )
            for _ in range(8)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert AK.LAUNCHES["group_sum_count"] == 80_000
    assert AK.TEMPLATE_LAUNCHES == {"group_sum_count[2]": 80_000}
    AK.reset_launches()
    assert not any(AK.LAUNCHES.values()) and AK.TEMPLATE_LAUNCHES == {}


@pytest.mark.parametrize(
    "case",
    ["dtype", "shape", "codes", "digits", "contiguous", "literal", "op"],
)
def test_wrapper_rejects_bad_inputs(case):
    c = torch.zeros(256, dtype=torch.int32)
    v = torch.zeros(256, dtype=torch.int32)
    s = torch.ones(256, dtype=torch.int32)
    k, nd = 8, 2
    if case == "dtype":
        v = v.to(torch.int64)
    elif case == "shape":
        s = s[:100]
    elif case == "codes":
        k = AK.MAX_CODES + 1
    elif case == "digits":
        nd = 8
    elif case == "contiguous":
        c = torch.zeros(512, dtype=torch.int32)[::2]
    with pytest.raises((TypeError, ValueError)):
        if case == "literal":
            AK.fused_band_group_sum_count(c, v, (s,), (2**31,), k, nd, (">",))
        elif case == "op":
            AK.fused_band_group_sum_count(c, v, (s,), (1,), k, nd, ("!=",))
        else:
            AK.group_sum_count(c, v, s, k, nd)


# ---------------------------------------------------------------------------
# K5: filter_group_sum_count vs pallas_filter_group_sum_count and its XLA
# twin (ops/fused.filter_group_sum_count over the `ts >= literal` mask)


@pytest.mark.parametrize(
    "num_codes,n_super,num_digits,vmax,lit",
    [
        (64, 2, 2, 1000, 50),  # bench.py's shape: 64 codes, literal 50
        (129, 1, 3, 1 << 21, 0),  # every row selected
        (1, 1, 2, 1 << 14, 100),  # no row selected
        (64, 1, 2, 2**31 - 1, 30),  # values past 2 digits: the digit mask
    ],
)
def test_filter_group_sum_count_vs_pallas(
    interpret, num_codes, n_super, num_digits, vmax, lit
):
    c, v, ts, _s, _b = _planes(13, n_super, num_codes, vmax)
    sums, counts = AK.filter_group_sum_count(
        torch.from_numpy(c), torch.from_numpy(v), torch.from_numpy(ts), lit,
        num_codes, num_digits,
    )
    js, jc = PA.pallas_filter_group_sum_count(
        jnp.asarray(c), jnp.asarray(v), jnp.asarray(ts), lit, num_codes, num_digits
    )
    np.testing.assert_array_equal(sums.numpy(), np.asarray(js))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    assert sums.dtype == counts.dtype == torch.int64


def test_filter_group_sum_count_on_bench_hash_vs_pallas(interpret):
    """bench.py's kernel-bench data (``gen``: 64 codes from a multiplicative
    hash of the row index, values in [0, 1000), ts in [0, 100)) at 2 x 8192
    rows, ``ts >= 50``: no two neighbouring rows share a run."""
    n = 2 * ROWS_PER_SUPER
    i = np.arange(n, dtype=np.uint64).astype(np.uint32) + np.uint32(
        (3 * 0x9E3779B9) & 0xFFFFFFFF
    )
    h = (i * np.uint32(2654435761)) ^ (i >> 16)
    c, v, ts = (
        a.astype(np.int32).reshape(-1, 128)
        for a in (h % np.uint32(64), (h >> 8) % np.uint32(1000), (h >> 4) % np.uint32(100))
    )
    sums, counts = AK.filter_group_sum_count(
        torch.from_numpy(c), torch.from_numpy(v), torch.from_numpy(ts), 50, 64
    )
    js, jc = PA.pallas_filter_group_sum_count(
        jnp.asarray(c), jnp.asarray(v), jnp.asarray(ts), 50, 64
    )
    np.testing.assert_array_equal(sums.numpy(), np.asarray(js))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    assert counts.sum() == ((h >> 4) % np.uint32(100) >= 50).sum()


@pytest.mark.parametrize("num_codes,lit", [(64, 50), (2048, 10)])
def test_filter_group_sum_count_vs_xla_twin(num_codes, lit):
    rng = np.random.default_rng(14)
    n = 1 << 16
    c = rng.integers(0, num_codes, n).astype(np.int32)
    v = rng.integers(0, 1000, n).astype(np.int32)
    ts = rng.integers(0, 100, n).astype(np.int32)
    sums, counts = AK.filter_group_sum_count(
        torch.from_numpy(c), torch.from_numpy(v), torch.from_numpy(ts), lit, num_codes
    )
    js, jc = JF.filter_group_sum_count(
        jnp.asarray(c), jnp.asarray(v), jnp.asarray(ts >= lit), num_codes, 2
    )
    np.testing.assert_array_equal(sums.numpy(), np.asarray(js))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))


# ---------------------------------------------------------------------------
# K6: block_compact vs pallas_block_compact and the JAX scan program's CPU
# path (compiled_scan._build_scan_program: per-block top_k, -1 past the
# count)


def _compact_sel(seed, n_blocks, probs, n=None):
    """A 0/1 int32 plane of n rows (default n_blocks * 8192), block b
    selected with probability probs[b]."""
    rng = np.random.default_rng(seed)
    p = np.repeat(np.asarray(probs, dtype=np.float64), ROWS_PER_SUPER)
    sel = (rng.random(n_blocks * ROWS_PER_SUPER) < p).astype(np.int32)
    if n is not None:
        sel = sel[:n]
    return sel


def _jax_compact(sel, capb):
    """(bc, idx) of the JAX scan program's CPU path over the zero-padded
    plane: every selected row is valid, no filter clause."""
    import frostdb_tpu.compiled_scan as JCS

    n_blocks = -(-len(sel) // ROWS_PER_SUPER)
    full = np.zeros(n_blocks * ROWS_PER_SUPER, np.int32)
    full[: len(sel)] = sel
    blob = np.asarray(JCS._build_scan_program(((), False), capb, n_blocks)(full))
    return blob[:n_blocks], blob[n_blocks:].reshape(n_blocks, capb), full


@pytest.mark.parametrize(
    "capb,probs,n",
    [
        (16, [1.0, 0.0, 0.001], None),  # all selected, empty, sparse
        (128, [0.01, 0.02], None),
        (1024, [0.5], None),  # 4096 selected past the capacity
        (16, [0.002, 0.3], 8192 + 5000),  # partial last block
    ],
)
def test_block_compact_vs_pallas(interpret, capb, probs, n):
    sel = _compact_sel(15, len(probs), probs, n)
    bc, idx = (t.numpy() for t in AK.block_compact(torch.from_numpy(sel), capb))
    jbc, jidx, full = _jax_compact(sel, capb)
    np.testing.assert_array_equal(bc, jbc)
    np.testing.assert_array_equal(idx, jidx)
    pbc, pidx = PA.pallas_block_compact(jnp.asarray(full.reshape(-1, 128)), capb)
    pbc, pidx = np.asarray(pbc), np.asarray(pidx)
    np.testing.assert_array_equal(bc, pbc)
    for b in range(len(bc)):
        k = min(int(bc[b]), capb)
        np.testing.assert_array_equal(idx[b, :k], pidx[b, :k])
        np.testing.assert_array_equal(idx[b, k:], -1)


@pytest.mark.parametrize("capb", [16, 128, 1024])
def test_block_compact_exact_capacity_and_edges(capb):
    """Blocks with exactly capb, capb + 1 and capb - 1 selected rows, an
    all-selected block, an empty one, a ragged length and an empty plane."""
    rng = np.random.default_rng(16)
    n = 5 * ROWS_PER_SUPER + 777
    sel = np.zeros(n, np.int32)
    for b, k in enumerate([capb, capb + 1, capb - 1]):
        sel[b * ROWS_PER_SUPER + rng.choice(ROWS_PER_SUPER, k, replace=False)] = 1
    sel[3 * ROWS_PER_SUPER : 4 * ROWS_PER_SUPER] = 1
    sel[-100:] = 1
    bc, idx = (t.numpy() for t in AK.block_compact(torch.from_numpy(sel), capb))
    jbc, jidx, _full = _jax_compact(sel, capb)
    np.testing.assert_array_equal(bc, jbc)
    np.testing.assert_array_equal(idx, jidx)
    assert bc.tolist() == [capb, capb + 1, capb - 1, ROWS_PER_SUPER, 0, 100]
    for b in range(len(bc)):
        ref = np.flatnonzero(sel[b * ROWS_PER_SUPER : (b + 1) * ROWS_PER_SUPER])
        np.testing.assert_array_equal(idx[b, : min(len(ref), capb)], ref[:capb])
    ebc, eidx = AK.block_compact(torch.zeros(0, dtype=torch.int32), capb)
    assert ebc.shape == (0,) and eidx.shape == (0, capb)


def test_new_kernels_cpu_and_empty_inputs_count_nothing(monkeypatch):
    def no_load():
        raise AssertionError("library loaded on the CPU path")

    monkeypatch.setattr(AK, "_load", no_load)
    AK.reset_launches()
    c, v, s = _flat(17, 3000, 8)
    tc, tv = torch.from_numpy(c), torch.from_numpy(v)
    AK.filter_group_sum_count(tc, tv, tv, 5, 8, 3)
    AK.block_compact(torch.from_numpy(s.astype(np.int32)), 16)
    assert all(n == 0 for n in AK.LAUNCHES.values())
    for capb in (0, AK.BLOCK_ROWS + 1):
        with pytest.raises(ValueError):
            AK.block_compact(torch.from_numpy(s.astype(np.int32)), capb)
    with pytest.raises(TypeError):
        AK.block_compact(torch.from_numpy(s), 16)
