"""Whether an answer of the program is the reference's, in the normalized
forms of ``reference/numpy_ref.py``."""

from __future__ import annotations

import numpy as np


def _row_keys(m: np.ndarray) -> np.ndarray:
    """Each row of an int64 matrix as one comparable value."""
    m = np.ascontiguousarray(m, dtype=np.int64)
    return m.view(np.dtype((np.void, 8 * m.shape[1]))).ravel()


def mismatch(ref, got) -> str | None:
    """Why ``got`` is not ``ref``, or None where it is."""
    if ref[0] != got[0]:
        return f"answer of kind {got[0]}, expected {ref[0]}"
    kind = ref[0]
    if kind == "groups":
        if ref[1] == got[1]:
            return None
        missing = [k for k in ref[1] if k not in got[1]]
        extra = [k for k in got[1] if k not in ref[1]]
        wrong = [k for k in ref[1] if k in got[1] and got[1][k] != ref[1][k]]
        first = (wrong or missing or extra)[0]
        return (f"{len(wrong)} groups differ, {len(missing)} missing, {len(extra)} extra; "
                f"first {first!r}: {got[1].get(first)} vs {ref[1].get(first)}")
    if kind == "distinct":
        return None if ref[1] == got[1] else f"{len(got[1])} distinct rows, expected {len(ref[1])}"
    if kind == "rows":
        if ref[1].shape == got[1].shape and np.array_equal(ref[1], got[1]):
            return None
        return f"{len(got[1])} rows, expected {len(ref[1])} (or their values differ)"
    # rows_limit: as many rows as the limit allows, each a matching row, no
    # row more often than it matches.
    full, limit = ref[1], ref[2]
    rows = got[1]
    want = min(limit, len(full))
    if len(rows) != want or (len(rows) and rows.shape[1] != full.shape[1]):
        return f"{len(rows)} rows, expected {want}"
    if not len(rows):
        return None
    rk, rn = np.unique(_row_keys(full), return_counts=True)
    gk, gn = np.unique(_row_keys(rows), return_counts=True)
    pos = np.searchsorted(rk, gk)
    ok = (pos < len(rk))
    ok[ok] &= rk[pos[ok]] == gk[ok]
    if not ok.all():
        return f"{int((~ok).sum())} rows match no row of the table"
    if (gn > rn[pos]).any():
        return "a row returned more often than it matches"
    return None
