"""How many rows a query's filter selects, counted from the benchmark's own
rows (never from the program): the rows' joint histogram over the columns
the filter reads, and the filter evaluated once per cell of it."""

from __future__ import annotations

import json

import numpy as np

from reference import numpy_ref as R

_MAX_CELLS = 1 << 22


class SelectedRows:
    def __init__(self, rows):
        self.rows = rows
        self.hists: dict = {}
        self.counts: dict = {}

    def _grid(self, cols: tuple):
        """(histogram, Frame of grid points) over the columns ``cols``,
        each over every value it can take (``rows.levels``)."""
        if cols not in self.hists:
            lv = [self.rows.levels[c] for c in cols]
            sizes = [len(x) for x in lv]
            if int(np.prod(sizes)) > _MAX_CELLS:
                raise ValueError(f"{cols}: too many cells to count selected rows")
            key = None
            for c, n in zip(cols, sizes):
                v = self.rows.codes(c).astype(np.int64)
                key = v if key is None else key * n + v
            hist = np.bincount(key, minlength=int(np.prod(sizes)))
            axes = np.meshgrid(*lv, indexing="ij")
            frame = R.Frame({c: a.ravel() for c, a in zip(cols, axes)},
                            {c: self.rows.dicts[c] for c in cols if c in self.rows.dicts})
            self.hists[cols] = (hist, frame)
        return self.hists[cols]

    def __call__(self, query: list) -> int:
        """Rows selected by the query's filters (every row without one)."""
        key = json.dumps(query)
        if key not in self.counts:
            preds = [s[1] for s in query if s[0] == "filter"]
            if not preds:
                self.counts[key] = self.rows.n
            else:
                pred = ["and", *preds]
                hist, frame = self._grid(tuple(sorted(R.columns_used(pred))))
                self.counts[key] = int(hist[R.mask(pred, frame)].sum())
        return self.counts[key]
