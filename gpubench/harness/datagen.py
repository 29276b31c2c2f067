"""A configuration's rows, generated from the run's seed with numpy, as the
configuration's ``columns`` and ``layout`` describe them.

Rows come in profiles, as a profiler's agents send them: a profile is one
series (one value of each column listed under ``series``, every
combination of them) at one round of ``layout.interval_ms``. Insert ``i``
holds rounds ``i * rounds_per_insert`` to ``(i + 1) * rounds_per_insert -
1``, round by round, every series in each round, ``rows_per_profile`` rows
to a profile; so the table is written in time order. Each column is one of:

- a string column, ``{"strings": [...]}`` or ``{"strings": {"format":
  "node-{}", "count": n}}``, whose values are the series' (when listed
  under ``series``) or drawn per row with ``"draw": {"zipf": s}`` (the
  string of rank r with p proportional to 1 / r^s);
- an int64 column drawn per row, ``"draw": {"uniform": [lo, hi]}`` (hi
  excluded);
- the profile's time, ``"draw": "profile_time"``: ``layout.start_ms +
  round * interval_ms + series * layout.stagger_ms``, the same for every
  row of a profile.

The stacktrace draw is a frozen copy of ``chip_smoke.py``'s
``stack_probabilities``, drawn through Walker's alias table. The arrays
are the benchmark's own: the program gets them as inserts, the reference
reads them as they are. A column of another kind is refused. Imports
nothing of the program.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np


@dataclass
class Rows:
    """Every generated row, in insert order. String columns are codes into
    ``dicts[name]``; ``levels[name]`` holds every value a column can take,
    sorted; ``inserts`` is the number of inserts."""

    columns: dict
    dicts: dict
    levels: dict
    inserts: int

    @property
    def n(self) -> int:
        return len(next(iter(self.columns.values())))

    def batches(self):
        """Each insert's rows {column: array}, in order."""
        n = self.n // self.inserts
        for i in range(self.inserts):
            yield {k: v[i * n:(i + 1) * n] for k, v in self.columns.items()}

    def head(self, n: int) -> "Rows":
        """The first ``n`` rows (a read that misses the later inserts)."""
        return Rows({k: v[:n] for k, v in self.columns.items()}, self.dicts, self.levels,
                    self.inserts)

    def codes(self, name: str) -> np.ndarray:
        """A column as indices into ``levels[name]``."""
        lv, v = self.levels[name], self.columns[name]
        if len(lv) and lv[-1] - lv[0] == len(lv) - 1:
            return v - lv[0] if lv[0] else v
        return np.searchsorted(lv, v)


def stack_probabilities(stacks: int, zipf: float) -> np.ndarray:
    """The stack of rank r is drawn with p proportional to 1 / r^zipf."""
    p = 1.0 / np.arange(1, stacks + 1, dtype=np.float64) ** zipf
    return p / p.sum()


def alias_table(p: np.ndarray):
    """Walker's alias table of the distribution ``p`` (Vose's method): a
    draw takes a uniform index i and keeps it with probability
    ``keep[i]``, else takes ``alias[i]``."""
    n = len(p)
    scaled = p * n
    keep = np.ones(n)
    alias = np.arange(n, dtype=np.int32)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s, l = small.pop(), large.pop()
        keep[s] = scaled[s]
        alias[s] = l
        scaled[l] -= 1.0 - scaled[s]
        (small if scaled[l] < 1.0 else large).append(l)
    return keep, alias


def strings(spec) -> list:
    if isinstance(spec, dict):
        return [spec["format"].format(i) for i in range(spec["count"])]
    return list(spec)


def dictionaries(config: dict) -> dict:
    """The strings of each string column, by code."""
    return {name: strings(c["strings"]) for name, c in config["columns"].items() if "strings" in c}


def series_codes(config: dict) -> dict:
    """{series column: the code of each series}, every combination of the
    series columns' strings, the first column varying slowest."""
    names = config["series"]
    sizes = [len(strings(config["columns"][n]["strings"])) for n in names]
    combos = np.array(list(itertools.product(*[range(s) for s in sizes])), np.int32)
    return {n: combos[:, i] for i, n in enumerate(names)}


def check(config: dict) -> None:
    """Refuse a configuration this generator cannot produce."""
    lay = config["layout"]
    for key in ("inserts", "rounds_per_insert", "rows_per_profile", "start_ms", "interval_ms",
                "stagger_ms"):
        if not isinstance(lay.get(key), int):
            raise ValueError(f"layout.{key}: a whole number is needed")
    n_series = len(next(iter(series_codes(config).values())))
    if n_series * lay["stagger_ms"] > lay["interval_ms"]:
        raise ValueError("series staggered past one interval")
    for name, c in config["columns"].items():
        draw = c.get("draw")
        if "strings" in c:
            ok = (draw is None) == (name in config["series"])
            ok &= draw is None or set(draw) == {"zipf"}
        else:
            ok = draw == "profile_time" or (isinstance(draw, dict) and set(draw) == {"uniform"})
        if not ok:
            raise ValueError(f"column {name}: no generator for {c}")


def levels(config: dict) -> dict:
    """Every value each column can take, sorted."""
    lay = config["layout"]
    out = {}
    for name, c in config["columns"].items():
        draw = c.get("draw")
        if "strings" in c:
            out[name] = np.arange(len(strings(c["strings"])), dtype=np.int64)
        elif draw == "profile_time":
            rounds = lay["inserts"] * lay["rounds_per_insert"]
            n_series = len(next(iter(series_codes(config).values())))
            t = (lay["start_ms"] + lay["interval_ms"] * np.arange(rounds, dtype=np.int64)[:, None]
                 + lay["stagger_ms"] * np.arange(n_series, dtype=np.int64)[None, :])
            out[name] = np.unique(t)
        else:
            lo, hi = draw["uniform"]
            out[name] = np.arange(lo, hi, dtype=np.int64)
    return out


def insert_batches(config: dict, seed: int, rows_per_profile: int | None = None):
    """Yield each insert's columns {name: array} in order. Per insert the
    columns draw in the configuration's order from one
    ``numpy.random.default_rng(seed)``."""
    check(config)
    lay = config["layout"]
    per = rows_per_profile or lay["rows_per_profile"]
    rng = np.random.default_rng(seed)
    series = series_codes(config)
    n_series = len(next(iter(series.values())))
    rounds = lay["rounds_per_insert"]
    n = rounds * n_series * per
    # Row j of an insert belongs to profile j // per: round (j // per) //
    # n_series, series (j // per) % n_series.
    prof_series = np.tile(np.arange(n_series), rounds)
    prof_round = np.repeat(np.arange(rounds, dtype=np.int64), n_series)
    tables = {}
    fixed = {}  # columns that are the same in every insert but for an offset
    for name, c in config["columns"].items():
        draw = c.get("draw")
        if name in series:
            fixed[name] = np.repeat(series[name][prof_series], per)
        elif draw == "profile_time":
            fixed[name] = np.repeat(lay["start_ms"] + lay["interval_ms"] * prof_round
                                    + lay["stagger_ms"] * prof_series, per)
        elif "zipf" in draw:
            tables[name] = alias_table(stack_probabilities(len(strings(c["strings"])), draw["zipf"]))
    for i in range(lay["inserts"]):
        out = {}
        for name, c in config["columns"].items():
            draw = c.get("draw")
            if name in series:
                out[name] = fixed[name].copy()
            elif draw == "profile_time":
                out[name] = fixed[name] + lay["interval_ms"] * i * rounds
            elif name in tables:
                keep, alias = tables[name]
                k = rng.integers(0, len(keep), n, dtype=np.int32)
                out[name] = np.where(rng.random(n) < keep[k], k, alias[k])
            else:
                lo, hi = draw["uniform"]
                out[name] = rng.integers(lo, hi, n, dtype=np.int64)
        yield out


def generate(config: dict, seed: int, rows_per_profile: int | None = None) -> Rows:
    """Every insert's rows, one array a column, in insert order."""
    cols = None
    inserts = config["layout"]["inserts"]
    for i, b in enumerate(insert_batches(config, seed, rows_per_profile)):
        n = len(next(iter(b.values())))
        if cols is None:
            cols = {k: np.empty(n * inserts, v.dtype) for k, v in b.items()}
        for k, v in b.items():
            cols[k][i * n:(i + 1) * n] = v
    return Rows(cols, dictionaries(config), levels(config), inserts)
