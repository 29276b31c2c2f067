"""The traffic generator: one general reader of the mix files under
``traffic/``.

A mix file (JSON) names a cycle of query shapes and, for each shape, its
query as data, the parameters it draws and the tier and kernels expected to
serve it. Each parameter lists its values (``[v, ...]``) or a range
(``{"range": [lo, hi, step]}``). A shape's queries take the Cartesian
product of its ``params``' values, in an order shuffled by the seed, and
cycle through it; so every seed sends the same set of queries in another
order, and two seeds differ in order, not in work. A parameter under
``free`` (one that does not change the work, such as which label a
selector names) walks its own shuffled cycle beside the product.

Query steps (a list, applied in order):

- ``["scan"]`` / ``["scan_schema"]``: the configuration's table / its schema;
- ``["filter", pred]``;
- ``["aggregate", [[func, column], ...], [key, ...]]`` with func one of
  sum, count, min, max and key ``["col", name]`` or ``["duration", width]``
  (a literal);
- ``["distinct", [key, ...]]`` with key ``["col", name]`` or a predicate;
- ``["project", [name, ...]]``; ``["limit", n]``.

A predicate is ``[op, column, literal]`` with op one of ``>= > <= < == !=``,
``["regex", column, pattern]``, ``["and", p, q, ...]`` or ``["or", p, q,
...]``. A literal is a number, a string, ``"$P"`` (parameter P),
``[op, a, b, ...]`` with op one of ``+ - * // min max``, or ``["fmt",
"g{}", a]``.
"""

from __future__ import annotations

import itertools
import json
import os

import numpy as np

COMPARISONS = (">=", ">", "<=", "<", "==", "!=")
_ARITH = {
    "+": lambda *a: sum(a), "-": lambda a, b: a - b, "*": lambda a, b: a * b,
    "//": lambda a, b: a // b, "min": min, "max": max,
}


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def param_values(p) -> list:
    if isinstance(p, dict):
        lo, hi, step = p["range"]
        return list(range(lo, hi, step))
    return list(p)


def combos(shape: dict) -> list:
    """Every parameter assignment of a shape, in a fixed order."""
    params = shape.get("params", {})
    names = sorted(params)
    values = [param_values(params[n]) for n in names]
    return [dict(zip(names, c)) for c in itertools.product(*values)]


def literal(x, params: dict):
    """A literal's value under ``params``."""
    if isinstance(x, str) and x.startswith("$"):
        return params[x[1:]]
    if isinstance(x, list):
        op, *args = x
        if op in _ARITH:
            return _ARITH[op](*[literal(a, params) for a in args])
        if op == "fmt":
            return args[0].format(literal(args[1], params))
        raise ValueError(f"unknown literal form {op!r}")
    return x


def bind_pred(p, params: dict):
    """A predicate with its literals replaced by their values."""
    if p[0] in COMPARISONS:
        return [p[0], p[1], literal(p[2], params)]
    if p[0] in ("and", "or"):
        return [p[0]] + [bind_pred(c, params) for c in p[1:]]
    if p[0] == "regex":
        return p
    raise ValueError(f"unknown predicate {p[0]!r}")


def bind_key(k, params: dict):
    """A group or distinct key with its literals replaced by their values."""
    if k[0] == "col":
        return k
    if k[0] == "duration":
        return ["duration", literal(k[1], params)]
    return bind_pred(k, params)


def bind(query: list, params: dict) -> list:
    """A query with every literal replaced by its value."""
    out = []
    for step in query:
        if step[0] == "filter":
            step = ["filter", bind_pred(step[1], params)]
        elif step[0] == "distinct":
            step = ["distinct", [bind_key(k, params) for k in step[1]]]
        elif step[0] == "aggregate":
            step = ["aggregate", step[1], [bind_key(k, params) for k in step[2]]]
        elif step[0] == "limit":
            step = ["limit", literal(step[1], params)]
        out.append(step)
    return out


class Stream:
    """The mix's queries for one seed: ``next()`` gives (shape name, bound
    query). Shapes follow the mix's cycle; each shape walks its own
    shuffled parameter list."""

    def __init__(self, mix: dict, seed: int):
        rng = np.random.default_rng([seed, 0])
        self.mix = mix
        self.cycle = list(mix["cycle"])
        self.orders, self.free = {}, {}
        for name in sorted(mix["shapes"]):
            shape = mix["shapes"][name]
            c = combos(shape)
            self.orders[name] = [c[i] for i in rng.permutation(len(c))]
            self.free[name] = {
                p: [vals[i] for i in rng.permutation(len(vals))]
                for p, vals in ((p, param_values(v)) for p, v in sorted(shape.get("free", {}).items()))
            }
        self.pos = {name: 0 for name in self.orders}
        self.i = 0

    def next(self):
        name = self.cycle[self.i % len(self.cycle)]
        self.i += 1
        k = self.pos[name]
        self.pos[name] = k + 1
        order = self.orders[name]
        params = dict(order[k % len(order)])
        params.update({p: vals[k % len(vals)] for p, vals in self.free[name].items()})
        return name, params, bind(self.mix["shapes"][name]["query"], params)


def warmup_queries(mix: dict, seed: int):
    """Each shape once for every value of each of its parameters with few
    values (the values that change a query's structure, such as a band's
    width), and twice more at drawn values: (shape name, params, query)."""
    rng = np.random.default_rng([seed, 1])
    out = []
    for name in mix["cycle"]:
        if any(o[0] == name for o in out):
            continue
        shape = mix["shapes"][name]
        c = combos(shape)
        picks = [c[i] for i in rng.choice(len(c), min(2, len(c)), replace=False)]
        for pname, p in shape.get("params", {}).items():
            vals = param_values(p)
            if len(vals) <= 8:
                for v in vals:
                    picks.append(next(x for x in c if x[pname] == v))
        free = {p: param_values(v)[0] for p, v in shape.get("free", {}).items()}
        for params in picks:
            params = {**params, **free}
            out.append((name, params, bind(shape["query"], params)))
    return out


def load_cell(root: str, workload: str):
    """(BENCHMARK.json, the cell, its configuration, its mix) for a cell
    name, or None where BENCHMARK.json has no such cell. ``root`` is the
    benchmark's folder, beside BENCHMARK.json."""
    bench = load(os.path.join(os.path.dirname(root), "BENCHMARK.json"))
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        return None
    return (bench, cell, load(os.path.join(root, "configs", cell["config"] + ".json")),
            load(os.path.join(root, "traffic", cell["traffic"] + ".json")))
