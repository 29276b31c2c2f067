"""The traffic generator: the same seed gives the same queries; another
seed gives the same queries in another order."""

import json
import os
import pytest

from harness import spec

GPUBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIXES = sorted(f[:-5] for f in os.listdir(os.path.join(GPUBENCH, "traffic")))


def mix(name):
    return spec.load(os.path.join(GPUBENCH, "traffic", name + ".json"))


def draw(m, seed, n):
    s = spec.Stream(m, seed)
    return [s.next() for _ in range(n)]


@pytest.mark.parametrize("name", MIXES)
def test_stream_is_deterministic_in_the_seed(name):
    m = mix(name)
    big = 2**31 + 12345
    assert draw(m, big, 200) == draw(m, big, 200)
    assert draw(m, big, 200) != draw(m, big + 1, 200)


@pytest.mark.parametrize("name", MIXES)
def test_seeds_send_the_same_work_in_another_order(name):
    """Each shape's first walk through its parameter product holds every
    combination once, whatever the seed."""
    m = mix(name)
    need = {s: len(spec.combos(sh)) for s, sh in m["shapes"].items()}
    n = max(need.values()) * len(m["cycle"])

    def work(seed):
        seen = {s: [] for s in need}
        for s, p, _q in draw(m, seed, n):
            if len(seen[s]) < need[s]:
                free = m["shapes"][s].get("free", {})
                seen[s].append(json.dumps({k: v for k, v in p.items() if k not in free}, sort_keys=True))
        return {s: sorted(v) for s, v in seen.items()}

    a, b = work(1), work(2**31 + 7)
    assert a == b
    assert all(len(set(v)) == need[s] for s, v in a.items())


@pytest.mark.parametrize("name", MIXES)
def test_warmup_runs_every_shape_and_every_structural_value(name):
    m = mix(name)
    warm = spec.warmup_queries(m, 3)
    assert {s for s, _p, _q in warm} == set(m["cycle"])
    for shape_name, shape in m["shapes"].items():
        for p, vals in shape.get("params", {}).items():
            vals = spec.param_values(vals)
            if len(vals) <= 8:
                seen = {params[p] for s, params, _q in warm if s == shape_name}
                assert seen >= set(vals), (shape_name, p)


def test_literals_bind():
    q = [["scan"], ["filter", ["and", [">=", "timestamp", "$T"],
                               ["<", "timestamp", ["min", ["+", "$T", "$W"], 1000]],
                               ["==", "labels.label1", ["fmt", "g{}", "$K"]]]],
         ["limit", 5]]
    got = spec.bind(q, {"T": 900, "W": 250, "K": 3})
    assert got[1][1] == ["and", [">=", "timestamp", 900], ["<", "timestamp", 1000],
                         ["==", "labels.label1", "g3"]]
    assert got[2] == ["limit", 5]
