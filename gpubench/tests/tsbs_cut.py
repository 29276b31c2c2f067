"""The ``tsbs_devops.queries`` cell cut to a size the CPU tests run: fewer
hosts (the 8-host shapes keep 8 hosts, an eighth of the fleet apart) and
fewer hours (each shape's grid of windows cut to the hours held, one
window at least)."""

import copy
import os

from harness import spec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLEET = 4000
HOUR_MS = 3_600_000


def _hosts(x, hosts: int):
    """A host literal of the mix, ``host_{(K + 500 i) mod 4000}``, for a
    fleet of ``hosts``."""
    if isinstance(x, list):
        return [_hosts(v, hosts) for v in x]
    if isinstance(x, int) and x % (FLEET // 8) == 0:
        return x // (FLEET // 8) * (hosts // 8)
    return x


def _walk(p, hosts: int):
    """A predicate with its host literals cut; (step, duration) of its
    time window, where it has one."""
    window = {}
    if p[0] in ("and", "or"):
        parts = []
        for c in p[1:]:
            c, w = _walk(c, hosts)
            parts.append(c)
            window.update(w)
        return [p[0], *parts], window
    if p[1] == "labels.hostname":
        return [p[0], p[1], ["fmt", p[2][1], _hosts(p[2][2], hosts)]], window
    if p[1] == "timestamp" and p[0] == "<":
        # ["+", start, ["*", "$S", step], duration]
        window = {"step": p[2][2][2], "duration": p[2][3]}
    return p, window


def cut(hosts: int, hours: int):
    """(BENCHMARK.json, the cell, its configuration, its mix), cut."""
    bench, cell, config, mix = spec.load_cell(ROOT, "tsbs_devops.queries")
    config, mix = copy.deepcopy(config), copy.deepcopy(mix)
    config["columns"]["labels.hostname"]["strings"]["count"] = hosts
    config["layout"]["inserts"] = hours
    for shape in mix["shapes"].values():
        query = []
        for step in shape["query"]:
            if step[0] == "filter":
                pred, window = _walk(step[1], hosts)
                step = ["filter", pred]
                n = (hours * HOUR_MS - window["duration"]) // window["step"] + 1
                shape["params"]["S"] = {"range": [0, max(n, 1), 1]}
            query.append(step)
        shape["query"] = query
        if "K" in shape.get("free", {}):
            shape["free"]["K"] = {"range": [0, hosts, 1]}
    return bench, cell, config, mix
