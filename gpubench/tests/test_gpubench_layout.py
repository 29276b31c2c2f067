"""BENCHMARK.json names only files that exist, and no module of the benchmark
imports JAX or the JAX package; the reference imports nothing of the
program."""

import ast
import json
import os

import pytest

GPUBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(GPUBENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "frostdb_tpu"}


def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_names_only_files_that_exist():
    b = bench()
    for p in b["paths"]:
        assert os.path.isdir(os.path.join(REPO, p))
    assert os.path.isfile(os.path.join(REPO, b["command"][1]))
    configs = {c["name"]: c for c in b["configs"]}
    for c in configs.values():
        assert os.path.isfile(os.path.join(REPO, c["file"]))
        with open(os.path.join(REPO, c["file"])) as f:
            data = json.load(f)
        assert data["name"] == c["name"]
        assert set(c["reduced"]) <= set(data)
    for w in b["workloads"]:
        assert w["config"] in configs
        assert os.path.isfile(os.path.join(GPUBENCH, "configs", w["config"] + ".json"))
        assert os.path.isfile(os.path.join(GPUBENCH, "traffic", w["traffic"] + ".json"))
    for m in b["per_layer"]:
        assert os.path.isfile(os.path.join(GPUBENCH, "metrics", m["name"] + ".py")), m["name"]
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in b["workloads"]}


def test_every_shape_names_its_tier_and_kernels():
    b = bench()
    for w in b["workloads"]:
        with open(os.path.join(GPUBENCH, "traffic", w["traffic"] + ".json")) as f:
            mix = json.load(f)
        assert set(mix["cycle"]) == set(mix["shapes"])
        for name, shape in mix["shapes"].items():
            assert shape["tier"] and isinstance(shape["kernels"], list), name
            for metric in shape.get("roofline", {}):
                m = next(x for x in b["per_layer"] if x["name"] == metric)
                assert w["name"] in m["workloads"], (w["name"], metric)


def modules():
    for root, _dirs, files in os.walk(GPUBENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def imported(path):
    """Top-level names of every module the file imports (relative imports
    as the package they name)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(modules()), ids=lambda p: os.path.relpath(p, GPUBENCH))
def test_no_module_imports_jax_or_the_jax_package(path):
    names = set(imported(path))
    assert not names & FORBIDDEN, names & FORBIDDEN
    if os.path.relpath(path, GPUBENCH).startswith("reference" + os.sep):
        assert "frostdb_tpu_torch" not in names and "torch" not in names
        assert "harness" not in names
