"""``python -m frostdb_tpu_torch.tools.verify`` against the JAX package's
``tools/verify_tpu.py``: every case at seeds 0 and 1, drawn from the same
``default_rng(1000 + seed)``, through both tools, the port's on the CPU.
The reference tool's compiled rows must equal the port's compiled rows
(and each tool's generic rows its compiled rows), byte for byte: the same
groups in the same order with the same int64 and float64 values. The port's
fast run must be served by the ``compiled`` tier.
"""

import importlib.util
import pathlib
import re

import numpy as np
import pytest

from frostdb_tpu_torch.tools import verify as PV

REPO = pathlib.Path(__file__).resolve().parents[1]


def load_reference_tool():
    spec = importlib.util.spec_from_file_location("verify_tpu", REPO / "tools" / "verify_tpu.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


RV = load_reference_tool()
NAMES = [name for name, _fn in RV.CASES]
IDS = [re.sub(r"[^a-z0-9]+", "-", name.lower()).strip("-") for name in NAMES]


def test_same_cases():
    assert [name for name, _fn in PV.CASES] == NAMES


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("index", range(len(NAMES)), ids=IDS)
def test_compiled_rows_equal_reference_tool(index, seed):
    _name, ref_fn = RV.CASES[index]
    rng = np.random.default_rng(1000 + seed)
    db, aggs, filt, ordered = ref_fn(rng)
    ref_fast = RV._batch_tuples(RV._run(db, True, aggs, filt, ordered))
    ref_slow = RV._batch_tuples(RV._run(db, False, aggs, filt, ordered))
    assert ref_fast == ref_slow

    got = PV.run_case(PV.CASES[index][1], seed, device="cpu")
    assert got["problems"] == []
    assert got["path"] == "compiled"
    assert got["compiled"] == ref_fast
    assert got["generic"] == ref_slow
    assert got["rows"] == sum(
        p.num_rows() for p in db.get_table("t").collect_parts(db.high_watermark())
    )


def test_main_passes_on_the_cpu(capsys):
    assert PV.main(["--device", "cpu", "--seeds", "2"]) == 0
    out = capsys.readouterr().out
    assert out.count(": ok (") == 2 * len(NAMES)
    assert "PASS" in out.splitlines()[-1]


def test_launch_problems():
    """On a CUDA table the fast run must launch K1-K4, and K3 wherever the
    case takes min or max."""
    from frostdb_tpu_torch.query import expr as E

    none = dict.fromkeys(PV.AGG_KERNELS, 0)
    sums = [E.Sum(E.Col("value")), E.Count(E.Col("value"))]
    mins = sums + [E.Min(E.Col("value"))]
    assert PV.launch_problems(sums, none) == ["fast run launched none of K1-K4"]
    assert PV.launch_problems(sums, {**none, "group_sum_count": 1}) == []
    assert PV.launch_problems(mins, {**none, "group_sum_count": 1}) == [
        "min/max case did not launch K3 (group_min_max)"
    ]
    assert PV.launch_problems(mins, {**none, "group_min_max": 2}) == []
