"""A whole run of each cell on the card at a cut size: correct, every shape
on its tier, the expected kernels launched. Skips without a CUDA device
(decided inside the test). Run on the card with:

    python -m pytest gpubench/tests -m chip
"""

import ast

import pytest

from cells import CELLS, run_cell


@pytest.mark.chip
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(capsys, workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rc, res, err = run_cell(capsys, workload, device="cuda", rows_per_profile=32, seconds=2)
    assert rc == 0 and res["correct"], err
    assert res["device"]["platform"] == "gpu"
    for line in err.splitlines():
        if line.startswith("warm-up "):
            served, rest = line.split("served by ")[1].split(" (expected ", 1)
            assert ast.literal_eval(served) == [rest.split(")")[0]], line
            launched, want = line.split("launches per query ")[1].split(" (expected kernels ")
            want = set(ast.literal_eval(want.rstrip(")")))
            assert all(set(c) == want for c in ast.literal_eval(launched)), line
