"""A run of a cell on the CPU at a cut size, for the tests: every step of
``run.py`` but the look for a CUDA device."""

import json
import time

from harness import runner

CELLS = ("parca_profiles.dashboard", "parca_profiles.merge", "parca_profiles.single")
ROWS_PER_PROFILE = 2


def run_cell(capsys, workload, seed=2**31 + 99, seconds=1.0, device="cpu",
             rows_per_profile=ROWS_PER_PROFILE, trace=0):
    """(exit code, result line or None, standard error)."""
    rc = runner.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                      "--trace", str(trace)], time.perf_counter(), device=device,
                     rows_per_profile=rows_per_profile)
    got = capsys.readouterr()
    lines = got.out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), got.err
