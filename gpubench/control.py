"""The controls of the comparison that decides ``correct``: answers that must
fail it, computed at a cell's own size.

    python3 gpubench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed: the cell's rows, and as many of its queries per shape as a
run compares (the first of the seed's stream), each answered by the
reference and by two controls in the program's place, judged as a run
judges the program:

- ``float32_sums``: the reference adding its sums in float32, the next
  precision below the exact int64 sums the configuration states;
- ``stale_read``: the reference reading the table without its last insert,
  a broken snapshot (the configuration states that a read after sync sees
  every inserted row).

Prints one JSON line per seed. Needs no GPU; runs no program code.
"""

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE]

from harness import datagen, judge, spec  # noqa: E402
from reference import numpy_ref  # noqa: E402



def as_served(answer):
    """A reference answer as a program serves it: a limited scan returns
    no more rows than its limit."""
    if answer[0] == "rows_limit":
        return ("rows_limit", answer[1][:answer[2]], answer[2])
    return answer


CONTROLS = {
    "float32_sums": lambda q, rows, stale: as_served(numpy_ref.answer(q, rows, sum_dtype=np.float32)),
    "stale_read": lambda q, rows, stale: as_served(numpy_ref.answer(q, stale)),
}


def queries(mix: dict, seed: int) -> list:
    """As many queries per shape as a run compares: its sample and its
    slowest."""
    per_shape = mix["checked_per_shape"] + 1
    stream = spec.Stream(mix, seed)
    out = []
    while len(out) < per_shape * len(mix["cycle"]):
        out.append(stream.next())
    return out


def control_counts(workload: str, seed: int, rows_per_profile=None, threads: int = 8) -> dict:
    """{control: wrong answers} over the cell's compared queries at a seed,
    and the number compared under ``"compared"``."""
    _bench, _cell, config, mix = spec.load_cell(HERE, workload)
    rows = datagen.generate(config, seed, rows_per_profile)
    stale = rows.head(rows.n - rows.n // rows.inserts)
    qs = queries(mix, seed)

    def one(item):
        _shape, _params, q = item
        ref = numpy_ref.answer(q, rows)
        return {name: judge.mismatch(ref, f(q, rows, stale)) is not None
                for name, f in CONTROLS.items()}

    with ThreadPoolExecutor(threads) as ex:
        verdicts = list(ex.map(one, qs))
    counts = {name: sum(v[name] for v in verdicts) for name in CONTROLS}
    counts["compared"] = len(qs)
    return counts


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    for seed in args.seeds:
        t = time.perf_counter()
        counts = control_counts(args.workload, seed, threads=min(8, os.cpu_count() or 1))
        print(json.dumps({"workload": args.workload, "seed": seed, "wrong_answers": counts,
                          "seconds": round(time.perf_counter() - t, 3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
