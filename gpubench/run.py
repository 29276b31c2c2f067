"""The benchmark of frostdb_tpu_torch on one NVIDIA GPU: one run of one cell.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the program's CUDA kernels into the checkout's build/ (once; later
runs load them), generates the cell's rows from the seed, inserts them into
a ColumnStore on the card, syncs, warms up the cell's query shapes, runs the
cell's traffic for the given seconds (one client, closed loop), checks a
sample of the answers against a plain numpy reference, and prints one JSON
line last. With --trace 1 the window runs under torch.profiler and the
program's tracer, and the line holds the per-layer metrics instead of the
end-to-end ones. Exits non-zero, printing no result, without a CUDA device.
"""

import os
import time

# perf_counter reads CLOCK_MONOTONIC, one clock for the whole machine, so
# the start survives the re-exec below.
T_START = float(os.environ.get("GPUBENCH_T_START", time.perf_counter()))

import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)


def fixed_hash_seed() -> None:
    """Re-exec under PYTHONHASHSEED=0, so that every run iterates sets and
    dicts of strings in one order."""
    if os.environ.get("PYTHONHASHSEED") != "0":
        env = dict(os.environ, PYTHONHASHSEED="0", GPUBENCH_T_START=repr(T_START))
        os.execve(sys.executable, [sys.executable] + sys.argv, env)


def gpu_local_cpus() -> set:
    """The CPUs of the first GPU's NUMA node (what ``nvidia-smi topo -m``
    calls its CPU affinity), or every CPU this process may use where that
    cannot be read."""
    allowed = os.sched_getaffinity(0)
    try:
        bus = subprocess.run(["nvidia-smi", "--query-gpu=pci.bus_id", "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=20).stdout.strip()
        with open(f"/sys/bus/pci/devices/{bus[-12:].lower()}/local_cpulist") as f:
            text = f.read().strip()
    except (OSError, subprocess.SubprocessError):
        return allowed
    cpus = set()
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        cpus.update(range(int(lo), int(hi or lo) + 1))
    return (cpus & allowed) or allowed


if __name__ == "__main__":
    fixed_hash_seed()
    # Before any thread starts, so that every thread the run makes keeps to
    # the GPU's own NUMA node.
    os.sched_setaffinity(0, gpu_local_cpus())
    # The CUDA driver's kernel cache lives at a fixed path inside the
    # checkout; the program builds its own kernels into build/.
    os.environ["CUDA_CACHE_PATH"] = os.path.join(CHECKOUT, "build", "gpubench-cache", "nv")
    sys.path[:0] = [HERE, CHECKOUT]
    from harness.runner import main

    sys.exit(main(sys.argv[1:], T_START))
