"""The port's loader of the native C++ runtime (frostdb_tpu_torch/native.py)
against the JAX package's: tests/test_native.py's five cases run through
the port (its own module, compiled against the port by ``port_view``), and
each result is held equal to the JAX package's on the same input —
dictionary codes with and without the native runtime, ``fdb_hash64``
beside ``_hash64``, ``crc32`` beside zlib, arena growth.

Also here: four processes that load the runtime from one fresh build
directory at once must all get the library. Each writes its own temp file
before the atomic rename, so no process can lose a race for a shared one.
"""

import pathlib
import subprocess
import sys
import zlib

import numpy as np

import test_native as TN
from frostdb_tpu import native as jnative
from frostdb_tpu.columnbatch import Dictionary as JDictionary
from frostdb_tpu.columnbatch import _hash64 as j_hash64
from test_torch_engine import port_view

from frostdb_tpu_torch import native
from frostdb_tpu_torch.columnbatch import Dictionary, _hash64

PN = port_view(TN)
VALUES = ["alpha", "beta", "alpha", None, "gamma", "beta", "", "δunicode"]


def test_native_available():
    PN.test_native_available()
    assert PN.native is native


def test_dict_parity_native_vs_python():
    PN.test_dict_parity_native_vs_python()
    ref_codes, ref_valid = JDictionary(use_native=False).encode(VALUES)
    for use_native in (True, False):
        d = Dictionary(use_native=use_native)
        codes, valid = d.encode(VALUES)
        np.testing.assert_array_equal(codes, ref_codes)
        np.testing.assert_array_equal(valid, ref_valid)
        ref = JDictionary(use_native=False)
        ref.encode(VALUES)
        assert d.values == ref.values
        np.testing.assert_array_equal(d.hash_for_code(), ref.hash_for_code())


def test_native_hash_matches_python():
    PN.test_native_hash_matches_python()
    lib = native.load()
    for s in ["", "a", "hello world", "x" * 100, "δ" * 9]:
        b = s.encode("utf-8")
        assert int(lib.fdb_hash64(b, len(b))) == _hash64(s) == j_hash64(s), s


def test_crc32_zlib_compatible():
    PN.test_crc32_zlib_compatible()
    for data in [b"", b"hello", bytes(range(256)) * 7]:
        for seed in (0, 12345):
            want = zlib.crc32(data, seed) & 0xFFFFFFFF
            assert native.crc32(data, seed) == jnative.crc32(data, seed) == want


def test_dict_many_values_arena_growth():
    PN.test_dict_many_values_arena_growth()
    vals = [f"value_{i:06d}" for i in range(5000)]
    d, ref = Dictionary(use_native=True), JDictionary(use_native=True)
    for chunk in (vals, vals[:100], vals[2500:], ["new"] + vals[::7]):
        np.testing.assert_array_equal(d.encode(chunk)[0], ref.encode(chunk)[0])
    assert d.values == ref.values


LOAD = """
import sys
import frostdb_tpu_torch.native as N
N._CACHE = sys.argv[1]
print("loaded" if N.load() is not None else "none")
"""


def test_processes_building_at_once_all_load(tmp_path):
    """Four processes load the runtime from one empty build directory at
    once: each compiles, and each must get the library."""
    repo = pathlib.Path(__file__).resolve().parents[1]
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", LOAD, str(tmp_path)],
            cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for _ in range(4)
    ]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    assert [o.strip() for o, _e in outs] == ["loaded"] * 4, outs
    built = sorted(f.name for f in tmp_path.iterdir())
    assert len(built) == 1 and built[0].endswith(".so"), built
