"""Concurrent writers, a compactor and readers in the port against the
JAX package's invariants: tests/test_concurrency.py's scenario runs
through each package (the port through ``port_view``) and each is held to
snapshot isolation at every watermark a reader sees. Thread timing decides
the interleaving, so each package is held to the invariant on its own, not
to the other's rows.

Readers also query through the engine while writers and the compactor run:
every result must equal the numpy aggregate over the inserts at or below
some watermark between the one read before the query and the one read
after it (no torn batch, no rows lost to a merge, no label on another
label's rows). The compiled tiers read
their parts under a registered view; the reference reads the watermark
unregistered, so a compaction between that read and the scan can merge
visible parts into one the query cannot see (marked ``divergence``).
The port's dictionaries take a lock, so writers encoding a new value at
once give it one code, and a table hands writers asking for a new
dictionary at once the same one; the reference can give a value two codes
or drop a writer's dictionary (``divergence``).
"""

import threading
import time

import numpy as np
import pytest

import test_concurrency as TCC
from frostdb_tpu.query import expr as JE
from frostdb_tpu.query.engine import LocalEngine as JEngine
from frostdb_tpu.query.physical import ExecOptions as JOptions
from test_torch_engine import port_view

from frostdb_tpu_torch.query import expr as PE
from frostdb_tpu_torch.query.engine import LocalEngine as PEngine
from frostdb_tpu_torch.query.physical import ExecOptions as POptions

PCC = port_view(TCC)
MODS = {"jax": TCC, "port": PCC}
# Each module's package: its expressions, engine and options.
QUERY = {TCC: (JE, JEngine, JOptions), PCC: (PE, PEngine, POptions)}

NUM_LABELS = 8
LIT = 40


@pytest.mark.parametrize("pkg", list(MODS))
def test_concurrent_writers_and_isolated_readers(pkg):
    MODS[pkg].test_concurrent_writers_and_isolated_readers()


def new_table(M):
    """A sample_definition table in a new store of module M's package (the
    port's on the CPU)."""
    store = M.ColumnStore(**({"device": "cpu"} if M is PCC else {}))
    db = store.db("cc")
    return db, db.table("t", M.TableConfig(schema=M.sample_definition()))


def label_batch(M, table, rng, n):
    """A sample_definition batch of ``n`` rows over NUM_LABELS labels, and
    its per-label (sum, count) of rows with ``timestamp >= LIT``."""
    d_et, d_l, d_st = (table.dictionary(f) for f in ("example_type", "labels", "stacktrace"))
    labels = rng.integers(0, NUM_LABELS, n)
    ts = rng.integers(0, 1000, n).astype(np.int64)
    val = rng.integers(-500, 1000, n).astype(np.int64)
    ones = np.ones(n, dtype=bool)
    batch = M.ColumnBatch(
        [
            M.Column("example_type", M.KIND_DICT, *d_et.encode(["cpu"] * n), d_et),
            M.Column("labels.label1", M.KIND_DICT, *d_l.encode([f"l{x}" for x in labels]), d_l),
            M.Column("stacktrace", M.KIND_DICT, *d_st.encode(["s"] * n), d_st),
            M.Column("timestamp", M.KIND_INT64, ts, ones),
            M.Column("value", M.KIND_INT64, val, ones),
        ],
        n,
    )
    m = ts >= LIT
    agg = np.stack(
        [
            np.bincount(labels[m], weights=val[m], minlength=NUM_LABELS),
            np.bincount(labels[m], minlength=NUM_LABELS),
        ]
    ).astype(np.int64)
    return batch, agg


def band_query(M, db, compiled):
    """``timestamp >= LIT``, sum and count of value by label: {label:
    (sum, count)} and the serving tier."""
    E, LocalEngine, ExecOptions = QUERY[M]
    eng = LocalEngine(db.table_provider(), ExecOptions(compiled_serving=compiled))
    out = []
    eng.scan_table("t").filter(E.Col("timestamp").gt_eq(LIT)).aggregate(
        [E.Sum(E.Col("value")), E.Count(E.Col("value"))], [E.Col("labels.label1")]
    ).execute(out.append)
    got = {}
    for b in out:
        for i in range(b.num_rows):
            got[b.columns[0].py_value(i)] = (b.columns[1].py_value(i), b.columns[2].py_value(i))
    return got, eng.last_serving_path


def as_groups(agg):
    return {f"l{k}": (int(agg[0, k]), int(agg[1, k])) for k in range(NUM_LABELS) if agg[1, k]}


def readers_during_writes(M, compiled, new_values, writers=4, inserts=6, rows=256):
    """Writers, a compactor and two engine readers on module M's package;
    returns the isolation errors, the paths that served and the number of
    results checked. Unless ``new_values``, every string the writers
    encode is in the table's dictionaries before they start."""
    db, table = new_table(M)
    if not new_values:
        table.dictionary("example_type").encode(["cpu"])
        table.dictionary("labels").encode([f"l{k}" for k in range(NUM_LABELS)])
        table.dictionary("stacktrace").encode(["s"])
    create_tx = db.high_watermark()
    by_tx: dict = {}
    errors: list = []
    seen: list = []
    stop = threading.Event()

    def writer(wid):
        rng = np.random.default_rng(100 + wid)
        for _ in range(inserts):
            batch, agg = label_batch(M, table, rng, rows)
            by_tx[table.insert_record(batch)] = agg
            time.sleep(0.001)  # lets the readers in between inserts

    def compactor():
        while not stop.is_set():
            table.active_block.index.compact_level(0)

    def reader():
        while not stop.is_set():
            lo = db.high_watermark()
            try:
                got, path = band_query(M, db, compiled)
            except Exception as e:  # surfaced by the assertion on errors
                errors.append(f"reader: {e!r}")
                return
            seen.append((lo, db.high_watermark(), got, path))

    threads = [threading.Thread(target=writer, args=(w,)) for w in range(writers)]
    aux = [threading.Thread(target=f) for f in (compactor, reader, reader)]
    for t in aux + threads:
        t.start()
    for t in threads:
        t.join()
    stop.set()
    for t in aux:
        t.join()
    final_tx = db.high_watermark()
    assert final_tx == create_tx + writers * inserts
    prefix = np.zeros((2, NUM_LABELS), np.int64)
    at = {create_tx: {}}
    for tx in range(create_tx + 1, final_tx + 1):
        prefix = prefix + by_tx[tx]
        at[tx] = as_groups(prefix)
    seen.append((final_tx, final_tx, band_query(M, db, compiled)[0], None))
    for lo, hi, got, _path in seen:
        if not any(got == at[w] for w in range(lo, hi + 1)):
            errors.append(f"watermarks {lo}..{hi}: {got} is no prefix of the inserts")
    return errors, {p for *_x, p in seen if p is not None}, len(seen)


@pytest.mark.parametrize("new_values", [True, False], ids=["new-values", "known-values"])
@pytest.mark.parametrize("compiled", [True, False], ids=["compiled", "generic"])
def test_port_engine_readers_see_whole_inserts(compiled, new_values):
    errors, paths, n = readers_during_writes(PCC, compiled, new_values)
    assert not errors, errors[:3]
    assert paths == {"compiled" if compiled else "generic"} and n > 2


def test_jax_generic_readers_see_whole_inserts():
    # Known values only: the reference's dictionary is not safe for
    # concurrent first encodes (test_dictionary_first_encodes_get_one_code).
    errors, paths, _n = readers_during_writes(TCC, False, new_values=False)
    assert not errors, errors[:3]
    assert paths == {"generic"}


def merge_between_watermark_and_scan(M):
    """The compiled tier's read with a writer and the compactor scheduled
    between its watermark read and its part scan: one insert commits, then
    L0 compacts. Returns the query's groups, the serving tier and the
    groups of every insert at or below the watermark the query read."""
    db, table = new_table(M)
    rng = np.random.default_rng(3)
    total = np.zeros((2, NUM_LABELS), np.int64)
    for _ in range(3):
        batch, agg = label_batch(M, table, rng, 64)
        table.insert_record(batch)
        total += agg
    late, _agg = label_batch(M, table, rng, 64)
    collect = table.collect_parts
    hooked = []

    def interleaved(tx, *a, **kw):
        if not hooked:
            hooked.append(tx)
            table.insert_record(late)
            table.active_block.index.compact_level(0)
        return collect(tx, *a, **kw)

    table.collect_parts = interleaved
    got, path = band_query(M, db, True)
    assert hooked
    return got, path, as_groups(total)


@pytest.mark.divergence
def test_compiled_read_registers_its_view():
    got, path, want = merge_between_watermark_and_scan(PCC)
    assert path == "compiled"
    assert got == want
    # The reference's compiled tier reads the watermark without registering
    # a view: the merged part carries the late insert's tx, which its scan
    # cannot see, and the query returns no group at all.
    ref, ref_path, ref_want = merge_between_watermark_and_scan(TCC)
    assert ref_want == want and ref_path == "compiled"
    assert ref == {}


class _MissLetsAnotherThreadIn(dict):
    """A dictionary index whose first miss runs ``other`` on another
    thread, and waits up to half a second for it, before returning: the
    point where a thread without the dictionary's lock is preempted."""

    def __init__(self, other):
        super().__init__()
        self.other = other
        self.thread = None

    def get(self, key, default=None):
        out = super().get(key, default)
        if out is None and self.thread is None:
            self.thread = threading.Thread(target=self.other)
            self.thread.start()
            self.thread.join(timeout=0.5)
        return out


def first_encodes_interleaved(Dictionary):
    """The codes two threads get for one new value when the second
    encodes it between the first's index miss and its append."""
    d = Dictionary(use_native=False)
    codes = []
    d._index = _MissLetsAnotherThreadIn(lambda: codes.append(int(d.encode(["x"])[0][0])))
    codes.append(int(d.encode(["x"])[0][0]))
    d._index.thread.join()
    return sorted(codes), list(d.values)


@pytest.mark.divergence
def test_dictionary_first_encodes_get_one_code():
    from frostdb_tpu.columnbatch import Dictionary as JDictionary

    from frostdb_tpu_torch.columnbatch import Dictionary

    assert first_encodes_interleaved(Dictionary) == ([0, 0], ["x"])
    # The reference's dictionary takes no lock: the value gets two codes.
    assert first_encodes_interleaved(JDictionary) == ([0, 1], ["x", "x"])


@pytest.mark.parametrize("use_native", [True, False])
def test_dictionary_encodes_from_threads(use_native):
    """Eight threads encode the same 3000 new values in different orders:
    every value has one code, and each code maps back to its value."""
    from frostdb_tpu_torch.columnbatch import Dictionary

    vals = [f"v{i}" for i in range(3000)]
    for it in range(10):
        d = Dictionary(use_native=use_native)
        got = {}

        def encode(t):
            order = np.random.default_rng(it * 8 + t).permutation(len(vals))
            pairs = []
            for k in range(0, len(vals), 100):
                chunk = [vals[j] for j in order[k : k + 100]]
                pairs += zip(chunk, d.encode(chunk)[0].tolist())
            got[t] = pairs

        threads = [threading.Thread(target=encode, args=(t,)) for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        values = d.values
        assert len(values) == len(vals) and sorted(values) == sorted(vals)
        assert all(values[c] == s for pairs in got.values() for s, c in pairs)


def dictionaries_asked_at_once(M, T):
    """Whether two threads get one dictionary from ``table.dictionary``
    for a new family when the second asks while the first is making it
    (module M's package, its table module T)."""
    _db, table = new_table(M)
    made = T.Dictionary
    got = {}
    other = []

    def making(*a, **kw):
        if not other:
            other.append(threading.Thread(target=lambda: got.setdefault("second", table.dictionary("fresh"))))
            other[0].start()
            other[0].join(timeout=0.5)
        return made(*a, **kw)

    T.Dictionary = making
    try:
        got["first"] = table.dictionary("fresh")
    finally:
        T.Dictionary = made
    other[0].join()
    return got["first"] is got["second"] is table.dictionary("fresh")


@pytest.mark.divergence
def test_new_dictionary_is_shared_by_writers():
    import frostdb_tpu.table as jtable

    import frostdb_tpu_torch.table as ptable

    assert dictionaries_asked_at_once(PCC, ptable)
    # The reference stores each thread's new dictionary; the first thread's
    # codes then belong to a dictionary the table has dropped.
    assert not dictionaries_asked_at_once(TCC, jtable)


class _EvictionLetsAnotherThreadIn(dict):
    """A superpart cache whose first eviction (``pop``) runs ``other`` on
    another thread, and waits up to half a second for it, after the evicted
    key was chosen: the point where a thread without the cache's lock is
    preempted."""

    other = None
    thread = None

    def pop(self, *args):
        if self.thread is None:
            self.thread = threading.Thread(target=self.other)
            self.thread.start()
            self.thread.join(timeout=0.5)
        return super().pop(*args)


def evictions_interleaved(M, compiled_module):
    """Two threads' superparts of one table when the second evicts while
    the first is evicting: the part counts of both and the cache's size,
    or the error the first thread raised."""
    _db, table = new_table(M)
    rng = np.random.default_rng(4)
    for _ in range(3):
        table.insert_record(label_batch(M, table, rng, 64)[0])
    parts = table.collect_parts(_db.high_watermark())
    plan = object.__new__(compiled_module.CompiledFilterAggregate)
    plan.table = table
    cache = _EvictionLetsAnotherThreadIn({("old", i): None for i in range(4)})
    table._superpart_cache = cache
    got = {}

    def second():
        got["second"] = plan._superpart(parts[:1])["parts"]

    cache.other = second
    try:
        got["first"] = plan._superpart(parts)["parts"]
    except KeyError as e:
        return f"KeyError {e}"
    finally:
        if cache.thread is not None:
            cache.thread.join()
    return [len(got["first"]), len(got["second"]), len(cache)]


@pytest.mark.divergence
def test_superpart_cache_evicts_under_concurrent_queries():
    import frostdb_tpu.compiled as jcompiled

    import frostdb_tpu_torch.compiled as pcompiled

    assert evictions_interleaved(PCC, pcompiled) == [3, 1, 4]
    # The reference evicts unlocked: the second thread evicts the key the
    # first chose, and the first's pop raises.
    assert evictions_interleaved(TCC, jcompiled) == "KeyError ('old', 0)"
