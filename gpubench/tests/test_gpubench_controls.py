"""What decides ``correct`` has to fail: the controls put in the program's
place, and a whole run with the timed path broken underneath."""

import numpy as np
import pytest

import control
from cells import CELLS, run_cell


@pytest.mark.parametrize("workload", CELLS)
def test_stale_read_control_fails(workload):
    counts = control.control_counts(workload, 2**31 + 5, rows_per_profile=2, threads=2)
    assert counts["stale_read"] > 0, counts


def test_float32_control_fails_once_sums_pass_float32():
    # The configuration's values are 1 or 2, so its sums stay below 2^24
    # and float32 adds them exactly; with every value 2^24 + 1 a sum of
    # two passes it, and the control has to see it.
    from harness import datagen, judge, spec
    from reference import numpy_ref

    _b, _c, config, mix = spec.load_cell(control.HERE, "parca_profiles.merge")
    rows = datagen.generate(config, 2**31 + 6, 2)
    _name, _p, q = spec.Stream(mix, 6).next()
    assert judge.mismatch(numpy_ref.answer(q, rows), control.CONTROLS["float32_sums"](q, rows, None)) is None
    rows.columns["value"] = np.full(rows.n, 2**24 + 1, np.int64)
    assert judge.mismatch(numpy_ref.answer(q, rows), control.CONTROLS["float32_sums"](q, rows, None))


def alter_where_produced(monkeypatch):
    """Every serving tier's output altered in its first row: an int column
    off by one, any other made null."""
    from frostdb_tpu_torch import compiled, compiled_distinct, compiled_scan, schema_meta
    from frostdb_tpu_torch.parallel import mesh_exec

    def alter(batch):
        if batch.num_rows:
            col = batch.columns[-1]
            if col.dictionary is None and np.issubdtype(np.asarray(col.values).dtype, np.integer):
                col.values = np.array(col.values, copy=True)
                col.values[0] += 1
            else:
                col.validity = np.array(col.validity, copy=True)
                col.validity[0] = False
        return batch

    def wrap(module, name):
        lower = getattr(module, name)

        def lowered(plan, opts=None):
            prog = lower(plan, opts)
            if hasattr(prog, "execute_into"):
                inner = prog.execute_into
                prog.execute_into = lambda cb: inner(lambda b: cb(alter(b)))
            else:
                inner = prog.execute
                prog.execute = lambda: alter(inner())
            return prog

        monkeypatch.setattr(module, name, lowered)

    wrap(compiled, "lower_plan")
    wrap(compiled_distinct, "lower_plan_distinct")
    wrap(schema_meta, "lower_plan_schema")
    wrap(mesh_exec, "lower_plan_dense")
    wrap(compiled_scan, "lower_plan_scan")


def drop_half_the_inserts(monkeypatch):
    """Every second insert acknowledged and never stored."""
    from frostdb_tpu_torch.table import Table

    insert = Table.insert_record
    n = [0]

    def every_other(self, record, *a, **k):
        n[0] += 1
        return insert(self, record, *a, **k) if n[0] % 2 else 0

    monkeypatch.setattr(Table, "insert_record", every_other)


def replay_the_first_answer(monkeypatch):
    """Every query answered with the first answer the engine gave: state
    that never moves on."""
    from frostdb_tpu_torch.query.engine import LocalQueryBuilder

    execute = LocalQueryBuilder.execute
    first: list = []

    def stale(self, callback):
        if not first:
            execute(self, first.append)
            first.append(None)
        for b in first[:-1]:
            callback(b)

    monkeypatch.setattr(LocalQueryBuilder, "execute", stale)


@pytest.mark.parametrize("fault", [alter_where_produced, drop_half_the_inserts, replay_the_first_answer],
                         ids=["answer_altered", "half_the_rows_left_out", "state_unchanged"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_program_is_not_correct(capsys, monkeypatch, workload, fault):
    fault(monkeypatch)
    rc, res, err = run_cell(capsys, workload)
    assert rc == 0, err
    assert res["correct"] is False, err
    assert res["checks"]["wrong_answers"]["value"] > 0
