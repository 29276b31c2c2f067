"""The port's exact float64 sum decomposition (frostdb_tpu_torch/floatsum.py)
against the JAX package's on the same values. Every digit plane is an
integer and must be equal; the recombined sums must equal the exact sum."""

import math
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frostdb_tpu import floatsum as JFS
from frostdb_tpu_torch import floatsum as PFS


def _values(case):
    rng = np.random.default_rng(3)
    if case == "mixed_scale":
        return rng.standard_normal(4000) * 10.0 ** rng.integers(-2, 4, 4000)
    if case == "integral":
        return rng.integers(-(2**40), 2**40, 4000).astype(np.float64)
    if case == "zeros_and_halves":
        return np.where(rng.random(4000) < 0.3, 0.0, rng.integers(-9, 9, 4000) / 2)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["mixed_scale", "integral", "zeros_and_halves"])
def test_decompose_dev_matches_jax_and_host(case):
    v = _values(case)
    plan = PFS.make_plan([PFS.column_meta(v)], len(v))
    jplan = JFS.make_plan([JFS.column_meta(v)], len(v))
    assert plan is not None
    assert (plan.scale, plan.top_min, plan.top_max) == (
        jplan.scale, jplan.top_min, jplan.top_max
    )
    port = [t.numpy() for t in PFS.decompose_dev(torch.from_numpy(v), plan)]
    ref = [np.asarray(a) for a in JFS.decompose_dev(jnp.asarray(v), jplan)]
    host = PFS.decompose_np(v, plan)
    for p, r, h in zip(port, ref, host):
        np.testing.assert_array_equal(p, r)
        np.testing.assert_array_equal(p, h)
    # Two groups: the recombined sums are the exact sums, rounded once.
    g = np.arange(len(v)) % 2
    sums = [np.array([p[g == k].sum() for k in (0, 1)]) for p in port]
    got = PFS.recombine(sums, plan)
    for k in (0, 1):
        exact = sum(Fraction(float(x)) for x in v[g == k])
        assert got[k] == float(exact)
        assert math.isfinite(got[k])
