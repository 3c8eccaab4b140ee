"""The PyTorch port's oracle and learning phase match the JAX package's.

``repro_torch.core.oracle.solve`` must equal ``repro``'s
``solve(backend="numpy")`` exactly — allocation, capacity curve, rho curve,
work done, deadline extensions — and ``learn_window`` must store the same
Table-2 states and decisions in the knowledge base.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import oracle as ref_oracle
from repro.core.knowledge import KnowledgeBase as RefKB
from repro.core.policy import learn_window as ref_learn_window
from repro.experiment import Scenario as RefScenario
from repro_torch.core import oracle
from repro_torch.core.knowledge import KnowledgeBase
from repro_torch.core.policy import learn_window
from repro_torch.experiment import Scenario

WEEK = 24 * 7
BASE = dict(capacity=8, learn_weeks=1, family="alibaba", seed=101)


def _window(mat, s0, horizon):
    return [dataclasses.replace(j, arrival=j.arrival - s0)
            for j in mat.jobs if s0 <= j.arrival < s0 + horizon]


@pytest.mark.parametrize("capacity,horizon,s0", [
    (8, WEEK, 0),          # a learning-phase replay window
    (8, 2 * WEEK, WEEK),   # the oracle policy's longer span
    (3, WEEK, 0),          # overloaded: deadline extensions kick in
])
def test_solve_matches_reference(capacity, horizon, s0):
    ref_mat = RefScenario(**{**BASE, "eval_weeks": 2}).materialize()
    mat = Scenario(**{**BASE, "eval_weeks": 2}).materialize()
    ci = mat.ci.trace[s0:s0 + horizon]
    ref = ref_oracle.solve(_window(ref_mat, s0, horizon),
                           ref_mat.ci.trace[s0:s0 + horizon], capacity,
                           horizon=horizon, backend="numpy")
    res = oracle.solve(_window(mat, s0, horizon), ci, capacity,
                       horizon=horizon)
    for name in ("capacity_curve", "rho_curve", "work_done"):
        a, b = getattr(ref, name), getattr(res, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(ref.schedule.alloc, res.schedule.alloc)
    np.testing.assert_array_equal(ref.schedule.extended, res.schedule.extended)
    assert ref.schedule.feasible == res.schedule.feasible
    assert [j.delay for j in ref.schedule.jobs] == \
        [j.delay for j in res.schedule.jobs]
    if capacity == 3:
        assert res.schedule.extended.any()


def test_build_entries_order_matches_reference():
    ref_mat = RefScenario(**BASE).materialize()
    mat = Scenario(**BASE).materialize()
    a = ref_oracle._build_entries(_window(ref_mat, 0, WEEK),
                                  ref_mat.ci.trace[:WEEK], WEEK)
    b = oracle._build_entries(_window(mat, 0, WEEK), mat.ci.trace[:WEEK], WEEK)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_empty_window():
    res = oracle.solve([], np.full(10, 100.0), 4)
    assert res.schedule.alloc.shape == (0, 10)
    np.testing.assert_array_equal(res.rho_curve, np.ones(10))


def test_learn_window_stores_reference_cases():
    """Two learning weeks replayed at two offsets: the windows the port's
    base stores equal the reference base's bit for bit."""
    sc = dict(BASE, learn_weeks=2)
    ref_mat = RefScenario(**sc).materialize()
    mat = Scenario(**sc).materialize()
    ref_kb = RefKB(backend="numpy")
    kb = KnowledgeBase(device="cpu")
    ro = ref_learn_window(ref_kb, ref_mat.hist, ref_mat.ci, 0, WEEK,
                          ref_mat.cluster, offsets=(0, WEEK, 5 * WEEK))
    po = learn_window(kb, mat.hist, mat.ci, 0, WEEK, mat.cluster,
                      offsets=(0, WEEK, 5 * WEEK))
    assert (po.contributed, po.empty) == (ro.contributed, ro.empty) \
        == ((0, WEEK), (5 * WEEK,))
    assert len(kb._windows) == len(ref_kb._windows) == 2
    for (rs, ry), (s, y) in zip(ref_kb._windows, kb._windows):
        np.testing.assert_array_equal(rs, s)
        np.testing.assert_array_equal(ry, y)
    assert len(kb) == len(ref_kb) == 2 * WEEK
    np.testing.assert_array_equal(kb.rho_values(), ref_kb.rho_values())
