"""The port's device slot loop (``engine="scan"``) on the CPU.

``tests/test_scan_engine.py`` does not import on this tree (``repro``'s
scan engine needs ``jax.experimental.enable_x64``, which jax 0.9.0
removed), so the port's scan engine is held against the port's vector
engine, which ``tests/test_torch_main_path.py`` and
``tests/test_torch_dag.py`` hold against ``repro``'s vector engine, and,
through ``run()``, against ``repro.experiment.run`` on the vector engine.
Every comparison is exact: carbon, energy, completion, waits, violations
and every slot's log.

- all six native policies on DAG and independent weeks;
- tiles of mixed cells (policies, CI traces, job lists, start slots,
  capacities) equal to per-case runs, also when split into several tiles;
- delegation to the vector engine: non-native policies and subclasses of
  native ones; job lists whose ``k_min`` is not uniform run natively,
  through the variable-k fill;
- the gating semantics, the slot-step counts, and the default device,
  which raises without a card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.experiment import Scenario as RefScenario
from repro.experiment import run as ref_run
from repro.traces import DagConfig as RefDagConfig
from repro_torch.core import baselines, dag, scan_engine
from repro_torch.core.carbon import CarbonService
from repro_torch.core.simulator import SimCase, simulate, simulate_many
from repro_torch.core.types import ClusterConfig, Job
from repro_torch.experiment import Scenario, run
from repro_torch.traces import DagConfig, TraceSpec, generate_dag_trace, generate_trace

WEEK = 24 * 7
NATIVE = {
    "carbon-agnostic": baselines.CarbonAgnosticPolicy,
    "wait-awhile": baselines.WaitAwhilePolicy,
    "wait-awhile-robust": baselines.RobustWaitAwhilePolicy,
    "dag-fcfs": dag.DagFcfsPolicy,
    "dag-carbon": dag.DagCarbonPolicy,
    "dag-cap": dag.DagCapPolicy,
}


def _assert_identical(a, b, ctx):
    assert a.policy == b.policy, ctx
    assert a.carbon_g == b.carbon_g, ctx
    assert a.energy_kwh == b.energy_kwh, ctx
    np.testing.assert_array_equal(a.completion, b.completion, err_msg=ctx)
    np.testing.assert_array_equal(a.violations, b.violations, err_msg=ctx)
    np.testing.assert_array_equal(a.wait_slots, b.wait_slots, err_msg=ctx)
    assert [vars(x) for x in a.slots] == [vars(y) for y in b.slots], ctx


def _world(seed, independent=False, capacity=10, k_min=1):
    cluster = ClusterConfig.default(capacity)
    ci = CarbonService.synthetic("germany", WEEK * 2 + 24 * 30, seed=seed)
    spec = TraceSpec(family="azure", hours=WEEK, capacity=capacity,
                     utilization=0.6, seed=seed + 1, k_min=k_min)
    jobs = generate_dag_trace(spec, DagConfig(width=3, depth=4,
                                              independent=independent),
                              cluster.queues)
    return cluster, ci, jobs


def _scan(jobs, ci, cluster, policy, **kw):
    return simulate(jobs, ci, cluster, policy, engine="scan", device="cpu", **kw)


@pytest.mark.parametrize("name", sorted(NATIVE))
@pytest.mark.parametrize("independent", [False, True], ids=["dag", "independent"])
def test_native_policies_equal_vector_engine(name, independent):
    cluster, ci, jobs = _world(11, independent)
    want = simulate(jobs, ci, cluster, NATIVE[name](), horizon=WEEK)
    scan_engine.reset_stats()
    got = _scan(jobs, ci, cluster, NATIVE[name](), horizon=WEEK)
    _assert_identical(want, got, f"{name} independent={independent}")
    assert (got.completion >= 0).all()
    assert scan_engine.stats["delegated"] == 0
    assert scan_engine.stats["steps"] >= WEEK
    # the gating runs exactly when the job list has edges
    want_dag = 0 if independent else scan_engine.stats["steps"]
    assert scan_engine.stats["dag_steps"] == want_dag


@pytest.mark.parametrize("name", ["wait-awhile", "dag-cap"])
def test_start_slot_and_overrun_cut_equal_vector_engine(name):
    """A window that starts mid-trace, and one whose overrun budget ends
    the run before every job finished."""
    cluster, ci, jobs = _world(5, capacity=6)
    shifted = [dataclasses.replace(j, arrival=j.arrival + 30) for j in jobs]
    for kw in (dict(t0=30, horizon=WEEK), dict(horizon=WEEK, max_overrun=3)):
        sj = shifted if kw.get("t0") else jobs
        want = simulate(sj, ci, cluster, NATIVE[name](), **kw)
        got = _scan(sj, ci, cluster, NATIVE[name](), **kw)
        _assert_identical(want, got, f"{name} {kw}")


def test_mixed_tiles_equal_per_case_runs(monkeypatch):
    """One simulate_many call over cells that differ in policy, CI trace,
    job list, start slot and capacity: each equals its own scan run and
    the vector engine; cells of one structure share batched programs."""
    worlds = [_world(s, independent=s % 2 == 1, capacity=8 + s % 3)
              for s in range(4)]
    cases = []
    for w, (cluster, ci, jobs) in enumerate(worlds):
        for s, name in enumerate(("dag-carbon", "wait-awhile", "dag-cap",
                                  "carbon-agnostic", "dag-carbon")):
            trace = CarbonService.synthetic(
                ("germany", "california", "ontario")[s % 3],
                WEEK * 2 + 24 * 30, seed=w * 10 + s)
            cases.append(SimCase(jobs=jobs, ci=trace if s else ci,
                                 cluster=cluster, policy=NATIVE[name](),
                                 horizon=WEEK, t0=0, engine="scan",
                                 device="cpu"))
    cases.append(SimCase(jobs=worlds[0][2], ci=worlds[0][1],
                         cluster=worlds[0][0], policy=dag.DagCarbonPolicy(),
                         horizon=WEEK, t0=30, engine="scan", device="cpu"))
    cases.append(SimCase(jobs=worlds[0][2], ci=worlds[0][1],
                         cluster=worlds[0][0], policy=baselines.GaiaPolicy(),
                         horizon=WEEK, engine="scan", device="cpu"))
    scan_engine.reset_stats()
    batched = simulate_many(cases)
    tiled = dict(scan_engine.stats)
    assert tiled["delegated"] == 1
    assert tiled["cell_steps"] > tiled["steps"]        # some tiles hold > 1 cell
    monkeypatch.setattr(scan_engine, "BATCH_TILE", 2)
    split = simulate_many(cases)
    for i, (case, r) in enumerate(zip(cases, batched)):
        solo = simulate(case.jobs, case.ci, case.cluster,
                        type(case.policy)(), t0=case.t0, horizon=WEEK,
                        engine="scan", device="cpu")
        vec = simulate(case.jobs, case.ci, case.cluster, type(case.policy)(),
                       t0=case.t0, horizon=WEEK)
        _assert_identical(solo, r, f"case {i} tile vs solo")
        _assert_identical(vec, r, f"case {i} tile vs vector")
        _assert_identical(split[i], r, f"case {i} split tiles")


def test_dag_tile_releases_once_per_step(monkeypatch):
    """Four dag-carbon cells of one DAG week (four CI traces) as one batched
    program: the release goes through ``gating.dep_release_csr`` once per
    slot step, on (4, n_pad) tensors, and every cell equals its vector
    engine run."""
    cluster, _, jobs = _world(13, capacity=7)
    cases = [SimCase(jobs=jobs, ci=CarbonService.synthetic("ontario", WEEK * 2 + 24 * 30,
                                                            seed=s),
                     cluster=cluster, policy=dag.DagCarbonPolicy(), horizon=WEEK,
                     engine="scan", device="cpu") for s in range(4)]
    shapes = []
    release = scan_engine.gating.dep_release_csr

    def counted(fin, arrived, pred_left, graph):
        shapes.append(tuple(fin.shape))
        return release(fin, arrived, pred_left, graph)

    monkeypatch.setattr(scan_engine.gating, "dep_release_csr", counted)
    scan_engine.reset_stats()
    got = simulate_many(cases)
    steps = dict(scan_engine.stats)
    assert len(shapes) == steps["dag_steps"] == steps["steps"] >= WEEK
    assert steps["cell_steps"] == 4 * steps["steps"]
    assert set(shapes) == {(4, scan_engine._pad_rows(len(jobs)))}
    for i, (case, r) in enumerate(zip(cases, got)):
        want = simulate(case.jobs, case.ci, case.cluster, dag.DagCarbonPolicy(),
                        horizon=WEEK)
        _assert_identical(want, r, f"cell {i}")


@dataclasses.dataclass
class _Subclass(baselines.WaitAwhilePolicy):
    name: str = "wait-awhile-subclass"


def test_delegation_of_non_native_policies():
    cluster, ci, jobs = _world(2, independent=True)
    for policy_cls in (baselines.GaiaPolicy, baselines.CarbonScalerPolicy,
                       _Subclass):
        assert scan_engine.native_kind(policy_cls()) is None
        scan_engine.reset_stats()
        got = _scan(jobs, ci, cluster, policy_cls(), horizon=WEEK)
        assert scan_engine.stats["delegated"] == 1
        assert scan_engine.stats["steps"] == 0
        _assert_identical(simulate(jobs, ci, cluster, policy_cls(), horizon=WEEK),
                          got, policy_cls.__name__)


def test_delegation_of_non_uniform_k_min():
    """The reference fills rows one by one where k_min differs between
    jobs; the port runs such job lists natively, through the variable-k
    fill (``kernels/fill.py``) every slot step, none delegated."""
    cluster = ClusterConfig.default(12)
    ci = CarbonService.synthetic("germany", WEEK + 24 * 30, seed=3)
    jobs = generate_trace(TraceSpec(hours=WEEK, capacity=12, seed=4, k_min=1),
                          cluster.queues)
    jobs = [dataclasses.replace(j, k_min=2 if j.job_id % 3 == 0 else 1)
            for j in jobs]
    for name in ("carbon-agnostic", "wait-awhile"):
        scan_engine.reset_stats()
        got = _scan(jobs, ci, cluster, NATIVE[name](), horizon=WEEK)
        assert scan_engine.stats["delegated"] == 0
        assert scan_engine.stats["fill_steps"] == scan_engine.stats["steps"] > 0
        _assert_identical(simulate(jobs, ci, cluster, NATIVE[name](), horizon=WEEK),
                          got, name)
    # a uniform k_min above 1 stays native
    jobs2 = [dataclasses.replace(j, k_min=2) for j in jobs]
    scan_engine.reset_stats()
    got = _scan(jobs2, ci, cluster, baselines.WaitAwhilePolicy(), horizon=WEEK)
    assert scan_engine.stats["delegated"] == 0 and scan_engine.stats["steps"] > 0
    assert scan_engine.stats["fill_steps"] == 0
    _assert_identical(simulate(jobs2, ci, cluster, baselines.WaitAwhilePolicy(),
                               horizon=WEEK), got, "k_min=2")


def _mk_job(jid, length, deps=()):
    return Job(job_id=jid, arrival=0, length=length, queue=0, delay=6,
               profile=np.ones(1), deps=deps)


def test_gating_semantics_and_rejections():
    ci = CarbonService(trace=np.full(24 * 10, 100.0))
    cluster = ClusterConfig.default(8)
    r = _scan([_mk_job(0, 3.0), _mk_job(1, 2.0, deps=(0,)),
               _mk_job(2, 1.0, deps=(1,))], ci, cluster, dag.DagFcfsPolicy(),
              horizon=48)
    np.testing.assert_array_equal(r.completion, [2, 4, 5])
    r = _scan([_mk_job(0, 10.0), _mk_job(1, 1.0, deps=(0,))], ci, cluster,
              dag.DagFcfsPolicy(), horizon=48)
    np.testing.assert_array_equal(r.completion, [9, 10])
    assert r.wait_slots[1] == 0.0 and not r.violations[1]
    for jobs, match in (([_mk_job(0, 1.0, deps=(99,))], "submitted"),
                        ([_mk_job(0, 1.0, deps=(1,)), _mk_job(1, 1.0, deps=(0,))],
                         "cycle"),
                        ([_mk_job(0, 1.0, deps=(0,))], "itself")):
        with pytest.raises(ValueError, match=match):
            _scan(jobs, ci, cluster, dag.DagFcfsPolicy(), horizon=24)


def test_empty_job_list():
    ci = CarbonService(trace=np.full(48, 100.0))
    r = _scan([], ci, ClusterConfig.default(8), dag.DagFcfsPolicy(), horizon=24)
    want = simulate([], ci, ClusterConfig.default(8), dag.DagFcfsPolicy(), horizon=24)
    _assert_identical(want, r, "empty")


def test_run_dag_scenario_on_scan_equals_reference():
    kw = dict(capacity=12, learn_weeks=1, seed=7)
    scan_engine.reset_stats()
    got = run(Scenario(dag=DagConfig(), engine="scan", **kw), device="cpu")
    steps = dict(scan_engine.stats)
    ref = ref_run(RefScenario(dag=RefDagConfig(), engine="vector", **kw))
    assert got.policies == ref.policies == ("dag-fcfs", "dag-carbon", "dag-cap")
    for name in got.policies:
        for a, b in zip(ref.weekly[name], got.weekly[name], strict=True):
            _assert_identical(a, b, name)
    assert got.table() == ref.table()
    # one program per policy, each through the gating every slot
    assert steps["dag_steps"] == steps["steps"] == steps["cell_steps"] >= 3 * WEEK
    twin = run(Scenario(dag=DagConfig(independent=True), engine="scan", **kw),
               device="cpu")
    ref_twin = ref_run(RefScenario(dag=RefDagConfig(independent=True), **kw))
    for name in twin.policies:
        for a, b in zip(ref_twin.weekly[name], twin.weekly[name], strict=True):
            _assert_identical(a, b, f"independent {name}")


def test_run_independent_scenario_on_scan_equals_reference():
    kw = dict(capacity=8, learn_weeks=1, family="alibaba", seed=101)
    names = ["carbon-agnostic", "wait-awhile", "wait-awhile-robust", "carbonflex"]
    got = run(Scenario(engine="scan", **kw), names, device="cpu")
    ref = ref_run(RefScenario(**kw), names)
    for name in names:
        for a, b in zip(ref.weekly[name], got.weekly[name], strict=True):
            _assert_identical(a, b, name)


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cluster, ci, jobs = _world(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate(jobs, ci, cluster, dag.DagFcfsPolicy(), horizon=WEEK,
                 engine="scan")
    with pytest.raises(RuntimeError, match="CUDA"):       # delegated, too
        simulate(jobs, ci, cluster, baselines.GaiaPolicy(), horizon=WEEK,
                 engine="scan")
    with pytest.raises(RuntimeError, match="CUDA"):
        run(Scenario(dag=DagConfig(), engine="scan", capacity=8, learn_weeks=1))
