"""DAG workloads of the PyTorch port against the JAX package.

- the ``DagSpec``/``TaskNode`` model, the shape builders, ``expand_dags``
  and ``criticality_from_jobs`` equal to ``repro.core.dag`` on the same
  inputs (the layered builder from the same numpy seed);
- ``Scenario(dag=...)`` worlds equal to ``repro``'s, job for job, for each
  shape and for the ``independent=True`` twin;
- the port's vector and scalar engines equal to ``repro``'s vector engine
  on DAG weeks for the three DAG policies, bit for bit (carbon, energy,
  completion, waits, violations and every slot's log), and the gating
  semantics and rejections of both engines;
- the registry's dag/non-dag rejections and the driver's DAG defaults.

Every comparison is exact: the DAG model is integer and float64 host code,
ported op for op.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import dag as ref_dag
from repro.core.simulator import simulate as ref_simulate
from repro.experiment import Scenario as RefScenario
from repro.experiment import run as ref_run
from repro.traces import DagConfig as RefDagConfig
from repro.traces import TraceSpec as RefTraceSpec
from repro.traces import generate_dag_specs as ref_generate_dag_specs
from repro_torch.core import dag
from repro_torch.core.carbon import CarbonService
from repro_torch.core.simulator import simulate
from repro_torch.core.types import ClusterConfig, Job
from repro_torch.experiment import (DEFAULT_DAG_POLICIES, Scenario, make_policy,
                                    prepare_context, run)
from repro_torch.traces import (DagConfig, TraceSpec, dag_mean_task_length,
                                generate_dag_specs)

WEEK = 24 * 7
POLICIES = ("dag-fcfs", "dag-carbon", "dag-cap")
_MK = {"dag-fcfs": dag.DagFcfsPolicy, "dag-carbon": dag.DagCarbonPolicy,
       "dag-cap": dag.DagCapPolicy}
_REF_MK = {"dag-fcfs": ref_dag.DagFcfsPolicy, "dag-carbon": ref_dag.DagCarbonPolicy,
           "dag-cap": ref_dag.DagCapPolicy}


def _job_tuple(j):
    return (j.job_id, j.arrival, j.length, j.queue, j.delay, tuple(j.profile),
            j.k_min, j.power, j.comm_size, j.arch, tuple(j.deps))


def _task_tuple(t):
    return (t.length, tuple(t.deps), tuple(t.profile), t.k_min, t.power,
            t.comm_size, t.name)


def _to_ref_jobs(jobs):
    from repro.core.types import Job as RefJob
    return [RefJob(**{f.name: getattr(j, f.name) for f in dataclasses.fields(j)})
            for j in jobs]


# --- model and builders ------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_builders_equal_reference(seed):
    rng_a, rng_b = np.random.default_rng(seed), np.random.default_rng(seed)
    lens = list(np.random.default_rng(seed + 10).uniform(1, 9, 12))
    pairs = [
        (dag.chain_tasks(lens[:4]), ref_dag.chain_tasks(lens[:4])),
        (dag.map_reduce_tasks(lens[0], lens[1:5], lens[5]),
         ref_dag.map_reduce_tasks(lens[0], lens[1:5], lens[5])),
        (dag.layered_tasks([2, 3, 4, 3], lens, rng_a, max_parents=2),
         ref_dag.layered_tasks([2, 3, 4, 3], lens, rng_b, max_parents=2)),
    ]
    for mine, ref in pairs:
        assert [_task_tuple(t) for t in mine] == [_task_tuple(t) for t in ref]
        a = dag.DagSpec(dag_id=seed, arrival=3, tasks=mine)
        b = ref_dag.DagSpec(dag_id=seed, arrival=3, tasks=ref)
        assert (a.n_tasks, a.total_work(), a.edges(), a.depth(),
                a.critical_path_length()) == (
            b.n_tasks, b.total_work(), b.edges(), b.depth(),
            b.critical_path_length())


def test_model_validation_matches_reference():
    for mod in (dag, ref_dag):
        with pytest.raises(ValueError, match="topological order"):
            mod.DagSpec(dag_id=0, arrival=0,
                        tasks=(mod.TaskNode(1.0), mod.TaskNode(1.0, deps=(1,))))
        with pytest.raises(ValueError, match=">= 1 task"):
            mod.DagSpec(dag_id=0, arrival=0, tasks=())
        with pytest.raises(ValueError, match=">= 1 mapper"):
            mod.map_reduce_tasks(1.0, [], 1.0)
        with pytest.raises(ValueError, match="lengths"):
            mod.layered_tasks([2, 2], [1.0] * 3, np.random.default_rng(0))
        with pytest.raises(ValueError, match=">= 1"):
            mod.layered_tasks([2, 0], [1.0] * 2, np.random.default_rng(0))
    for cfg in (DagConfig, RefDagConfig):
        with pytest.raises(ValueError, match="shapes"):
            cfg(shapes=("chain", "ring"))
        with pytest.raises(ValueError, match="width"):
            cfg(width=1)


@pytest.mark.parametrize("independent", [False, True])
def test_expand_and_criticality_equal_reference(independent):
    spec = TraceSpec(hours=72, capacity=12, seed=5)
    queues = ClusterConfig.default(12).queues
    specs = generate_dag_specs(spec, DagConfig())
    ref_specs = ref_generate_dag_specs(RefTraceSpec(hours=72, capacity=12, seed=5),
                                       RefDagConfig())
    jobs = dag.expand_dags(specs, queues, id_base=10, independent=independent)
    ref_jobs = ref_dag.expand_dags(ref_specs, queues, id_base=10,
                                   independent=independent)
    assert [_job_tuple(j) for j in jobs] == [_job_tuple(j) for j in ref_jobs]
    assert dag.criticality_from_jobs(jobs) == ref_dag.criticality_from_jobs(ref_jobs)


def test_criticality_diamond_and_cycle():
    def job(jid, length, deps=()):
        return Job(job_id=jid, arrival=0, length=length, queue=0, delay=6,
                   profile=np.ones(1), deps=deps)

    diamond = [job(0, 1.0), job(1, 5.0, (0,)), job(2, 1.0, (0,)),
               job(3, 1.0, (1, 2)), job(4, 2.0)]
    got = dag.criticality_from_jobs(diamond)
    assert got == ref_dag.criticality_from_jobs(_to_ref_jobs(diamond))
    assert got == {0: True, 1: True, 2: False, 3: True, 4: True}
    with pytest.raises(ValueError, match="cycle"):
        dag.criticality_from_jobs([job(0, 1.0, (1,)), job(1, 1.0, (0,))])


# --- worlds ------------------------------------------------------------------


WORLDS = [
    pytest.param(dict(), id="all-shapes"),
    pytest.param(dict(shapes=("chain",)), id="chain"),
    pytest.param(dict(shapes=("mapreduce",), width=5), id="mapreduce"),
    pytest.param(dict(shapes=("layered",), depth=4, max_parents=2), id="layered"),
    pytest.param(dict(independent=True), id="independent"),
]


@pytest.mark.parametrize("cfg", WORLDS)
def test_scenario_worlds_equal_reference(cfg):
    kw = dict(capacity=14, learn_weeks=1, seed=4, family="alibaba")
    mat = Scenario(dag=DagConfig(**cfg), **kw).materialize()
    ref = RefScenario(dag=RefDagConfig(**cfg), **kw).materialize()
    for mine, theirs in ((mat.jobs, ref.jobs), (mat.hist, ref.hist),
                         (mat.eval_jobs, ref.eval_jobs)):
        assert [_job_tuple(j) for j in mine] == [_job_tuple(j) for j in theirs]
    assert mat.mean_length == ref.mean_length == dag_mean_task_length(DagConfig(**cfg))
    assert mat.scenario.is_dag
    assert any(j.deps for j in mat.eval_jobs) != cfg.get("independent", False)


# --- engines -----------------------------------------------------------------


def _assert_identical(a, b, ctx):
    assert a.carbon_g == b.carbon_g, ctx
    assert a.energy_kwh == b.energy_kwh, ctx
    np.testing.assert_array_equal(a.completion, b.completion, err_msg=ctx)
    np.testing.assert_array_equal(a.violations, b.violations, err_msg=ctx)
    np.testing.assert_array_equal(a.wait_slots, b.wait_slots, err_msg=ctx)
    assert [vars(x) for x in a.slots] == [vars(y) for y in b.slots], ctx


def _dag_week(seed, **cfg):
    kw = dict(capacity=10, learn_weeks=1, seed=seed, family="azure")
    mat = Scenario(dag=DagConfig(**cfg), **kw).materialize()
    ref = RefScenario(dag=RefDagConfig(**cfg), **kw).materialize()
    return mat, ref


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("seed", [3, 8])
def test_host_engines_equal_reference_vector(policy, seed):
    mat, ref = _dag_week(seed, width=3, depth=4)
    want = ref_simulate(ref.eval_week(0), ref.ci, ref.cluster, _REF_MK[policy](),
                        t0=ref.t0, horizon=WEEK, engine="vector")
    assert (want.completion >= 0).all()
    for engine in ("vector", "scalar"):
        got = simulate(mat.eval_week(0), mat.ci, mat.cluster, _MK[policy](),
                       t0=mat.t0, horizon=WEEK, engine=engine)
        _assert_identical(want, got, f"{policy} seed={seed} {engine}")


def _mk_job(jid, length, deps=(), arrival=0, delay=6):
    return Job(job_id=jid, arrival=arrival, length=length, queue=0,
               delay=delay, profile=np.ones(1), deps=deps)


@pytest.mark.parametrize("engine", ["scalar", "vector"])
class TestGatingSemantics:
    def test_chain_serialises(self, engine):
        ci = CarbonService(trace=np.full(24 * 10, 100.0))
        jobs = [_mk_job(0, 3.0), _mk_job(1, 2.0, deps=(0,)),
                _mk_job(2, 1.0, deps=(1,))]
        r = simulate(jobs, ci, ClusterConfig.default(8), dag.DagFcfsPolicy(),
                     horizon=48, engine=engine)
        np.testing.assert_array_equal(r.completion, [2, 4, 5])
        np.testing.assert_array_equal(r.wait_slots, [0.0, 0.0, 0.0])
        assert not r.violations.any()

    def test_deadline_counts_from_release(self, engine):
        ci = CarbonService(trace=np.full(24 * 10, 100.0))
        jobs = [_mk_job(0, 10.0), _mk_job(1, 1.0, deps=(0,))]
        r = simulate(jobs, ci, ClusterConfig.default(8), dag.DagFcfsPolicy(),
                     horizon=48, engine=engine)
        np.testing.assert_array_equal(r.completion, [9, 10])
        assert r.wait_slots[1] == 0.0 and not r.violations[1]
        assert r.completion[1] > jobs[1].deadline

    @pytest.mark.parametrize("jobs,match", [
        ([_mk_job(0, 1.0, deps=(99,))], "submitted"),
        ([_mk_job(0, 1.0, deps=(1,)), _mk_job(1, 1.0, deps=(0,))], "cycle"),
        ([_mk_job(0, 1.0, deps=(0,))], "itself"),
    ])
    def test_bad_graphs_rejected(self, engine, jobs, match):
        ci = CarbonService(trace=np.full(48, 100.0))
        with pytest.raises(ValueError, match=match):
            simulate(jobs, ci, ClusterConfig.default(8), dag.DagFcfsPolicy(),
                     horizon=24, engine=engine)


@dataclasses.dataclass
class _EvilPackedPolicy:
    """Allocates k_min to every row, gated ones included, through both
    protocols; the engines must trim the gated rows."""

    name: str = "evil"

    def on_window_start(self, ci, t0, horizon, jobs, cluster) -> None:
        self._jobs = jobs

    def decide(self, t, active, ci, cluster):
        return cluster.capacity, {j.job_id: j.k_min for j in self._jobs}

    def decide_packed(self, t, eng, ci, cluster):
        return cluster.capacity, eng.packed.k_min.copy()

    def on_completion(self, t, job, violated) -> None:
        pass


def test_gated_rows_never_run_even_if_policy_allocates_them():
    ci = CarbonService(trace=np.full(24 * 10, 100.0))
    jobs = [_mk_job(0, 3.0), _mk_job(1, 2.0, deps=(0,)),
            _mk_job(2, 1.0, deps=(1,))]
    rs = simulate(jobs, ci, ClusterConfig.default(8), _EvilPackedPolicy(),
                  horizon=48, engine="scalar")
    rv = simulate(jobs, ci, ClusterConfig.default(8), _EvilPackedPolicy(),
                  horizon=48, engine="vector")
    np.testing.assert_array_equal(rs.completion, [2, 4, 5])
    _assert_identical(rs, rv, "evil")


# --- experiment API ----------------------------------------------------------


TINY_DAG = dict(capacity=10, learn_weeks=1, seed=3, family="alibaba")


def test_policy_family_rejection_both_ways():
    with pytest.raises(ValueError, match="precedence-aware"):
        run(Scenario(capacity=8, learn_weeks=1), ["dag-cap"], device="cpu")
    with pytest.raises(ValueError, match="independent"):
        run(Scenario(dag=DagConfig(), **TINY_DAG), ["carbon-agnostic"],
            device="cpu")
    with pytest.raises(ValueError, match="registered policies"):
        run(Scenario(dag=DagConfig(), **TINY_DAG), ["dag-mpc"], device="cpu")


def test_driver_defaults_to_dag_set_and_matches_reference():
    res = run(Scenario(dag=DagConfig(width=3, depth=3), **TINY_DAG), device="cpu")
    ref = ref_run(RefScenario(dag=RefDagConfig(width=3, depth=3), **TINY_DAG))
    assert res.policies == DEFAULT_DAG_POLICIES == ref.policies
    assert res.metrics() == ref.metrics()          # savings against dag-fcfs
    assert res.table() == ref.table()
    assert res.savings("dag-carbon") > 0 and res.savings("dag-cap") > 0
    mat = Scenario(dag=DagConfig(), **TINY_DAG).materialize()
    ctx = prepare_context(mat, DEFAULT_DAG_POLICIES, device="cpu")
    assert make_policy("dag-cap", ctx).name == "dag-cap"
