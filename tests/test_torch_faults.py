"""The port's resilience layer (``core/faults.py``, carbon-feed outages,
``SimResult.resilience``) against the JAX package.

The same seeds build the same worlds in both packages, and every result is
compared exactly:

- each fault process of ``tests/test_resilience.py``'s grid (iid,
  correlated, preemption; seeds 2 and 9), and the legacy ``draw_factors``
  adapter, driven slot by slot over one job stream: the ``SlotDisturbance``
  sequence, the capacities it reports and ``run_metrics``;
- ``DegradedCIView`` (staleness, observed CI, the staged forecasts, the
  quantile band, the re-fetch schedule) and ``DegradedMultiRegionView``;
- the dict round trips, ``fault_label`` and the validation messages;
- every fault kind on single-region, DAG and geo worlds through the port's
  scalar, vector and scan engines against ``repro``'s vector engine
  (``resilience`` included); an outage world on every native kind of the
  scan engine, run natively (``stats``), and outage plus faults composed;
- ``Scenario``'s JSON with ``faults`` and ``ci_outage``, the reference's
  fault-axis sweep and a smaller copy of its chaos grid, byte for byte.

The reference's scan engine cannot run on this tree, so its vector engine
is the reference for the port's scan engine.
"""
import dataclasses
import json

import numpy as np
import pytest

from repro.core import baselines as ref_baselines
from repro.core import faults as ref_faults
from repro.core import simulate as ref_simulate
from repro.core.carbon import CarbonService as RefCarbonService
from repro.core.carbon import MultiRegionCarbonService as RefMRCS
from repro.core.dag import DagCarbonPolicy as RefDagCarbonPolicy
from repro.core.dag import DagFcfsPolicy as RefDagFcfsPolicy
from repro.core.forecast import QuantileForecast as RefQuantileForecast
from repro.core.geo import GeoFlexPolicy as RefGeoFlexPolicy
from repro.core.geo import GeoStaticPolicy as RefGeoStaticPolicy
from repro.core.mpc import MPCConfig as RefMPCConfig
from repro.core.types import ClusterConfig as RefClusterConfig
from repro.core.types import GeoCluster as RefGeoCluster
from repro.experiment import Scenario as RefScenario
from repro.experiment import Sweep as RefSweep
from repro.experiment import run as ref_run
from repro.traces import DagConfig as RefDagConfig
from repro.traces import TraceSpec as RefTraceSpec
from repro.traces import generate_dag_trace as ref_generate_dag_trace
from repro.traces import generate_trace as ref_generate_trace
from repro_torch.core import baselines, faults, scan_engine
from repro_torch.core.carbon import CarbonService, MultiRegionCarbonService
from repro_torch.core.dag import DagCarbonPolicy, DagFcfsPolicy
from repro_torch.core.forecast import QuantileForecast
from repro_torch.core.geo import GeoFlexPolicy, GeoStaticPolicy
from repro_torch.core.mpc import MPCConfig
from repro_torch.core.simulator import simulate
from repro_torch.core.types import ClusterConfig, GeoCluster
from repro_torch.experiment import Scenario, Sweep, run
from repro_torch.experiment import sweep as sweep_mod
from repro_torch.traces import DagConfig, TraceSpec, generate_dag_trace, generate_trace

WEEK = 24 * 7
CAP = 12
REGIONS2 = ("south-australia", "ontario")
SEEDS = (2, 9)


def _fault_grid(pkg):
    """``tests/test_resilience.py::_fault_grid`` in either package."""
    return {
        "iid": lambda s: pkg.IidFaults(straggler_rate=0.15, failure_rate=0.05,
                                       seed=s),
        "correlated": lambda s: pkg.CorrelatedFaults(n_domains=4, rate=0.06,
                                                     mean_duration=5.0, seed=s),
        "preemption": lambda s: pkg.PreemptionFaults(rate=0.06, checkpoint_every=3,
                                                     restore_slots=1, seed=s),
    }


FAULT_KINDS = sorted(_fault_grid(faults))


def _pair(kind, seed):
    return _fault_grid(faults)[kind](seed), _fault_grid(ref_faults)[kind](seed)


def _outage(pkg, **kw):
    return pkg.CarbonDataOutage(**{"rate": 0.08, "mean_duration": 6.0, "seed": 2, **kw})


def _worlds(kind: str, outage: bool = False):
    """(port, reference) worlds of ``tests/test_resilience.py``: (cluster,
    ci, jobs) each; ``outage`` puts a feed outage on the CI service."""
    out = []
    for (mk_cl, mk_ci, mk_mci, mk_geo, spec, gen, gen_dag, dagc, pkg) in (
            (ClusterConfig, CarbonService, MultiRegionCarbonService, GeoCluster,
             TraceSpec, generate_trace, generate_dag_trace, DagConfig, faults),
            (RefClusterConfig, RefCarbonService, RefMRCS, RefGeoCluster, RefTraceSpec,
             ref_generate_trace, ref_generate_dag_trace, RefDagConfig, ref_faults)):
        kw = {"outage": _outage(pkg)} if outage else {}
        hours = WEEK * 2 + 24 * 30
        if kind == "geo":
            cluster = mk_geo.split(CAP, REGIONS2)
            ci = mk_mci.synthetic(REGIONS2, hours, seed=31, **kw)
            jobs = gen(spec(family="azure", hours=WEEK, capacity=CAP, seed=32),
                       cluster.queues)
        elif kind == "dag":
            cluster = mk_cl.default(capacity=CAP)
            ci = mk_ci.synthetic("california", hours, seed=31, **kw)
            jobs = gen_dag(spec(family="azure", hours=WEEK, capacity=CAP, seed=33),
                           dagc(), cluster.queues)
        else:
            cluster = mk_cl.default(capacity=CAP)
            ci = mk_ci.synthetic("south-australia", hours, seed=31, **kw)
            jobs = gen(spec(family="azure", hours=WEEK, capacity=CAP, seed=32),
                       cluster.queues)
        out.append((cluster, ci, jobs))
    return out


_WORLDS: dict = {}


def worlds(kind: str, outage: bool = False):
    if (kind, outage) not in _WORLDS:
        _WORLDS[kind, outage] = _worlds(kind, outage)
    return _WORLDS[kind, outage]


def resil(r):
    return None if r is None else dataclasses.asdict(r)


def assert_same(a, b, ctx=""):
    """Every field ``tests/test_resilience.py::assert_identical`` compares,
    the geo fields where present, and ``resilience``, exactly."""
    assert a.policy == b.policy, ctx
    assert a.carbon_g == b.carbon_g, ctx
    assert a.energy_kwh == b.energy_kwh, ctx
    for name in ("completion", "violations", "wait_slots"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=f"{ctx}: {name}")
    assert [vars(x) for x in a.slots] == [vars(y) for y in b.slots], ctx
    if b.regions is not None:
        for name in ("final_region", "region_carbon_g", "region_energy_kwh"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                          err_msg=f"{ctx}: {name}")
        assert (a.migrations, a.migration_carbon_g) == \
            (b.migrations, b.migration_carbon_g), ctx
    assert resil(a.resilience) == resil(b.resilience), ctx


# --- the fault processes slot by slot -----------------------------------------


def _drive(fm, jobs, caps, slots=60, seed=0):
    """Drive a fault process over ``slots`` slots as the engines do, on a
    seeded stream of allocated jobs; returns everything it reported."""
    gen = np.random.default_rng(seed)
    caps = np.asarray(caps, dtype=np.int64)
    fm.on_run_start(0, caps if len(caps) > 1 else int(caps[0]))
    out = []
    for t in range(slots):
        fm.begin_slot(t)
        cap = fm.available_capacity(int(caps.sum()))
        vec = fm.available_capacity_vec(caps)
        m = int(gen.integers(0, 8))
        idx = gen.choice(len(jobs), size=m, replace=False)
        run = [jobs[i] for i in idx]
        k = np.array([j.k_min for j in run], dtype=np.int64)
        rem = gen.uniform(0.5, 6.0, m)
        thr = gen.uniform(0.5, 1.5, m)
        regs = gen.integers(0, len(caps), m)
        d = fm.apply(t, run, k, rem, thr,
                     regions=regs if len(caps) > 1 else None)
        out.append((cap, vec.tolist(), d.factors.tolist(),
                    *(None if x is None else x.tolist()
                      for x in (d.lost, d.extra_energy, d.evicted))))
    return out, dataclasses.asdict(fm.run_metrics())


@pytest.mark.parametrize("caps", [[CAP], [7, 5]], ids=["one-region", "two-regions"])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", FAULT_KINDS)
def test_fault_process_matches_the_reference(kind, seed, caps):
    (_, _, jobs), (_, _, ref_jobs) = worlds("plain")
    fm, ref_fm = _pair(kind, seed)
    got = _drive(fm, jobs, caps)
    assert got == _drive(ref_fm, ref_jobs, caps)
    # the process re-seeds per run: a second drive repeats the first
    assert _drive(fm, jobs, caps) == got


def test_legacy_adapter_matches_the_reference():
    (_, _, jobs), (_, _, ref_jobs) = worlds("plain")

    class Third:
        def draw_factors(self, n):
            return np.full(n, 1.0 / 3.0)

    got = _drive(faults.ensure_fault_process(Third()), jobs, [CAP])
    assert got == _drive(ref_faults.ensure_fault_process(Third()), ref_jobs, [CAP])
    assert got[1] == dataclasses.asdict(faults.ResilienceMetrics())
    fm = faults.IidFaults(seed=1)
    assert faults.ensure_fault_process(fm) is fm
    assert faults.ensure_fault_process(None) is None
    assert faults.FaultModel is faults.IidFaults
    with pytest.raises(TypeError) as got_e:
        faults.ensure_fault_process(object())
    with pytest.raises(TypeError) as ref_e:
        ref_faults.ensure_fault_process(object())
    assert str(got_e.value) == str(ref_e.value)


# --- carbon-feed outages -------------------------------------------------------


@pytest.mark.parametrize("outage", [
    dict(windows=((10, 15), (40, 52)), stale_after=2),
    dict(rate=0.08, mean_duration=6.0, seed=2, stale_after=3),
    dict(rate=0.2, mean_duration=9.0, seed=5, stale_after=0, backoff_cap=4),
], ids=["windows", "markov", "markov-no-trust"])
@pytest.mark.parametrize("quantile", [False, True], ids=["perfect", "quantile"])
def test_degraded_view_matches_the_reference(outage, quantile):
    model = QuantileForecast(sigma=0.2, seed=5, members=7) if quantile else None
    ref_model = RefQuantileForecast(sigma=0.2, seed=5, members=7) if quantile else None
    ci = CarbonService.synthetic("california", 300, seed=4, model=model,
                                 outage=faults.CarbonDataOutage(**outage))
    ref = RefCarbonService.synthetic("california", 300, seed=4, model=ref_model,
                                     outage=ref_faults.CarbonDataOutage(**outage))
    view, ref_view = ci.degraded(), ref.degraded()
    assert isinstance(view, faults.DegradedCIView)
    assert ci.degraded() is view               # cached on the service
    np.testing.assert_array_equal(view.trace, ref_view.trace)
    assert (len(view), view.horizon) == (len(ref_view), ref_view.horizon)
    for t in range(0, 200):
        assert view.staleness(t) == ref_view.staleness(t), t
        assert view.ci(t) == ref_view.ci(t), t
        assert view.gradient(t) == ref_view.gradient(t), t
        assert view.rank(t) == ref_view.rank(t), t
        np.testing.assert_array_equal(view.forecast(t), ref_view.forecast(t))
        np.testing.assert_array_equal(view.forecast(t, 6), ref_view.forecast(t, 6))
        np.testing.assert_array_equal(view.forecast_quantile(t, q=0.8),
                                      ref_view.forecast_quantile(t, q=0.8))
        assert dataclasses.asdict(view.fetch(t)) == dataclasses.asdict(ref_view.fetch(t))
    assert any(view.staleness(t) > 0 for t in range(200))


def test_fresh_feed_degraded_is_the_service():
    ci = CarbonService.synthetic("ontario", 48, seed=1)
    mci = MultiRegionCarbonService.synthetic(REGIONS2, 48, seed=1)
    assert ci.degraded() is ci and mci.degraded() is mci


def test_degraded_multi_region_view_matches_the_reference():
    (_, mci, _), (_, ref_mci, _) = worlds("geo", outage=True)
    view, ref_view = mci.degraded(), ref_mci.degraded()
    assert isinstance(view, faults.DegradedMultiRegionView)
    assert mci.degraded() is view
    assert (view.regions, view.n_regions, len(view)) == \
        (ref_view.regions, ref_view.n_regions, len(ref_view))
    assert view.index("ontario") == ref_view.index("ontario") == 1
    assert view.service("ontario") is view.views[1]
    for t in range(0, WEEK + 24):
        assert view.staleness(t) == ref_view.staleness(t), t
        assert view.cleanest(t) == ref_view.cleanest(t), t
        assert view.ci(t, 1) == ref_view.ci(t, 1), t
        np.testing.assert_array_equal(view.ci_vec(t), ref_view.ci_vec(t))
        np.testing.assert_array_equal(view.rank_vec(t), ref_view.rank_vec(t))
        np.testing.assert_array_equal(view.forecast_matrix(t, 12),
                                      ref_view.forecast_matrix(t, 12))
    assert max(view.staleness(t) for t in range(WEEK)) > 0


# --- serialization, labels, validation -----------------------------------------


FAULT_ARGS = [
    ("IidFaults", dict(straggler_rate=0.1, failure_rate=0.02, seed=3)),
    ("CorrelatedFaults", dict(n_domains=6, rate=0.04, mean_duration=7.0, seed=4)),
    ("PreemptionFaults", dict(rate=0.03, checkpoint_every=6, restore_slots=2, seed=5)),
]


@pytest.mark.parametrize("cls,kw", FAULT_ARGS, ids=[c for c, _ in FAULT_ARGS])
def test_fault_dicts_and_labels_match_the_reference(cls, kw):
    fm, ref_fm = getattr(faults, cls)(**kw), getattr(ref_faults, cls)(**kw)
    d = faults.fault_to_dict(fm)
    assert json.dumps(d) == json.dumps(ref_faults.fault_to_dict(ref_fm))
    assert faults.fault_from_dict(d) == fm
    assert faults.fault_label(fm) == ref_faults.fault_label(ref_fm)
    assert sweep_mod.fault_label is faults.fault_label


def test_outage_dicts_and_legacy_payloads_match_the_reference():
    for kw in (dict(windows=((3, 7), (20, 24))), dict(rate=0.05, seed=9, stale_after=4)):
        out, ref_out = faults.CarbonDataOutage(**kw), ref_faults.CarbonDataOutage(**kw)
        d = faults.outage_to_dict(out)
        assert json.dumps(d) == json.dumps(ref_faults.outage_to_dict(ref_out))
        assert faults.outage_from_dict(json.loads(json.dumps(d))) == out
    legacy = {"straggler_rate": 0.2, "straggler_slowdown": 0.5,
              "failure_rate": 0.1, "seed": 4}
    assert faults.fault_from_dict(legacy) == faults.IidFaults(
        straggler_rate=0.2, failure_rate=0.1, seed=4)
    for fn in ("fault_to_dict", "fault_from_dict", "outage_to_dict", "outage_from_dict"):
        assert getattr(faults, fn)(None) is None
    assert faults.fault_label(None) == "none"


def _message(fn, *args, **kw):
    with pytest.raises((ValueError, TypeError)) as e:
        fn(*args, **kw)
    return type(e.value).__name__, str(e.value)


@pytest.mark.parametrize("call", [
    ("CorrelatedFaults", dict(n_domains=0)),
    ("CorrelatedFaults", dict(rate=1.5)),
    ("CorrelatedFaults", dict(mean_duration=0.5)),
    ("PreemptionFaults", dict(rate=-0.1)),
    ("PreemptionFaults", dict(checkpoint_every=0)),
    ("PreemptionFaults", dict(checkpoint_overhead=1.0)),
    ("PreemptionFaults", dict(restore_slots=-1)),
    ("CarbonDataOutage", dict(rate=1.5)),
    ("CarbonDataOutage", dict(mean_duration=0.0)),
    ("CarbonDataOutage", dict(stale_after=-1)),
    ("CarbonDataOutage", dict(backoff_base=4, backoff_cap=2)),
    ("CarbonDataOutage", dict(windows=((5, 5),))),
    ("fault_from_dict", {"d": {"kind": "cosmic-rays"}}),
    ("fault_to_dict", {"faults": object()}),
    ("outage_from_dict", {"d": {"kind": "bogus"}}),
], ids=lambda c: c[0] if isinstance(c, str) else None)
def test_validation_messages_match_the_reference(call):
    name, kw = call
    assert _message(getattr(faults, name), **kw) == \
        _message(getattr(ref_faults, name), **kw)


def test_unknown_fault_kind_in_a_scenario_payload():
    payload = json.dumps({"faults": {"kind": "cosmic-rays"}})
    assert _message(Scenario.from_json, payload) == \
        _message(RefScenario.from_json, payload)


# --- the engines -----------------------------------------------------------------


POLICIES = {
    "plain": ((baselines.CarbonAgnosticPolicy, ref_baselines.CarbonAgnosticPolicy),
              (baselines.WaitAwhilePolicy, ref_baselines.WaitAwhilePolicy)),
    "dag": ((DagFcfsPolicy, RefDagFcfsPolicy), (DagCarbonPolicy, RefDagCarbonPolicy)),
    "geo": ((GeoStaticPolicy, RefGeoStaticPolicy), (GeoFlexPolicy, RefGeoFlexPolicy)),
}


@pytest.mark.parametrize("engine", ["scalar", "vector", "scan"])
@pytest.mark.parametrize("kind", FAULT_KINDS)
@pytest.mark.parametrize("world", sorted(POLICIES))
def test_faulted_engines_match_the_reference(world, kind, engine):
    (cl, ci, jobs), (ref_cl, ref_ci, ref_jobs) = worlds(world)
    seed = 2 if world == "plain" else 5
    for policy, ref_policy in POLICIES[world]:
        fm, ref_fm = _pair(kind, seed)
        want = ref_simulate(ref_jobs, ref_ci, ref_cl, ref_policy(), horizon=WEEK,
                            faults=ref_fm)
        scan_engine.reset_stats()
        got = simulate(jobs, ci, cl, policy(), horizon=WEEK, faults=fm,
                       engine=engine, device="cpu")
        assert_same(got, want, f"{world}/{kind}/{policy.__name__}/{engine}")
        assert got.resilience is not None
        if engine == "scan":        # a fault process delegates, whatever the policy
            assert scan_engine.stats["fault_delegated"] == 1
            assert scan_engine.stats["delegated"] == scan_engine.stats["steps"] == 0


def test_correlated_faults_shrink_capacity_below_the_policy():
    """Capacity outages bite: the engines see fewer servers than the policy
    asked for, evict, and recover, as in the reference."""
    (cl, ci, jobs), (ref_cl, ref_ci, ref_jobs) = worlds("plain")
    kw = dict(n_domains=5, rate=0.15, mean_duration=5.0, seed=4)
    got = simulate(jobs, ci, cl, baselines.CarbonAgnosticPolicy(), horizon=WEEK,
                   faults=faults.CorrelatedFaults(**kw), device="cpu")
    want = ref_simulate(ref_jobs, ref_ci, ref_cl, ref_baselines.CarbonAgnosticPolicy(),
                        horizon=WEEK, faults=ref_faults.CorrelatedFaults(**kw))
    assert_same(got, want, "correlated p=0.15")
    r = got.resilience
    assert r.capacity_outages >= 1 and r.evictions >= 1 and r.mttr_slots > 0
    assert min(s.provisioned for s in got.slots) < CAP


# The native kinds of the scan engine, each with the scenario that builds it.
NATIVE = {
    "single": ("carbon-agnostic", "wait-awhile", "wait-awhile-robust",
               "carbonflex-mpc", "carbonflex-scale"),
    "dag": ("dag-fcfs", "dag-carbon", "dag-cap"),
    "geo": ("geo-static", "geo-greedy", "geo-flex"),
}
NATIVE_BASE = dict(capacity=8, learn_weeks=1, family="alibaba", seed=101)


def _native_scenarios(kind, pkg_faults, scenario, mpc, dag):
    kw = dict(NATIVE_BASE, ci_outage=_outage(pkg_faults, rate=0.1))
    if kind == "single":
        return scenario(**kw, mpc=mpc(scale_rho=0.3))
    if kind == "dag":
        return scenario(**kw, dag=dag(width=3, depth=3))
    return scenario(**kw, regions=REGIONS2)


@pytest.mark.parametrize("kind", sorted(NATIVE))
def test_outage_runs_natively_on_the_scan_engine(kind):
    names = NATIVE[kind]
    ref = ref_run(_native_scenarios(kind, ref_faults, RefScenario, RefMPCConfig,
                                    RefDagConfig), names)
    for engine in ("vector", "scan"):
        scan_engine.reset_stats()
        got = run(dataclasses.replace(_native_scenarios(
            kind, faults, Scenario, MPCConfig, DagConfig), engine=engine), names,
            device="cpu")
        stats = dict(scan_engine.stats)
        for name in names:
            a, b = got.weekly[name][0], ref.weekly[name][0]
            assert_same(a, b, f"{kind}/{name}/{engine}")
            assert a.resilience.degraded_slots > 0
        if engine == "scan":
            assert stats["delegated"] == stats["fault_delegated"] == 0, stats
            assert stats["cell_steps"] >= len(names) * WEEK
            if kind == "geo":
                assert stats["geo_steps"] > 0
            if kind == "dag":
                assert stats["dag_steps"] > 0


@pytest.mark.parametrize("engine", ["scalar", "vector", "scan"])
@pytest.mark.parametrize("world", ["plain", "geo"])
def test_outage_and_faults_compose(world, engine):
    (cl, ci, jobs), (ref_cl, ref_ci, ref_jobs) = worlds(world, outage=True)
    policy, ref_policy = POLICIES[world][1]
    fm = faults.CorrelatedFaults(rate=0.06, seed=3)
    want = ref_simulate(ref_jobs, ref_ci, ref_cl, ref_policy(), horizon=WEEK,
                        faults=ref_faults.CorrelatedFaults(rate=0.06, seed=3))
    got = simulate(jobs, ci, cl, policy(), horizon=WEEK, faults=fm, engine=engine,
                   device="cpu")
    assert_same(got, want, f"{world}/outage+correlated/{engine}")
    assert got.resilience.degraded_slots > 0
    assert got.resilience.capacity_outages > 0


def test_scan_fast_paths_refuse_an_outage():
    """The whole-trace fast paths read the true trace; with an outage the
    tables come from the degraded view, slot by slot, as the policies read
    it."""
    (_, ci, _), _ = worlds("plain", outage=True)
    (_, mci, _), _ = worlds("geo", outage=True)
    assert scan_engine._perfect_traces(mci) is None
    assert scan_engine._perfect_traces(MultiRegionCarbonService(
        mci.regions, tuple(dataclasses.replace(s, outage=None)
                           for s in mci.services))) is not None
    view = ci.degraded()
    ts = np.arange(WEEK, WEEK + 96)
    policy = baselines.WaitAwhilePolicy()
    elig = scan_engine._single_elig_fn(policy, view, "thresh")
    want = np.array([view.ci(t) <= view.percentile_threshold(t, policy.percentile)
                     + 1e-12 for t in ts.tolist()])
    np.testing.assert_array_equal(elig(ts), want)
    true = scan_engine._single_elig_fn(
        baselines.WaitAwhilePolicy(), dataclasses.replace(ci, outage=None), "thresh")
    assert (true(ts) != want).any()


# --- Scenario, run and Sweep ------------------------------------------------------


@pytest.mark.parametrize("fm", [None] + [c for c, _ in FAULT_ARGS])
def test_scenario_json_matches_the_reference(fm):
    kw = dict(FAULT_ARGS)[fm] if fm else None
    out = dict(rate=0.05, seed=9, stale_after=4)
    port = Scenario(faults=getattr(faults, fm)(**kw) if fm else None,
                    ci_outage=faults.CarbonDataOutage(**out))
    ref = RefScenario(faults=getattr(ref_faults, fm)(**kw) if fm else None,
                      ci_outage=ref_faults.CarbonDataOutage(**out))
    assert port.to_json() == ref.to_json()
    back = Scenario.from_json(port.to_json())
    assert back == port and back.faults == port.faults
    assert Scenario.from_dict({"faults": {"straggler_rate": 0.2, "seed": 4}}).faults \
        == faults.IidFaults(straggler_rate=0.2, seed=4)


def test_materialize_puts_the_outage_on_the_services():
    out = faults.CarbonDataOutage(rate=0.05, seed=1)
    mat = Scenario(capacity=8, learn_weeks=1, ci_outage=out).materialize()
    assert mat.ci.outage is out and isinstance(mat.ci.degraded(), faults.DegradedCIView)
    geo = Scenario(capacity=8, learn_weeks=1, regions=REGIONS2,
                   ci_outage=out).materialize()
    assert all(s.outage is out for s in geo.mci.services)


def test_run_with_faults_matches_the_reference():
    """``run`` gives every case of every week a fresh copy of the
    scenario's fault process; carbonflex's capacity trim under faults."""
    base = dict(capacity=10, learn_weeks=1, eval_weeks=2, seed=5, region="ontario")
    names = ("carbon-agnostic", "wait-awhile", "carbonflex")
    ref = ref_run(RefScenario(**base, faults=ref_faults.CorrelatedFaults(
        rate=0.08, seed=2)), names)
    got = run(Scenario(**base, faults=faults.CorrelatedFaults(rate=0.08, seed=2)),
              names, device="cpu")
    for name in names:
        for w, (a, b) in enumerate(zip(got.weekly[name], ref.weekly[name])):
            assert_same(a, b, f"{name} week {w}")
        assert got.savings(name) == ref.savings(name)
        assert got.violation_rate(name) == ref.violation_rate(name)


def test_sweep_fault_axis_mixes_kinds():
    """``tests/test_resilience.py::test_sweep_fault_axis_mixes_kinds``'s grid,
    byte for byte, and its CSV's dotted resilience columns."""
    kw = dict(capacity=16, learn_weeks=1, eval_weeks=1, seed=11, region="ontario")
    policies = ("carbon-agnostic", "wait-awhile")
    want = RefSweep(base=RefScenario(**kw), policies=policies,
                    faults=[None, ref_faults.CorrelatedFaults(rate=0.06, seed=2)]).run()
    got = Sweep(base=Scenario(**kw), policies=policies,
                faults=[None, faults.CorrelatedFaults(rate=0.06, seed=2)],
                device="cpu").run()
    assert got.to_json() == want.to_json()
    assert got.to_csv() == want.to_csv()
    assert "resilience.capacity_outages" in got.to_csv().splitlines()[0]


@pytest.mark.parametrize("engine", ["vector", "scan"])
def test_chaos_sweep_matches_the_reference(engine):
    """A smaller copy of ``test_chaos_sweep_outage_x_preemption_grid``: the
    fault kinds x a feed outage, three policies (carbonflex delegates on
    its policy, every faulted cell on its faults), one seed."""
    def grid(pkg, scenario, sweep, **kw):
        return sweep(
            base=scenario(capacity=12, learn_weeks=1, eval_weeks=1,
                          region="south-australia",
                          ci_outage=pkg.CarbonDataOutage(rate=0.04, mean_duration=6.0,
                                                         seed=1), **kw),
            seeds=(7,), policies=("carbon-agnostic", "wait-awhile", "carbonflex"),
            faults=[None, pkg.CorrelatedFaults(n_domains=4, rate=0.05, seed=2),
                    pkg.PreemptionFaults(rate=0.05, checkpoint_every=4, seed=2)])

    want = grid(ref_faults, RefScenario, RefSweep).run().to_json()
    scan_engine.reset_stats()
    got = grid(faults, Scenario, lambda **kw: Sweep(**kw, device="cpu"),
               engine=engine).run()
    assert got.to_json() == want
    assert all(r["resilience"]["degraded_slots"] > 0 for r in got.rows())
    if engine == "scan":
        stats = scan_engine.stats
        assert (stats["fault_delegated"], stats["delegated"]) == (6, 1), stats
        assert stats["cell_steps"] >= 2 * WEEK
