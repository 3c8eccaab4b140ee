"""The port's geo-distributed scheduling against the JAX package.

Small worlds like ``tests/test_geo.py``'s (capacity 20 split over three
regions, one week of jobs), the same seeds in both packages, compared
exactly:

- ``MigrationModel`` / ``GeoCluster`` values and validation errors, and
  ``MultiRegionCarbonService``'s traces, CI vectors, forecast blocks and
  ranks;
- each geo policy's ``decide_geo`` on the same active sets;
- the port's vector, scalar and scan engines (the scan engine's walk on
  the CPU is ``geo_walk.geo_resolve_plain``) against ``repro``'s vector
  engine, for every geo policy, uniform and mixed ``k_min``, perfect and
  noisy forecasts; geo-greedy's large-CI-gap migration; the plain walk
  against the vector engine's placements and migrations slot by slot;
- ``run(Scenario(regions=...))`` and a geo ``Sweep``'s JSON byte for byte;
- ``geo_walk.plan``'s grid, and a Python model of the kernel's two phases
  (settle the migrating rows in parallel, then one warp walking the rest)
  against the plain walk on random inputs, as a rehearsal of the CUDA
  kernel, which only the card runs (``tests/test_torch_cuda.py``).
"""
import dataclasses
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import GeoCluster as RefGeoCluster
from repro.core import GeoFlexPolicy as RefGeoFlexPolicy
from repro.core import GeoGreedyPolicy as RefGeoGreedyPolicy
from repro.core import GeoStaticPolicy as RefGeoStaticPolicy
from repro.core import MigrationModel as RefMigrationModel
from repro.core import MultiRegionCarbonService as RefMRCS
from repro.core import NoisyForecast as RefNoisyForecast
from repro.core import simulate as ref_simulate
from repro.core.carbon import CarbonService as RefCarbonService
from repro.core.faults import CarbonDataOutage as RefCarbonDataOutage
from repro.core.simulator import GeoActiveJob as RefGeoActiveJob
from repro.core.types import ClusterConfig as RefClusterConfig
from repro.core.types import Job as RefJob
from repro.experiment import DEFAULT_GEO_POLICIES as REF_DEFAULT_GEO
from repro.experiment import Scenario as RefScenario
from repro.experiment import Sweep as RefSweep
from repro.experiment import run as ref_run
from repro.traces import TraceSpec as RefTraceSpec
from repro.traces import generate_trace as ref_generate_trace
from repro_torch.core import scan_engine, simulator
from repro_torch.core.carbon import (CarbonService, DegradedMultiRegionView,
                                     MultiRegionCarbonService)
from repro_torch.core.faults import CarbonDataOutage
from repro_torch.core.forecast import NoisyForecast
from repro_torch.core.geo import GeoFlexPolicy, GeoGreedyPolicy, GeoStaticPolicy
from repro_torch.core.simulator import GeoActiveJob, SimCase, simulate, simulate_many
from repro_torch.core.types import ClusterConfig, GeoCluster, Job, MigrationModel
from repro_torch.experiment import (DEFAULT_GEO_POLICIES, Scenario, Sweep,
                                    check_scenario_policies, run)
from repro_torch.kernels import geo_walk
from repro_torch.traces import TraceSpec, generate_trace
from test_torch_cuda import _geo_inputs
from test_torch_fill import walk_list

WEEK = 24 * 7
REGIONS2 = ("south-australia", "california")
REGIONS3 = ("south-australia", "california", "ontario")
POLICIES = {"geo-static": (GeoStaticPolicy, RefGeoStaticPolicy),
            "geo-greedy": (GeoGreedyPolicy, RefGeoGreedyPolicy),
            "geo-flex": (GeoFlexPolicy, RefGeoFlexPolicy)}
CU = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc" / "geo_walk.cu"


def _mixed_k(jobs, seed):
    """Each job's ``k_min`` drawn from {1, 2, 4} within its ``k_max`` (the
    profile cut so that ``k_max`` stays), the same draws for either
    package's jobs."""
    gen = np.random.default_rng(seed)
    out = []
    for j in jobs:
        choices = [k for k in (1, 2, 4) if j.k_min <= k <= j.k_max]
        k = int(gen.choice(choices))
        out.append(dataclasses.replace(j, k_min=k, profile=j.profile[k - j.k_min:]))
    return out


def _world(forecast: str = "perfect", mixed: bool = False):
    """(port, reference) worlds: (geo, mci, jobs) each."""
    out = []
    for mk_geo, mk_mci, spec, gen, noisy in (
            (GeoCluster, MultiRegionCarbonService, TraceSpec, generate_trace,
             NoisyForecast),
            (RefGeoCluster, RefMRCS, RefTraceSpec, ref_generate_trace, RefNoisyForecast)):
        geo = mk_geo.split(20, REGIONS3)
        model = noisy(sigma=0.3, seed=5) if forecast == "noisy" else None
        mci = mk_mci.synthetic(REGIONS3, WEEK * 2 + 24 * 30, seed=21, model=model)
        jobs = gen(spec(family="azure", hours=WEEK, capacity=20, seed=22), geo.queues)
        if mixed:
            jobs = _mixed_k(jobs, 5)
        out.append((geo, mci, jobs))
    return out


_WORLDS: dict = {}
_REF_RESULTS: dict = {}


def world(forecast="perfect", mixed=False):
    key = (forecast, mixed)
    if key not in _WORLDS:
        _WORLDS[key] = _world(forecast, mixed)
    return _WORLDS[key]


def ref_result(policy, forecast="perfect", mixed=False):
    key = (policy, forecast, mixed)
    if key not in _REF_RESULTS:
        geo, mci, jobs = world(forecast, mixed)[1]
        _REF_RESULTS[key] = ref_simulate(jobs, mci, geo, POLICIES[policy][1](),
                                         horizon=WEEK)
    return _REF_RESULTS[key]


def assert_same(a, b, ctx=""):
    """Every field ``tests/test_geo.py::assert_geo_results_identical``
    compares, exactly."""
    assert a.carbon_g == b.carbon_g, ctx
    assert a.energy_kwh == b.energy_kwh, ctx
    for name in ("completion", "violations", "wait_slots", "final_region",
                 "region_carbon_g", "region_energy_kwh"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=f"{ctx}: {name}")
    assert a.migrations == b.migrations, ctx
    assert a.migration_carbon_g == b.migration_carbon_g, ctx
    assert [vars(x) for x in a.slots] == [vars(y) for y in b.slots], ctx


# --- types and the multi-region service --------------------------------------


def test_migration_model_and_geo_cluster_match_the_reference():
    kw = dict(base_slots=2, slots_per_length=0.05, energy_kwh_per_gb=0.1, min_gb=1.5)
    mm, ref_mm = MigrationModel(**kw), RefMigrationModel(**kw)
    for length, comm in ((0.0, 0.0), (2.0, 0.5), (40.0, 8.0), (17.3, 1.5)):
        job = Job(job_id=0, arrival=0, length=length, queue=0, delay=6,
                  profile=np.ones(1), comm_size=comm)
        ref = RefJob(job_id=0, arrival=0, length=length, queue=0, delay=6,
                     profile=np.ones(1), comm_size=comm)
        assert mm.slots(job) == ref_mm.slots(ref)
        assert mm.data_gb(job) == ref_mm.data_gb(ref)
        assert mm.energy_kwh(job) == ref_mm.energy_kwh(ref)
        assert mm.carbon_g(job, 123.4) == ref_mm.carbon_g(ref, 123.4)
    for cap, regions in ((7, REGIONS3), (150, REGIONS2), (20, REGIONS3)):
        geo, ref = GeoCluster.split(cap, regions), RefGeoCluster.split(cap, regions)
        assert geo.capacities == ref.capacities and geo.capacity == ref.capacity
        assert (geo.capacity_vec() == ref.capacity_vec()).all()
        assert [geo.home_region(i) for i in range(7)] == \
            [ref.home_region(i) for i in range(7)]
        assert dataclasses.asdict(geo.region_cluster(1)) == \
            dataclasses.asdict(ref.region_cluster(1))
        assert dataclasses.asdict(geo.migration) == dataclasses.asdict(ref.migration)


@pytest.mark.parametrize("args,match", [
    (dict(regions=REGIONS2, capacities=(4,)), "align"),
    (dict(regions=REGIONS2, capacities=(4, 0)), "positive"),
    (dict(regions=(), capacities=()), "region"),
])
def test_geo_cluster_validation_matches_the_reference(args, match):
    queues = ClusterConfig.default(8).queues
    with pytest.raises(ValueError, match=match) as port:
        GeoCluster(queues=queues, **args)
    with pytest.raises(ValueError) as ref:
        RefGeoCluster(queues=RefClusterConfig.default(8).queues, **args)
    assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match="region"):
        GeoCluster.split(10, ())


@pytest.mark.parametrize("forecast", ["perfect", "noisy"])
def test_multi_region_service_matches_the_reference(forecast):
    (_, mci, _), (_, ref, _) = world(forecast)
    assert mci.n_regions == ref.n_regions and len(mci) == len(ref)
    for a, b in zip(mci.services, ref.services):
        assert (a.trace == b.trace).all()
    for t in (0, 5, 100, 167, 300):
        assert (mci.ci_vec(t) == ref.ci_vec(t)).all()
        assert (mci.forecast_matrix(t, 24) == ref.forecast_matrix(t, 24)).all()
        assert (mci.rank_vec(t) == ref.rank_vec(t)).all()
        assert mci.cleanest(t) == ref.cleanest(t)
        assert mci.ci(t, "california") == ref.ci(t, "california")
    assert mci.index("ontario") == ref.index("ontario") == 2
    assert mci.service("california") is mci.services[1]
    assert mci.degraded() is mci


def test_multi_region_service_validation():
    with pytest.raises(ValueError, match="texas"):
        MultiRegionCarbonService.synthetic(REGIONS2, 48, seed=1).index("texas")
    with pytest.raises(ValueError, match="equal length"):
        MultiRegionCarbonService(REGIONS2, (CarbonService.synthetic("ontario", 24),
                                            CarbonService.synthetic("sweden", 48)))
    with pytest.raises(ValueError, match="duplicate"):
        MultiRegionCarbonService.synthetic(("ontario", "ontario"), 24)
    # a feed outage on every region makes the degraded view, as in the reference
    out_mci = MultiRegionCarbonService.synthetic(REGIONS2, 48, seed=1,
                                                 outage=CarbonDataOutage(rate=0.2))
    ref_mci = RefMRCS.synthetic(REGIONS2, 48, seed=1,
                                outage=RefCarbonDataOutage(rate=0.2))
    view = out_mci.degraded()
    assert isinstance(view, DegradedMultiRegionView) and out_mci.degraded() is view
    assert [view.staleness(t) for t in range(48)] == \
        [ref_mci.degraded().staleness(t) for t in range(48)]


# --- the policies --------------------------------------------------------------


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_decide_geo_matches_the_reference(policy):
    """Each policy decides the same allocation, slot after slot, on the
    same random active sets (its state carried over the slots)."""
    (geo, mci, jobs), (ref_geo, ref_mci, ref_jobs) = world()
    port_pol, ref_pol = POLICIES[policy][0](), POLICIES[policy][1]()
    port_pol.on_window_start(mci, 0, WEEK, jobs, geo)
    ref_pol.on_window_start(ref_mci, 0, WEEK, ref_jobs, ref_geo)
    gen = np.random.default_rng(3)
    moved = 0
    for t in range(0, 120, 6):
        rows = gen.choice(len(jobs), size=40, replace=False)
        state = [dict(remaining=float(gen.uniform(0.01, 30.0)),
                      slack_left=int(gen.integers(-2, 40)),
                      started=bool(gen.random() < 0.5),
                      region=int(gen.integers(0, 3)),
                      mig_left=int(gen.random() < 0.1)) for _ in rows]
        act = [GeoActiveJob(job=jobs[r], **st) for r, st in zip(rows, state)]
        ref_act = [RefGeoActiveJob(job=ref_jobs[r], **st) for r, st in zip(rows, state)]
        m_vec, alloc = port_pol.decide_geo(t, act, mci, geo)
        ref_m, ref_alloc = ref_pol.decide_geo(t, ref_act, ref_mci, ref_geo)
        assert (m_vec == ref_m).all() and alloc == ref_alloc, t
        moved += sum(1 for a in act if a.started and a.job.job_id in alloc
                     and alloc[a.job.job_id][0] != a.region)
    if policy != "geo-static":
        assert moved > 0


# --- the engines -----------------------------------------------------------------


@pytest.mark.parametrize("forecast", ["perfect", "noisy"])
@pytest.mark.parametrize("mixed", [False, True], ids=["uniform-k", "mixed-k"])
@pytest.mark.parametrize("engine", ["vector", "scalar", "scan"])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_engines_match_the_reference(policy, engine, mixed, forecast):
    geo, mci, jobs = world(forecast, mixed)[0]
    got = simulate(jobs, mci, geo, POLICIES[policy][0](), horizon=WEEK, engine=engine,
                   device="cpu")
    want = ref_result(policy, forecast, mixed)
    assert_same(got, want, f"{policy}/{engine}")
    assert got.to_dict(include_per_job=True) == want.to_dict(include_per_job=True)
    if policy != "geo-static" and forecast == "perfect":
        assert got.migrations > 0


def test_mixed_k_reaches_every_scale():
    jobs = world("perfect", True)[0][2]
    assert {j.k_min for j in jobs} == {1, 2, 4}


@pytest.mark.parametrize("engine", ["vector", "scalar", "scan"])
def test_geo_greedy_migrates_on_large_ci_gap(engine):
    """A two-region trace whose CI ranking flips hard after the job starts:
    geo-greedy must migrate, as in the reference."""
    hours = 24 * 10
    trace_a = np.full(hours, 1000.0)
    trace_a[:2] = 1.0
    trace_b = np.full(hours, 5.0)
    trace_b[:2] = 500.0
    results = []
    for mk_cs, mk_mrcs, mk_geo, mk_mm, mk_cc, mk_job, pol, sim, kw in (
            (CarbonService, MultiRegionCarbonService, GeoCluster, MigrationModel,
             ClusterConfig, Job, GeoGreedyPolicy, simulate,
             dict(engine=engine, device="cpu")),
            (RefCarbonService, RefMRCS, RefGeoCluster, RefMigrationModel,
             RefClusterConfig, RefJob, RefGeoGreedyPolicy, ref_simulate, {})):
        mci = mk_mrcs(("flip", "clean"), (mk_cs(trace=trace_a.copy()),
                                          mk_cs(trace=trace_b.copy())))
        geo = mk_geo(regions=("flip", "clean"), capacities=(4, 4),
                     queues=mk_cc.default(8).queues, migration=mk_mm())
        job = mk_job(job_id=0, arrival=0, length=10.0, queue=2, delay=48,
                     profile=np.ones(1))
        results.append(sim([job], mci, geo, pol(), horizon=hours, **kw))
    got, want = results
    assert got.migrations == 1 and got.final_region[0] == 1
    assert got.migration_carbon_g > 0
    assert_same(got, want, engine)


def test_simulate_many_runs_geo_cases_on_every_engine():
    geo, mci, jobs = world()[0]
    cases = [SimCase(jobs=jobs, ci=mci, cluster=geo, policy=POLICIES[p][0](),
                     horizon=WEEK, engine=e, device="cpu")
             for e in ("vector", "scalar", "scan") for p in sorted(POLICIES)]
    scan_engine.reset_stats()
    for case, res in zip(cases, simulate_many(cases)):
        assert_same(res, ref_result(type(case.policy)().name), case.engine)
    # the three scan cells: three kinds, three tiles of one cell
    assert scan_engine.stats["geo_steps"] == scan_engine.stats["steps"] > 0
    assert scan_engine.stats["delegated"] == 0


def test_scan_tile_of_several_cells_equals_single_runs():
    """Cells of one structure run as one batched tile: three CI seeds of
    geo-flex in one program, each equal to its own vector run."""
    geo, _, jobs = world()[0]
    mcis = [MultiRegionCarbonService.synthetic(REGIONS3, WEEK * 2 + 24 * 30, seed=s)
            for s in (21, 22, 23)]
    cases = [SimCase(jobs=jobs, ci=m, cluster=geo, policy=GeoFlexPolicy(),
                     horizon=WEEK, engine="scan", device="cpu") for m in mcis]
    scan_engine.reset_stats()
    out = simulate_many(cases)
    assert scan_engine.stats["cell_steps"] == 3 * scan_engine.stats["steps"]
    for m, res in zip(mcis, out):
        assert_same(res, simulate(jobs, m, geo, GeoFlexPolicy(), horizon=WEEK), "tile")


@pytest.mark.parametrize("policy", ["geo-greedy", "geo-flex"])
def test_plain_walk_matches_the_vector_engine_step_by_step(policy, monkeypatch):
    """The scan engine's walk (``geo_resolve_plain`` on the CPU), recorded
    step by step, runs, places and migrates the same jobs in the same
    regions as the vector engine's ``_resolve_geo`` in the same slot."""
    geo, mci, jobs = world("perfect", True)[0]
    vec_steps, scan_steps = [], []
    resolve = simulator._resolve_geo

    def recorded_resolve(active, alloc, g, *telemetry_args):
        per_r, migs = resolve(active, alloc, g, *telemetry_args)
        vec_steps.append(({jid: r for r in range(g.n_regions) for jid in per_r[r]},
                          {a.job.job_id: dest for a, dest in migs}))
        return per_r, migs

    plain = geo_walk.geo_resolve

    def recorded_walk(kind, cand, forced, state, consts, tables):
        out = plain(kind, cand, forced, state, consts, tables)
        take, _, _, engr, _, _, mig_now = (x[0] for x in out)
        scan_steps.append((take.clone(), engr.clone(), mig_now.clone()))
        return out

    monkeypatch.setattr(simulator, "_resolve_geo", recorded_resolve)
    monkeypatch.setattr(geo_walk, "geo_resolve", recorded_walk)
    simulate(jobs, mci, geo, POLICIES[policy][0](), horizon=WEEK)
    simulate(jobs, mci, geo, POLICIES[policy][0](), horizon=WEEK, engine="scan",
             device="cpu")
    ids = simulator.pack(jobs).job_ids
    assert len(scan_steps) >= len(vec_steps) > WEEK
    migrations = 0
    for t, ((runs, migs), (take, engr, mig_now)) in enumerate(zip(vec_steps, scan_steps)):
        rows = take.nonzero()[:, 0].tolist()
        assert {int(ids[r]): int(engr[r]) for r in rows} == runs, t
        rows = mig_now.nonzero()[:, 0].tolist()
        assert {int(ids[r]): int(engr[r]) for r in rows} == migs, t
        migrations += len(migs)
    assert migrations > 0
    # past the end the scan engine's extra steps run and move nothing
    for take, _, mig_now in scan_steps[len(vec_steps):]:
        assert not take.any() and not mig_now.any()


def test_engines_refuse_faults_and_dag_jobs():
    """A foreign object as ``faults`` (neither a fault process nor the legacy
    ``draw_factors`` surface) is refused with the reference's message; so
    are DAG jobs and a single-region service."""
    geo, mci, jobs = world()[0]
    ref_geo, ref_mci, ref_jobs = world()[1]
    with pytest.raises(TypeError, match="draw_factors") as got:
        simulate(jobs, mci, geo, GeoStaticPolicy(), horizon=WEEK, faults=object())
    with pytest.raises(TypeError) as want:
        ref_simulate(ref_jobs, ref_mci, ref_geo, RefGeoStaticPolicy(), horizon=WEEK,
                     faults=object())
    assert str(got.value) == str(want.value)
    dag_jobs = [dataclasses.replace(j, deps=(jobs[0].job_id,)) if i == 1 else j
                for i, j in enumerate(jobs)]
    for engine in ("vector", "scalar", "scan"):
        with pytest.raises(ValueError, match="DAG"):
            simulate(dag_jobs, mci, geo, GeoFlexPolicy(), horizon=WEEK, engine=engine,
                     device="cpu")
    with pytest.raises(TypeError, match="MultiRegionCarbonService"):
        simulate(jobs, mci.services[0], geo, GeoStaticPolicy(), horizon=WEEK)


def test_native_kind_is_by_exact_type_and_cluster():
    class Sub(GeoFlexPolicy):
        pass

    assert [scan_engine.native_kind(POLICIES[p][0](), True) for p in sorted(POLICIES)] \
        == sorted(POLICIES)
    assert scan_engine.native_kind(Sub(), True) is None
    assert scan_engine.native_kind(GeoFlexPolicy()) is None


# --- the experiment layer --------------------------------------------------------

TINY = dict(regions=REGIONS2, capacity=10, learn_weeks=1, seed=3, family="alibaba")


@pytest.mark.parametrize("engine", ["vector", "scan"])
def test_run_matches_the_reference(engine):
    port = run(Scenario(**TINY, engine=engine), device="cpu")
    ref = ref_run(RefScenario(**TINY))
    assert port.policies == ref.policies == tuple(REF_DEFAULT_GEO) == DEFAULT_GEO_POLICIES
    assert port.table() == ref.table()
    assert port.metrics() == ref.metrics()
    for name in port.policies:
        for a, b in zip(port.weekly[name], ref.weekly[name]):
            assert_same(a, b, name)


@pytest.mark.parametrize("engine", ["vector", "scalar", "scan"])
def test_geo_sweep_json_matches_the_reference(engine):
    kw = dict(seeds=[3, 4], policies=["geo-greedy", "geo-flex"])
    got = Sweep(base=Scenario(**TINY, engine=engine), device="cpu", **kw).run()
    want = RefSweep(base=RefScenario(**TINY), **kw).run()
    assert got.baseline == "geo-static"
    assert got.to_json() == want.to_json()
    assert got.to_csv() == want.to_csv()
    assert got.rows()[0]["region"] == "south-australia+california"


def test_materialize_builds_the_geo_world():
    mat = Scenario(**TINY).materialize()
    ref = RefScenario(**TINY).materialize()
    assert mat.is_geo and mat.geo.capacities == ref.geo.capacities
    assert mat.ci is mat.mci.service(0)
    assert (mat.mci.services[1].trace == ref.mci.services[1].trace).all()
    assert [j.job_id for j in mat.eval_jobs] == [j.job_id for j in ref.eval_jobs]
    mig = Scenario(**TINY, migration=MigrationModel(base_slots=3)).materialize()
    assert mig.geo.migration.base_slots == 3
    assert not Scenario(capacity=10, learn_weeks=1).materialize().is_geo


@pytest.mark.parametrize("kw", [
    dict(regions=("california",)),
    dict(regions=("california", "nowhere")),
    dict(regions=REGIONS2, dag=object()),
])
def test_scenario_validation_matches_the_reference(kw):
    with pytest.raises(ValueError) as port:
        Scenario(**kw)
    with pytest.raises(ValueError) as ref:
        RefScenario(**kw)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("names,is_geo", [(["geo-flex"], False), (["wait-awhile"], True),
                                          (["dag-fcfs"], True)])
def test_policy_family_checks_match_the_reference(names, is_geo):
    from repro.experiment.registry import check_scenario_policies as ref_check

    with pytest.raises(ValueError) as port:
        check_scenario_policies(names, is_geo)
    with pytest.raises(ValueError) as ref:
        ref_check(names, is_geo)
    assert str(port.value) == str(ref.value)


def test_geo_sweep_refuses_a_regions_axis():
    with pytest.raises(ValueError, match="fixes the region tuple"):
        Sweep(base=Scenario(**TINY), regions=["ontario"], device="cpu").scenarios()


# --- the kernel's launch and a model of its algorithm ---------------------------


@pytest.mark.parametrize("cells,n,regions", [(1, 1, 2), (3, 256, 3), (64, 1792, 10),
                                             (5, 6145, 16)])
def test_plan_covers_every_cell_once(cells, n, regions):
    p = geo_walk.plan(cells, n, regions, route="chunked")
    walked = np.zeros(cells, dtype=int)
    for block in range(p["blocks"]):
        walked[block] += 1
    assert (walked == 1).all()
    rows = np.zeros(n, dtype=int)
    for warp in range(p["threads"] // 32):
        for ch in range(warp, p["chunks"], p["threads"] // 32):
            rows[ch * 32:(ch + 1) * 32] += 1
    assert (rows == 1).all()
    assert p["smem_bytes"] == 8 * p["chunks"] <= geo_walk.SMEM_LIMIT and not p["opt_in"]


@pytest.mark.parametrize("cells,n,regions,smem", [(1, 1, 2, 36), (3, 1792, 2, 36_736),
                                                  (64, 333, 10, 6_836),
                                                  (2, 6144, 16, 125_952),
                                                  (1, 11_200, 3, 229_600)])
def test_compact_plan_covers_every_row_once(cells, n, regions, smem):
    """Walk the compact kernel's grid: one block a cell; warps stride the
    chunks in the stage and again in the write-out (each row once); every
    walked row lands in one slot of the walk list, which warp 0 reads in
    order.  The records, the masks and offsets make the shared memory; 6144
    rows need the opt-in above 48 KB."""
    p = geo_walk.plan(cells, n, regions)
    assert p["route"] == "compact" and p["blocks"] == cells
    assert p["threads"] == geo_walk.COMPACT_THREADS
    assert p["smem_bytes"] == smem == (geo_walk.ROW_BYTES * n
                                       + geo_walk.CHUNK_BYTES * p["chunks"])
    assert p["opt_in"] == (smem > geo_walk.SMEM_LIMIT) and smem <= geo_walk.SMEM_MAX
    rows = np.zeros(n, dtype=int)
    warps = p["threads"] // 32
    for warp in range(warps):
        for ch in range(warp, p["chunks"], warps):
            rows[ch * 32:min(n, (ch + 1) * 32)] += 1
    assert (rows == 1).all()
    g = np.random.default_rng(n)
    cand, forced = g.random(n) < 0.6, g.random(n) < 0.3
    masks = [sum(1 << ln for ln in range(32) if ch * 32 + ln < n and sel[ch * 32 + ln])
             for sel in (cand & forced, cand & ~forced) for ch in range(p["chunks"])]
    assert walk_list(masks, p["chunks"]) == (list(np.flatnonzero(cand & forced))
                                             + list(np.flatnonzero(cand & ~forced)))


def test_plan_refuses_what_the_kernel_cannot_hold():
    for route in geo_walk.ROUTES:
        with pytest.raises(ValueError, match="regions"):
            geo_walk.plan(1, 10, geo_walk.MAX_REGIONS + 1, route)
        with pytest.raises(ValueError, match="regions"):
            geo_walk.plan(1, 10, 0, route)
    with pytest.raises(ValueError, match="chunk masks"):
        geo_walk.plan(1, 32 * 6145, 2, route="chunked")
    with pytest.raises(ValueError, match="a block holds"):
        geo_walk.plan(1, 11_400, 2)
    with pytest.raises(ValueError, match="route"):
        geo_walk.plan(1, 10, 2, route="other")


def test_constants_match_the_kernel_source():
    src = CU.read_text()
    for name in ("THREADS", "MAX_REGIONS", "COMPACT_THREADS", "ROW_BYTES", "CHUNK_BYTES"):
        assert re.search(rf"constexpr int {name} = {getattr(geo_walk, name)};", src), name
    assert "STATIC = 0, GREEDY = 1, FLEX = 2" in src
    assert "constexpr int COMPACT = 0, CHUNKED = 1;" in src
    assert geo_walk.ROUTES == ("compact", "chunked")
    assert "(long long)ROW_BYTES * n + CHUNK_BYTES * chunks" in src
    assert "constexpr int SMEM_LIMIT = 48 * 1024;" in src and geo_walk.SMEM_LIMIT == 48 * 1024
    flags = dict(re.findall(r"(F_[A-Z]+) = (\d+)", src))
    assert {k: int(v) for k, v in flags.items()} == dict(
        F_SEARCH=F_SEARCH, F_ELIG=F_ELIG, F_ENG=F_ENG, F_RUN=F_RUN, F_NEWLY=F_NEWLY)
    assert f"constexpr unsigned int NO_RANK = {NO_RANK};" in src
    assert geo_walk.KINDS == ("geo-static", "geo-greedy", "geo-flex")
    fields = re.search(r"struct GeoArgs \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"(\w+);", fields)
    assert names == [f[0] for f in geo_walk._Args._fields_]


def _migrates(kind, st, c, tb, cell, row, ci):
    """The kernels' migration rule for a candidate row, from the row alone:
    the region it moves to, or None."""
    strt, placed = st["started"][cell][row], st["placed"][cell][row]
    if not strt or kind == "geo-static":
        return None
    greedy = kind == "geo-greedy"
    regions = len(c["caps"][cell])
    r = st["pol_region"][cell][row] if greedy and placed else st["eng_region"][cell][row]
    ms, rv = c["mig_slots"][cell][row], st["remaining"][cell][row]
    can = (st["moves"][cell][row] < c["max_moves"][cell]
           and st["slack"][cell][row] > ms + 1 and rv > ms)
    if greedy:
        e_run = c["ec"][cell][row] * max(1.0, math.ceil(rv))
        stay = ci[r] * e_run
        unit = ci
    else:
        h_lut = len(tb["means"][cell][0])
        hm = min(float(h_lut - ms), max(1.0, math.ceil(rv)))
        can = can and hm >= 1.0
        hi = min(max(int(hm) - 1, 0), h_lut - 1)
        e_run = c["ec"][cell][row] * hm
        stay = tb["means"][cell][r][hi] * e_run
        mm = tb["movemeans"][cell][c["mig_idx"][cell][row]]
        unit = [mm[i][hi] for i in range(regions)]
    if not can:
        return None
    best, best_v = 0, math.inf
    for i in range(regions):
        v = math.inf if i == r else unit[i] * e_run + c["mig_e"][cell][row] * ci[i]
        if i == 0 or v < best_v:
            best, best_v = i, v
    return best if best_v < stay * c["margin_c"][cell] else None


def kernel_model(kind, cand, forced, state, consts, tables):
    """``csrc/geo_walk.cu`` in Python: phase 1 settles every started
    candidate's migration rule from the row alone and copies the state;
    phase 2 walks the other candidates in chunks of 32, forced pass first,
    each lane's row decided in turn against ``used``."""
    st = {k: v.tolist() for k, v in state.items()}
    c = {k: v.tolist() for k, v in consts.items()}
    tb = {k: v.tolist() for k, v in tables.items()}
    b, n = cand.shape
    cand, forced = cand.tolist(), forced.tolist()
    out = dict(take=[[False] * n for _ in range(b)],
               placed=[list(x) for x in st["placed"]],
               pol=[list(x) for x in st["pol_region"]],
               eng=[list(x) for x in st["eng_region"]],
               migl=[list(x) for x in st["mig_left"]],
               moves=[list(x) for x in st["moves"]],
               mig=[[False] * n for _ in range(b)])
    greedy, flex = kind == "geo-greedy", kind == "geo-flex"
    for cell in range(b):
        caps = c["caps"][cell]
        regions = len(caps)
        ci = tb["ci_now"][cell] if "ci_now" in tb else [0.0] * regions
        h_lut = len(tb["means"][cell][0]) if flex else 1
        walk = [[], []]
        for row in range(n):                                    # phase 1
            best = _migrates(kind, st, c, tb, cell, row, ci) if cand[cell][row] else None
            mig = best is not None
            if mig:
                out["placed"][cell][row] = True
                out["pol"][cell][row] = out["eng"][cell][row] = best
                out["migl"][cell][row] = c["mig_slots"][cell][row]
                out["moves"][cell][row] += 1
            out["mig"][cell][row] = mig
            if cand[cell][row] and not mig:
                walk[0 if forced[cell][row] else 1].append(row)
        used = [0] * regions
        for rows in walk:                                       # phase 2
            for row in rows:
                k = c["kmin"][cell][row]
                strt, placed = st["started"][cell][row], st["placed"][cell][row]
                polr, engr = st["pol_region"][cell][row], st["eng_region"][cell][row]
                if greedy and strt and not placed:
                    polr = engr
                search = kind != "geo-static" and not strt and not placed
                newly = False
                if kind == "geo-static" or (flex and strt):
                    r = engr
                else:
                    r = polr
                    if search:
                        if greedy:
                            pref = tb["clean_order"][cell]
                        else:
                            h = min(float(h_lut), max(1.0, math.ceil(
                                st["remaining"][cell][row])))
                            col = min(max(int(h) - 1, 0), h_lut - 1)
                            m = [tb["means"][cell][q][col] for q in range(regions)]
                            pref = sorted(range(regions), key=m.__getitem__)
                        for q in pref:
                            if used[q] + k <= caps[q]:
                                r, newly = q, True
                                break
                elig = not flex or forced[cell][row] or ci[r] <= tb["thresh_eps"][cell][r]
                placeable = kind == "geo-static" or strt or placed or newly
                run = placeable and elig and used[r] + k <= caps[r]
                if run:
                    used[r] += k
                out["take"][cell][row] = run
                if kind != "geo-static":
                    out["placed"][cell][row] = placed or (strt and greedy) or newly
                    if not (flex and strt):
                        out["pol"][cell][row] = r
                    if run and not strt:
                        out["eng"][cell][row] = r
    return tuple(torch.tensor(out[k]) for k in ("take", "placed", "pol", "eng", "migl",
                                                 "moves", "mig"))


# The compact kernel's record flags and its "no region" rank (csrc/geo_walk.cu).
F_SEARCH, F_ELIG, F_ENG, F_RUN, F_NEWLY = 1, 2, 4, 8, 16
NO_RANK = 16
MASK64 = (1 << 64) - 1


def flex_ranks(means_col):
    """``flex_ranks``: the regions sorted stably by ``means_col`` by
    insertion into a packed word of 4-bit indices (the first preferred
    lowest), returned as each region's rank, 4 bits a region."""
    order = 0
    for q, mq in enumerate(means_col):
        p = q
        while p > 0 and means_col[(order >> (4 * (p - 1))) & 15] > mq:
            p -= 1
        low = order & ((1 << (4 * p)) - 1)
        high = ((order >> (4 * p)) << (4 * (p + 1))) & MASK64 if p < 15 else 0
        order = low | high | (q << (4 * p))
    ranks = 0
    for q in range(len(means_col)):
        ranks |= q << (4 * ((order >> (4 * q)) & 15))
    return ranks


def compact_model(kind, cand, forced, state, consts, tables):
    """``geo_walk_compact_kernel`` in Python: the stage settles the
    migration rule and records each row to walk (k_min, its region or its
    regions' packed ranks, flags); the walk list comes from the chunk
    ballots' scan; warp 0's walk keeps each region's capacity left,
    eligibility and (geo-greedy) CI rank in its lane, gives a row to be
    placed to the lane with room of the lowest rank (the warp min) and any
    other row to its region's lane, which stores the result in the row's
    flags; the write-out applies it."""
    st = {k: v.tolist() for k, v in state.items()}
    c = {k: v.tolist() for k, v in consts.items()}
    tb = {k: v.tolist() for k, v in tables.items()}
    b, n = cand.shape
    cand, forced = cand.tolist(), forced.tolist()
    out = dict(take=[[False] * n for _ in range(b)],
               placed=[list(x) for x in st["placed"]],
               pol=[list(x) for x in st["pol_region"]],
               eng=[list(x) for x in st["eng_region"]],
               migl=[list(x) for x in st["mig_left"]],
               moves=[list(x) for x in st["moves"]],
               mig=[[False] * n for _ in range(b)])
    static, greedy, flex = (kind == k for k in geo_walk.KINDS)
    chunks = -(-n // 32)
    for cell in range(b):
        regions = len(c["caps"][cell])
        ci = tb["ci_now"][cell] if "ci_now" in tb else [0.0] * regions
        s_k, s_word, s_flags = [0] * n, [0] * n, [0] * n
        walk = [False] * n
        for row in range(n):                                    # stage
            strt, placed = st["started"][cell][row], st["placed"][cell][row]
            polr, engr = st["pol_region"][cell][row], st["eng_region"][cell][row]
            best = _migrates(kind, st, c, tb, cell, row, ci) if cand[cell][row] else None
            walk[row] = cand[cell][row] and best is None
            if best is not None:
                out["mig"][cell][row] = True
                out["migl"][cell][row] = c["mig_slots"][cell][row]
                out["moves"][cell][row] += 1
            adopt = walk[row] and greedy and strt and not placed
            out["placed"][cell][row] = placed or best is not None or adopt
            out["pol"][cell][row] = best if best is not None else (engr if adopt else polr)
            out["eng"][cell][row] = best if best is not None else engr
            if walk[row]:
                search = not static and not strt and not placed
                s_k[row] = c["kmin"][cell][row]
                if search and flex:
                    h_lut = len(tb["means"][cell][0])
                    h = min(float(h_lut), max(1.0, math.ceil(st["remaining"][cell][row])))
                    col = min(max(int(h) - 1, 0), h_lut - 1)
                    s_word[row] = flex_ranks([tb["means"][cell][q][col]
                                              for q in range(regions)])
                elif not search:
                    s_word[row] = engr if static or (flex and strt) or adopt else polr
                s_flags[row] = ((F_SEARCH if search else 0)
                                | (F_ELIG if not flex or forced[cell][row] else 0)
                                | (F_ENG if not static and not strt else 0))
        masks = [sum(1 << lane for lane in range(32) if ch * 32 + lane < n
                     and walk[ch * 32 + lane] and forced[cell][ch * 32 + lane] == want)
                 for want in (True, False) for ch in range(chunks)]
        lanes = range(32)                                       # walk
        in_r = [lane < regions for lane in lanes]
        left = [c["caps"][cell][lane] if in_r[lane] else 0 for lane in lanes]
        elig = [not flex or (in_r[lane] and ci[lane] <= tb["thresh_eps"][cell][lane])
                for lane in lanes]
        greedy_rank = [NO_RANK] * 32
        if greedy:
            order = tb["clean_order"][cell]
            for q in range(regions - 1, -1, -1):
                if 0 <= order[q] < 32:
                    greedy_rank[order[q]] = q
        for row in walk_list(masks, chunks):
            k, w, fl = s_k[row], s_word[row], s_flags[row]
            fits = [in_r[lane] and k <= left[lane] for lane in lanes]
            may_run = [elig[lane] or bool(fl & F_ELIG) for lane in lanes]
            if fl & F_SEARCH:
                key = [(greedy_rank[lane] if greedy else (w >> (4 * (lane & 15))) & 15)
                       if fits[lane] else NO_RANK for lane in lanes]
                least = min(key)
                run = [False] * 32
                for lane in lanes:
                    if key[lane] < NO_RANK and key[lane] == least:
                        run[lane] = may_run[lane]
                        s_flags[row] = fl | F_NEWLY | (lane << 8) | (F_RUN if run[lane] else 0)
            else:
                run = [lane == w and fits[lane] and may_run[lane] for lane in lanes]
                if any(run):
                    s_flags[row] = fl | F_RUN
            for lane in lanes:
                if run[lane]:
                    left[lane] -= k
        for row in range(n):                                    # write-out
            if not walk[row]:
                continue
            fl, r = s_flags[row], s_flags[row] >> 8 & 15
            out["take"][cell][row] = bool(fl & F_RUN)
            if fl & F_NEWLY:
                out["placed"][cell][row], out["pol"][cell][row] = True, r
            if fl & F_RUN and fl & F_ENG:
                out["eng"][cell][row] = r if fl & F_SEARCH else s_word[row]
    return tuple(torch.tensor(out[k]) for k in ("take", "placed", "pol", "eng", "migl",
                                                 "moves", "mig"))


@pytest.mark.parametrize("kind", geo_walk.KINDS)
@pytest.mark.parametrize("regions", [2, 3, 10])
@pytest.mark.parametrize("mixed", [False, True], ids=["uniform-k", "mixed-k"])
def test_kernel_model_matches_the_plain_walk(kind, regions, mixed):
    hits = dict(mig=0, newly=0, take=0)
    for seed in range(4):
        args = _geo_inputs(seed, kind, 3, 200, regions, "cpu", mixed)
        want = geo_walk.geo_resolve(kind, *args)
        got = kernel_model(kind, *args)
        for name, a, w in zip(("take", "placed", "pol_region", "eng_region",
                               "mig_left", "moves", "mig_now"), got, want):
            assert torch.equal(a.to(w.dtype), w), (name, seed)
        hits["mig"] += int(want[6].sum())
        hits["newly"] += int((want[1] & ~args[2]["placed"]).sum())
        hits["take"] += int(want[0].sum())
    assert hits["take"] > 0
    if kind != "geo-static":
        assert hits["mig"] > 0 and hits["newly"] > 0


@pytest.mark.parametrize("kind", geo_walk.KINDS)
@pytest.mark.parametrize("regions", [2, 3, 10, 16])
@pytest.mark.parametrize("mixed", [False, True], ids=["uniform-k", "mixed-k"])
def test_compact_model_matches_the_plain_walk(kind, regions, mixed):
    hits = dict(mig=0, newly=0, take=0)
    for seed in range(3):
        args = _geo_inputs(seed, kind, 3, 200, regions, "cpu", mixed)
        want = geo_walk.geo_resolve(kind, *args)
        got = compact_model(kind, *args)
        for name, a, w in zip(("take", "placed", "pol_region", "eng_region",
                               "mig_left", "moves", "mig_now"), got, want):
            assert torch.equal(a.to(w.dtype), w), (name, seed)
        hits["mig"] += int(want[6].sum())
        hits["newly"] += int((want[1] & ~args[2]["placed"]).sum())
        hits["take"] += int(want[0].sum())
    assert hits["take"] > 0
    if kind != "geo-static":
        assert hits["mig"] > 0 and hits["newly"] > 0


@pytest.mark.parametrize("kind", geo_walk.KINDS)
@pytest.mark.parametrize("case", ["nothing fits", "all forced", "one row", "odd width"])
def test_compact_model_edge_cases(kind, case):
    b, n, kw = 3, 256, {}
    if case == "nothing fits":
        kw["nothing_fits"] = True
    elif case == "one row":
        n = 1
    elif case == "odd width":
        n = 333
    args = _geo_inputs(11, kind, b, n, 4, "cpu", mixed=True, **kw)
    if case == "all forced":
        args[1].fill_(True)
    want = geo_walk.geo_resolve(kind, *args)
    for a, w in zip(compact_model(kind, *args), want):
        assert torch.equal(a.to(w.dtype), w)
    if case == "nothing fits":
        assert not want[0].any()


@pytest.mark.parametrize("means", [[3.0, 1.0, 2.0], [5.0] * 16, list(range(16, 0, -1)),
                                   [2.0, 1.0, 2.0, 1.0, 0.5], [7.0]])
def test_flex_ranks_are_the_stable_sort(means):
    ranks = flex_ranks(means)
    got = [(ranks >> (4 * r)) & 15 for r in range(len(means))]
    order = sorted(range(len(means)), key=means.__getitem__)
    assert got == [order.index(r) for r in range(len(means))]


@pytest.mark.parametrize("kind", geo_walk.KINDS)
def test_plain_walk_when_nothing_fits(kind):
    cand, forced, state, consts, tables = _geo_inputs(7, kind, 2, 128, 4, "cpu",
                                                      nothing_fits=True)
    take, placed, polr, engr, migl, moves, mig_now = geo_walk.geo_resolve(
        kind, cand, forced, state, consts, tables)
    assert not take.any()
    # nothing placed where nothing fits (geo-greedy adopts the region of a
    # started row it had not placed)
    newly = placed & ~state["placed"] & ~mig_now & ~state["started"]
    assert not newly.any()
    still = ~cand
    for got, before in ((placed, state["placed"]), (polr, state["pol_region"]),
                        (engr, state["eng_region"]), (migl, state["mig_left"]),
                        (moves, state["moves"])):
        assert torch.equal(got[still], before[still])
    for got in kernel_model(kind, cand, forced, state, consts, tables)[:1]:
        assert not got.any()


def test_geo_resolve_refuses_an_unknown_kind():
    args = _geo_inputs(0, "geo-static", 1, 8, 2, "cpu")
    with pytest.raises(ValueError, match="geo kind"):
        geo_walk.geo_resolve("geo-other", *args)
