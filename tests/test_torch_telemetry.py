"""The port's telemetry layer (``repro_torch/telemetry/``) and its
``telemetry=`` argument through every engine and entry point, against the
JAX package.

The same seeds build the same worlds in both packages, and everything is
compared with ``==`` (host float64 throughout, no tolerance):

- the recorder, the tracker and the fault decode on the same calls;
- the event streams, tuple for tuple with the run label, of the port's
  vector, scalar and scan (``device="cpu"``) engines against ``repro``'s
  vector engine: single-region policies, carbonflex with its knowledge
  base, the three fault kinds, DAG worlds, geo worlds with migrations, a
  carbon-feed outage, serving tier switches, and a scan tile's member
  against the same cell run alone; the scan decode's suspend order on a
  job list whose ids fall with arrival;
- recording changes no result, and the four golden fixtures stay byte for
  byte with a recorder attached;
- ``attribute`` bit for bit (NaN as NaN, the same exception where
  ``repro`` raises), the subnormal-baseline example pinned, on real sweeps
  too; the profiler; ``run()`` and ``Sweep`` with their labels and phases;
  ``explain()``'s text.

The reference's scan engine cannot run on this tree, so its vector engine
is the yardstick for every stream.
"""
import dataclasses
import json
import math
import os

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.telemetry as rt
from repro.core import simulate as ref_simulate
from repro.core.faults import SlotDisturbance as RefSlotDisturbance
from repro.core.faults import CarbonDataOutage as RefCarbonDataOutage
from repro.experiment import Scenario as RefScenario
from repro.experiment import Sweep as RefSweep
from repro.experiment import prepare_context as ref_prepare_context
from repro.experiment import run as ref_run
from repro.core.mpc import MPCConfig as RefMPCConfig
from repro.experiment.registry import make_policy as ref_make_policy
from repro.serving import ServeCase as RefServeCase
from repro.serving import ServingConfig as RefServingConfig
from repro.serving import simulate_serving as ref_simulate_serving
from repro.traces import DagConfig as RefDagConfig
import repro_torch.telemetry as pt
from repro_torch.core import faults, scan_engine
from repro_torch.core.faults import CarbonDataOutage, SlotDisturbance
from repro_torch.core.mpc import MPCConfig
from repro_torch.core.simulator import SimCase, simulate, simulate_many
from repro_torch.experiment import Scenario, Sweep, prepare_context, run
from repro_torch.experiment.registry import make_policy
from repro_torch.serving import ServeCase, ServingConfig, simulate_serving
from repro_torch.traces import DagConfig

WEEK = 24 * 7
ENGINES = ("vector", "scalar", "scan")
BASE = dict(capacity=8, learn_weeks=1, family="alibaba", seed=101)
DATA = os.path.join(os.path.dirname(__file__), "data")


PAIRED = ("dag", "ci_outage", "serving", "mpc")


def worlds(**kw):
    """The same materialized world in both packages (``kw`` given per
    package as (ref value, port value) pairs where the types differ)."""
    rkw = {k: (v[0] if isinstance(v, tuple) and len(v) == 2
               and k in PAIRED else v)
           for k, v in kw.items()}
    pkw = {k: (v[1] if isinstance(v, tuple) and len(v) == 2
               and k in PAIRED else v)
           for k, v in kw.items()}
    return (RefScenario(**{**BASE, **rkw}).materialize(),
            Scenario(**{**BASE, **pkw}).materialize())


def contexts(rmat, pmat, names):
    return (ref_prepare_context(rmat, names),
            prepare_context(pmat, names, device="cpu"))


def ref_stream(mat, policy, **kw):
    """``repro``'s vector engine with a recorder: (events, result)."""
    tel = rt.Telemetry(recorder=rt.MemoryRecorder(), run_label="cell")
    ci, cluster = (mat.mci, mat.geo) if mat.is_geo else (mat.ci, mat.cluster)
    res = ref_simulate(mat.eval_jobs, ci, cluster, policy, t0=mat.t0,
                       horizon=WEEK, engine="vector", telemetry=tel, **kw)
    return [tuple(e) for e in tel.recorder.events], res


def port_stream(mat, policy, engine, **kw):
    tel = pt.Telemetry(recorder=pt.MemoryRecorder(), run_label="cell")
    ci, cluster = (mat.mci, mat.geo) if mat.is_geo else (mat.ci, mat.cluster)
    res = simulate(mat.eval_jobs, ci, cluster, policy, t0=mat.t0, horizon=WEEK,
                   engine=engine, telemetry=tel, device="cpu", **kw)
    return [tuple(e) for e in tel.recorder.events], res


def same_result(a, b) -> bool:
    return json.dumps(a.to_dict(), sort_keys=True) == json.dumps(
        b.to_dict(), sort_keys=True)


# --- recorder / tracker units -------------------------------------------------


def test_exports_and_vocabularies_equal_the_reference():
    assert pt.__all__ == rt.__all__
    assert pt.EVENT_KINDS == rt.EVENT_KINDS
    assert pt.CAUSES == rt.CAUSES
    assert pt.PHASES == rt.PHASES
    assert pt.TraceEvent._fields == rt.TraceEvent._fields
    assert issubclass(pt.TraceEvent, tuple)


def test_emit_is_noop_without_recorder():
    tel = pt.Telemetry()
    tel.emit(0, "admit", job=1)
    assert tel.recorder is None
    assert isinstance(pt.MemoryRecorder(), pt.TraceRecorder)


def test_for_run_stamps_label_on_shared_recorder():
    got = []
    for pkg in (pt, rt):
        rec = pkg.MemoryRecorder()
        tel = pkg.Telemetry(recorder=rec)
        tel.for_run("a").emit(0, "admit", job=1)
        tel.for_run("b").emit(1, "admit", job=2)
        got.append(([tuple(e) for e in rec.events], len(rec.for_run("a")),
                    rec.counts(run="b")))
    assert got[0] == got[1]
    assert got[0][0][1][-1] == "b"


def test_memory_recorder_queries_and_clear():
    got = []
    for pkg in (pt, rt):
        rec = pkg.MemoryRecorder()
        tel = pkg.Telemetry(recorder=rec)
        tel.emit(0, "admit", job=1)
        tel.emit(1, "suspend", job=1)
        tel.emit(2, "resume", job=1, value=2.0)
        tel.emit(3, "tier-switch", value=1.0, detail="from=0")
        out = (rec.counts(), [e.t for e in rec.by_kind("suspend")], len(rec),
               [e.to_dict() for e in rec.events])
        rec.clear()
        got.append(out + (len(rec),))
    assert got[0] == got[1]
    assert list(got[0][0]) == ["admit", "suspend", "resume", "tier-switch"]


@pytest.mark.parametrize("feed", ["lists", "iterators"])
def test_tracker_derives_lifecycle_events(feed):
    """Starts, a scale-up, a suspend, a resume and a finish: the same
    events as the reference's tracker, on its fast path (lists) and its
    full walk (iterators)."""
    streams = [([1, 2], [2, 4]), ([1, 2], [2, 8]), ([2], [8]), ([1, 2], [2, 8])]
    got = []
    for pkg in (pt, rt):
        rec = pkg.MemoryRecorder()
        tr = pkg.SlotEventTracker(pkg.Telemetry(recorder=rec))
        tr.admit(0, 1)
        for t, (ids, ks) in enumerate(streams):
            if feed == "iterators":
                ids, ks = iter(ids), iter(ks)
            tr.step(t, ids, ks)
        tr.finish(2)
        tr.step(4, [1], [2])
        got.append([tuple(e) for e in rec.events])
    assert got[0] == got[1]
    assert [(e[1], e[2]) for e in got[0]] == [
        ("admit", 1), ("scale", 2), ("suspend", 1), ("resume", 1)]
    assert got[0][1][3:5] == (8.0, "from=4")


def test_tracker_steady_state_fast_path_changes_nothing():
    streams = [([1, 2], [2, 4]), ([1, 2], [2, 4]), ([1, 2], [2, 4]),
               ([2], [4]), ([1, 2], [2, 4]), ([1, 2], [3, 4]), ([3, 1], [1, 0])]
    fast, slow = pt.MemoryRecorder(), pt.MemoryRecorder()
    trf = pt.SlotEventTracker(pt.Telemetry(recorder=fast))
    trs = pt.SlotEventTracker(pt.Telemetry(recorder=slow))
    for t, (ids, ks) in enumerate(streams):
        trf.step(t, ids, ks)
        trs.step(t, iter(ids), iter(ks))
    assert fast.events == slow.events
    assert [e.kind for e in fast.events] == ["suspend", "resume", "scale",
                                             "suspend", "suspend"]


@pytest.mark.parametrize("kind", ["preemption", "correlated", "iid"])
def test_fault_event_decoding(kind):
    got = []
    for pkg, dist_cls in ((pt, SlotDisturbance), (rt, RefSlotDisturbance)):
        rec = pkg.MemoryRecorder()
        dist = dist_cls(factors=np.array([1.0, 0.0, 0.5, 0.25]),
                        evicted=np.array([True, False, False, False]),
                        lost=np.array([0.0, 3.0, 0.0, 0.0]),
                        extra_energy=np.array([0.0, 0.25, 0.0, 0.0]))
        pkg.emit_fault_events(pkg.Telemetry(recorder=rec), 5, [10, 11, 12, 13],
                              dist, kind)
        got.append([tuple(e) for e in rec.events])
    assert got[0] == got[1]
    kinds = [(e[1], e[2], e[3]) for e in got[0]]
    head = [("evict", 10, None), ("preempt", 11, 3.0), ("restore", 11, 0.25)]
    if kind == "preemption":
        assert kinds == head + [("checkpoint", 12, 0.5), ("checkpoint", 13, 0.25)]
    else:
        assert kinds == head


# --- event streams: every engine against repro's vector engine ----------------


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", ["carbon-agnostic", "wait-awhile",
                                  "wait-awhile-robust", "carbonflex-mpc",
                                  "carbonflex-scale"])
def test_single_region_stream_parity(name, engine):
    # the MPC cells scale up in clean slots (carbonflex-scale's scale events)
    rmat, pmat = worlds(mpc=(RefMPCConfig(scale_rho=0.3), MPCConfig(scale_rho=0.3)))
    rctx, pctx = contexts(rmat, pmat, [name])
    want, rres = ref_stream(rmat, ref_make_policy(name, rctx))
    scan_engine.reset_stats()
    got, pres = port_stream(pmat, make_policy(name, pctx), engine)
    assert got == want
    assert same_result(pres, rres)
    assert want and all(e[1] == "admit" for e in want if e[0] == want[0][0])
    if engine == "scan":
        # the decode assumes k == k_min: a recorded scale cell leaves the loop
        scaled = name == "carbonflex-scale"
        assert scan_engine.stats["telemetry_delegated"] == int(scaled)
        assert (scan_engine.stats["steps"] > 0) == (not scaled)
        if scaled:
            assert any(e[1] == "scale" for e in got)


@pytest.mark.parametrize("engine", ENGINES)
def test_carbonflex_stream_parity_with_kb(engine):
    rmat, pmat = worlds()
    rctx, pctx = contexts(rmat, pmat, ["carbonflex"])
    want, rres = ref_stream(rmat, ref_make_policy("carbonflex", rctx))
    got, pres = port_stream(pmat, make_policy("carbonflex", pctx), engine)
    assert got == want and same_result(pres, rres)


FAULTS = {
    "iid": (lambda pkg: pkg.IidFaults(straggler_rate=0.2, failure_rate=0.05, seed=3),
            ()),
    "preemption": (lambda pkg: pkg.PreemptionFaults(rate=0.2, seed=3),
                   ("preempt", "restore", "checkpoint")),
    "correlated": (lambda pkg: pkg.CorrelatedFaults(n_domains=2, rate=0.1, seed=3),
                   ("evict",)),
}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("kind", sorted(FAULTS))
def test_fault_stream_parity(kind, engine):
    from repro.core import faults as ref_faults

    mk, expected = FAULTS[kind]
    rmat, pmat = worlds()
    rctx, pctx = contexts(rmat, pmat, ["wait-awhile"])
    want, rres = ref_stream(rmat, ref_make_policy("wait-awhile", rctx),
                            faults=mk(ref_faults))
    scan_engine.reset_stats()
    got, pres = port_stream(pmat, make_policy("wait-awhile", pctx), engine,
                            faults=mk(faults))
    assert got == want and same_result(pres, rres)
    kinds = {e[1] for e in want}
    assert all(k in kinds for k in expected), kinds
    if engine == "scan":
        assert scan_engine.stats["fault_delegated"] == 1


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", ["dag-fcfs", "dag-carbon", "dag-cap"])
def test_dag_stream_parity(name, engine):
    rmat, pmat = worlds(dag=(RefDagConfig(width=3, depth=3), DagConfig(width=3, depth=3)))
    rctx, pctx = contexts(rmat, pmat, [name])
    want, rres = ref_stream(rmat, ref_make_policy(name, rctx))
    scan_engine.reset_stats()
    got, pres = port_stream(pmat, make_policy(name, pctx), engine)
    assert got == want and same_result(pres, rres)
    if engine == "scan":
        assert scan_engine.stats["dag_steps"] > 0
    # release admissions: tasks admitted after their arrival slot
    arrival = {j.job_id: max(j.arrival, pmat.t0) for j in pmat.eval_jobs}
    assert any(e[0] > arrival[e[2]] for e in got if e[1] == "admit")


def _shuffled_ids(jobs, seed):
    """The same jobs with job ids that fall with arrival (the port's rows
    sort by (arrival, job_id), so row order is no longer id order)."""
    order = sorted(jobs, key=lambda j: (j.arrival, j.job_id))
    ids = np.random.default_rng(seed).permutation(len(order)) + 1000
    return [dataclasses.replace(j, job_id=int(i)) for j, i in zip(order, ids)]


@pytest.mark.parametrize("name", ["wait-awhile", "carbonflex-mpc"])
def test_scan_suspends_follow_job_ids(name):
    """Each slot's suspends in job-id order, as the tracker emits them,
    where row order and id order disagree."""
    from repro.core.types import Job as RefJob

    rmat, pmat = worlds(capacity=4)
    pjobs = _shuffled_ids(pmat.eval_jobs, 7)
    rjobs = [RefJob(**{f.name: getattr(j, f.name) for f in dataclasses.fields(j)})
             for j in pjobs]
    rctx, pctx = contexts(rmat, pmat, [name])
    tels = {}
    results = {}
    for engine in ENGINES:
        tel = pt.Telemetry(recorder=pt.MemoryRecorder())
        results[engine] = simulate(pjobs, pmat.ci, pmat.cluster,
                                   make_policy(name, pctx), t0=pmat.t0,
                                   horizon=WEEK, engine=engine, telemetry=tel,
                                   device="cpu")
        tels[engine] = [tuple(e) for e in tel.recorder.events]
    rtel = rt.Telemetry(recorder=rt.MemoryRecorder())
    rres = ref_simulate(rjobs, rmat.ci, rmat.cluster, ref_make_policy(name, rctx),
                        t0=rmat.t0, horizon=WEEK, engine="vector", telemetry=rtel)
    want = [tuple(e) for e in rtel.recorder.events]
    for engine in ENGINES:
        assert tels[engine] == want, engine
        assert same_result(results[engine], rres), engine
    # the trap is live: some slot suspends several jobs whose row order is
    # not their id order
    row = {j.job_id: r for r, j in enumerate(sorted(
        pjobs, key=lambda j: (j.arrival, j.job_id)))}
    by_slot = {}
    for e in want:
        if e[1] == "suspend":
            by_slot.setdefault(e[0], []).append(e[2])
    assert any([row[j] for j in ids] != sorted(row[j] for j in ids)
               for ids in by_slot.values())


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", ["geo-static", "geo-greedy", "geo-flex"])
def test_geo_stream_parity_with_migrations(name, engine):
    rmat, pmat = worlds(regions=("california", "ontario"))
    rctx, pctx = contexts(rmat, pmat, [name])
    want, rres = ref_stream(rmat, ref_make_policy(name, rctx))
    scan_engine.reset_stats()
    got, pres = port_stream(pmat, make_policy(name, pctx), engine)
    assert got == want and same_result(pres, rres)
    migs = [e for e in got if e[1] == "migrate"]
    assert len(migs) == pres.migrations
    assert (len(migs) > 0) == (name != "geo-static")
    assert all(e[4].startswith("from=") and isinstance(e[3], float) for e in migs)
    if engine == "scan":
        assert scan_engine.stats["geo_steps"] > 0


OUTAGE = dict(rate=0.1, mean_duration=6.0, stale_after=3, seed=5)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("world", ["single", "dag", "geo"])
def test_outage_forecast_read_parity(world, engine):
    kw = dict(ci_outage=(RefCarbonDataOutage(**OUTAGE), CarbonDataOutage(**OUTAGE)))
    name = "wait-awhile"
    if world == "dag":
        kw["dag"] = (RefDagConfig(width=3, depth=3), DagConfig(width=3, depth=3))
        name = "dag-carbon"
    elif world == "geo":
        kw["regions"] = ("california", "ontario")
        name = "geo-flex"
    rmat, pmat = worlds(**kw)
    rctx, pctx = contexts(rmat, pmat, [name])
    want, rres = ref_stream(rmat, ref_make_policy(name, rctx))
    scan_engine.reset_stats()
    got, pres = port_stream(pmat, make_policy(name, pctx), engine)
    assert got == want and same_result(pres, rres)
    reads = [e for e in got if e[1] == "forecast-read"]
    assert reads and max(e[3] for e in reads) > 0
    assert all(type(e[3]) is float for e in reads)
    assert len(reads) == len(pres.slots)          # one per slot the run took
    if engine == "scan":
        assert scan_engine.stats["steps"] > 0      # ran natively


def test_no_forecast_read_on_a_fresh_feed():
    _, pmat = worlds()
    got, _ = port_stream(pmat, make_policy("wait-awhile", prepare_context(
        pmat, ["wait-awhile"], device="cpu")), "scan")
    assert got and not any(e[1] == "forecast-read" for e in got)


@pytest.mark.parametrize("engine", ["vector", "scalar"])
@pytest.mark.parametrize("outage", [False, True])
def test_serving_stream_parity_and_tier_switches(engine, outage):
    kw = dict(serving=(RefServingConfig(requests_per_day=2e5, servers=12),
                       ServingConfig(requests_per_day=2e5, servers=12)),
              capacity=12)
    if outage:
        kw["ci_outage"] = (RefCarbonDataOutage(**OUTAGE), CarbonDataOutage(**OUTAGE))
    rmat, pmat = worlds(**kw)
    rctx, pctx = contexts(rmat, pmat, ["serve-flex"])
    horizon = min(WEEK, pmat.serving.demand.shape[0] - pmat.t0)
    got = []
    for mat, ctx, case_cls, mk, sim, pkg in (
            (rmat, rctx, RefServeCase, ref_make_policy, ref_simulate_serving, rt),
            (pmat, pctx, ServeCase, make_policy, simulate_serving, pt)):
        tel = pkg.Telemetry(recorder=pkg.MemoryRecorder(),
                            profiler=pkg.PhaseProfiler(), run_label="serve")
        case = case_cls(demand=mat.serving.demand[mat.t0:mat.t0 + horizon],
                        rate=mat.serving.rate, ci=mat.ci, config=mat.serving.config,
                        policy=mk("serve-flex", ctx), t0=mat.t0)
        res = sim(case, engine="vector" if pkg is rt else engine, telemetry=tel)
        got.append(([tuple(e) for e in tel.recorder.events],
                    json.dumps(res.to_dict(), sort_keys=True),
                    tel.profiler.calls))
    assert got[0][:2] == got[1][:2]
    assert any(e[1] == "tier-switch" for e in got[1][0])
    assert any(e[1] == "forecast-read" for e in got[1][0]) == outage
    # the vector path brackets its bulk accounting once more
    assert got[1][2] == {"decide": horizon,
                         "execute": horizon + (engine == "vector")}


def test_serve_case_telemetry_field_records():
    pmat = Scenario(**{**BASE, "capacity": 12}, serving=ServingConfig(
        requests_per_day=2e5, servers=12)).materialize()
    pctx = prepare_context(pmat, ["serve-flex"], device="cpu")
    tel = pt.Telemetry(recorder=pt.MemoryRecorder())
    case = ServeCase(demand=pmat.serving.demand[pmat.t0:pmat.t0 + WEEK],
                     rate=pmat.serving.rate, ci=pmat.ci, config=pmat.serving.config,
                     policy=make_policy("serve-flex", pctx), t0=pmat.t0,
                     telemetry=tel)
    simulate_serving(case)
    assert tel.recorder.by_kind("tier-switch")


@pytest.mark.parametrize("kind", ["thresh", "geo"])
def test_tile_member_stream_equals_the_cell_alone(kind):
    """A cell's decode reads its own row of the tile's grids, cut at its
    own length: the same stream as the cell run alone; each member's
    profiler gets its share of the tile's loop."""
    if kind == "geo":
        mats = [Scenario(**{**BASE, "seed": s}, regions=("california", "ontario"))
                .materialize() for s in (101, 102, 103)]
        names = ["geo-flex"]
    else:
        mats = [Scenario(**{**BASE, "seed": s}).materialize() for s in (101, 102, 103)]
        names = ["wait-awhile"]

    def case(mat, tel):
        ctx = prepare_context(mat, names, device="cpu")
        ci, cluster = (mat.mci, mat.geo) if mat.is_geo else (mat.ci, mat.cluster)
        return SimCase(jobs=mat.eval_jobs, ci=ci, cluster=cluster,
                       policy=make_policy(names[0], ctx), t0=mat.t0, horizon=WEEK,
                       engine="scan", telemetry=tel, device="cpu")

    alone = []
    for mat in mats:
        tel = pt.Telemetry(recorder=pt.MemoryRecorder(), run_label="x")
        res = simulate_many([case(mat, tel)])[0]
        alone.append(([tuple(e) for e in tel.recorder.events], res))
    rec = pt.MemoryRecorder()
    profs = [pt.PhaseProfiler() for _ in mats]
    scan_engine.reset_stats()
    tiled = simulate_many([case(mat, pt.Telemetry(recorder=rec, profiler=p,
                                                  run_label=f"c{i}"))
                           for i, (mat, p) in enumerate(zip(mats, profs))])
    assert scan_engine.stats["cell_steps"] == 3 * scan_engine.stats["steps"] > 0
    for i, ((events, res), got) in enumerate(zip(alone, tiled)):
        assert [tuple(e)[:5] for e in rec.for_run(f"c{i}")] == [e[:5] for e in events]
        assert same_result(got, res)
        assert profs[i].calls == {"decide": 1, "execute": 1}
    assert profs[0].seconds["decide"] == profs[2].seconds["decide"]


# --- recording is observation-only --------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("world", ["single", "dag", "geo", "faulted"])
def test_recording_does_not_change_results(world, engine):
    kw, name = {}, "wait-awhile"
    if world == "dag":
        kw["dag"] = DagConfig(width=3, depth=3)
        name = "dag-cap"
    elif world == "geo":
        kw["regions"] = ("california", "ontario")
        name = "geo-flex"

    def fault():
        return (faults.PreemptionFaults(rate=0.2, seed=3) if world == "faulted"
                else None)

    mat = Scenario(**BASE, **kw).materialize()
    ctx = prepare_context(mat, [name], device="cpu")
    ci, cluster = (mat.mci, mat.geo) if mat.is_geo else (mat.ci, mat.cluster)
    base = simulate(mat.eval_jobs, ci, cluster, make_policy(name, ctx), t0=mat.t0,
                    horizon=WEEK, faults=fault(), engine=engine, device="cpu")
    tel = pt.Telemetry(recorder=pt.MemoryRecorder(), profiler=pt.PhaseProfiler())
    res = simulate(mat.eval_jobs, ci, cluster, make_policy(name, ctx), t0=mat.t0,
                   horizon=WEEK, faults=fault(), engine=engine, device="cpu",
                   telemetry=tel)
    assert same_result(res, base)
    assert len(tel.recorder) > 0
    assert set(tel.profiler.seconds) == {"decide", "execute"}


def _golden(name, engine):
    from test_torch_sweep import golden

    sw = golden(name)
    return dataclasses.replace(sw, base=dataclasses.replace(sw.base, engine=engine))


@pytest.mark.parametrize("engine", ["vector", "scan"])
@pytest.mark.parametrize("name", ["golden_sweep", "golden_sweep_dag",
                                  "golden_sweep_forecast", "golden_sweep_mpc"])
def test_golden_fixtures_byte_for_byte_with_a_recorder(name, engine):
    with open(os.path.join(DATA, name + ".json")) as f:
        want = f.read()
    tel = pt.Telemetry(recorder=pt.MemoryRecorder(), profiler=pt.PhaseProfiler())
    sw = dataclasses.replace(_golden(name, engine), telemetry=tel)
    scan_engine.reset_stats()
    res = sw.run()
    assert res.to_json() + "\n" == want
    runs = {e.run for e in tel.recorder.events}
    assert len(runs) == len(res.rows())
    assert {"provision", "learn", "decide", "execute"} <= set(tel.profiler.seconds)
    if engine == "scan" and name == "golden_sweep_mpc":
        assert scan_engine.stats["telemetry_delegated"] == 2    # the scale cells


# --- attribution ---------------------------------------------------------------


def _stub(policy, carbon, energy, mig=0.0, restore=None, serving=False):
    """``tests/test_telemetry.py::_stub``: a result with the aggregates
    ``attribute`` reads."""
    class _R:
        pass

    r = _R()
    r.policy = policy
    r.carbon_g = carbon
    r.energy_kwh = energy
    r.regions = None
    r.slots = []
    r.migration_carbon_g = mig
    r.resilience = None
    r.serving = object() if serving else None
    if restore is not None:
        class _Res:
            restore_energy_kwh = restore

        r.resilience = _Res()
    return r


def _same_float(a: float, b: float) -> bool:
    return (math.isnan(a) and math.isnan(b)) or (
        a == b and math.copysign(1.0, a) == math.copysign(1.0, b))


def _outcome(pkg, res, base):
    """``attribute`` then ``check()``: the fields, NaN kept, and the type of
    the exception either raises, if any."""
    att = pkg.attribute(res, base)
    try:
        att.check()
        raised = None
    except Exception as e:  # noqa: BLE001  (compared with the reference's)
        raised = type(e)
    return att, raised


def _assert_same_attribution(a, b):
    assert (a.policy, a.baseline) == (b.policy, b.baseline)
    for f in ("carbon_g", "baseline_carbon_g", "delta_g"):
        assert _same_float(getattr(a, f), getattr(b, f)), f
    assert list(a.causes) == list(b.causes) == list(pt.CAUSES)
    for c in pt.CAUSES:
        assert _same_float(a.causes[c], b.causes[c]), c
        assert type(a.causes[c]) is float


@settings(max_examples=300, deadline=None)
@given(bc=st.floats(0.0, 1e9), rc=st.floats(0.0, 1e9),
       be=st.floats(0.0, 1e6), re_=st.floats(0.0, 1e6),
       bm=st.floats(0.0, 1e6), rm=st.floats(0.0, 1e6),
       br=st.floats(0.0, 1e3), rr=st.floats(0.0, 1e3),
       serving=st.booleans())
def test_attribution_equals_the_reference_property(bc, rc, be, re_, bm, rm, br,
                                                   rr, serving):
    """``attribute`` bit for bit on the reference test's stubs: every cause,
    NaN as NaN, and ``check()`` raising where the reference's raises."""
    args = ((_stub("p", rc, re_, mig=rm, restore=rr, serving=serving),
             _stub("b", bc, be, mig=bm, restore=br, serving=serving)))
    att, raised = _outcome(pt, *args)
    ratt, rraised = _outcome(rt, *args)
    _assert_same_attribution(att, ratt)
    assert raised is rraised
    assert att.to_dict() == ratt.to_dict() or raised is not None
    if raised is None:
        assert att.table() == ratt.table()


def test_attribution_subnormal_baseline_energy_is_reproduced():
    """The reference's fault, reproduced and not repaired: a subnormal
    baseline energy makes ``ci_ref`` infinite, the causes NaN, and
    ``check()`` raise, in both packages."""
    args = (_stub("p", 0.0, 0.0, mig=0.0, restore=0.0),
            _stub("b", 1.0, 5e-324, mig=0.0, restore=0.0))
    att, raised = _outcome(pt, *args)
    ratt, rraised = _outcome(rt, *args)
    _assert_same_attribution(att, ratt)
    assert raised is rraised is ArithmeticError
    for c in ("temporal_shifting", "capacity_scaling", "fault_restore"):
        assert math.isnan(att.causes[c])
    assert math.isnan(att.delta_g)
    with pytest.raises(ArithmeticError, match="not additive"):
        att.check()


def test_attribution_fixed_twin():
    got = []
    for pkg in (pt, rt):
        att = pkg.attribute(_stub("carbonflex", 700.0, 9.0),
                            _stub("carbon-agnostic", 1000.0, 10.0))
        att.check()
        got.append((att.to_dict(), att.table(), att.savings_pct,
                    att.pp_of_baseline("capacity_scaling")))
    assert got[0] == got[1]
    assert got[0][0]["causes"]["capacity_scaling"] == 100.0
    assert got[0][0]["causes"]["temporal_shifting"] == 200.0


@pytest.mark.parametrize("grid", ["batch", "faults", "geo", "serving"])
def test_sweep_attributions_equal_the_reference(grid):
    from repro.core import faults as ref_faults

    kw, rkw, policies, sweep_kw, rsweep_kw = {}, {}, [
        "carbon-agnostic", "wait-awhile", "carbonflex-mpc"], {}, {}
    if grid == "faults":
        sweep_kw = dict(faults=[None, faults.PreemptionFaults(rate=0.2, seed=3)])
        rsweep_kw = dict(faults=[None, ref_faults.PreemptionFaults(rate=0.2, seed=3)])
    elif grid == "geo":
        kw = rkw = dict(regions=("california", "ontario"))
        policies = ["geo-static", "geo-greedy", "geo-flex"]
    elif grid == "serving":
        kw = dict(serving=ServingConfig(requests_per_day=2e5, servers=12))
        rkw = dict(serving=RefServingConfig(requests_per_day=2e5, servers=12))
        policies = ["serve-static", "serve-flex"]
    res = Sweep(base=Scenario(**BASE, **kw), seeds=[11], policies=policies,
                device="cpu", **sweep_kw).run()
    rres = RefSweep(base=RefScenario(**BASE, **rkw), seeds=[11], policies=policies,
                    **rsweep_kw).run()
    atts, ratts = res.attributions(), rres.attributions()
    assert len(atts) == len(ratts) > 0
    for a, b in zip(atts, ratts):
        _assert_same_attribution(a, b)
        assert a.to_dict() == b.to_dict()
    if grid == "serving":
        assert atts[0].causes["capacity_scaling"] == 0.0
        assert atts[0].causes["precision_tiering"] != 0.0
    if grid == "geo":
        assert any(a.causes["geo_placement"] != 0.0 for a in atts)
    if grid == "faults":
        assert any(a.causes["fault_restore"] != 0.0 for a in atts)


def test_attributions_need_in_memory_results():
    res = Sweep(base=Scenario(**BASE), seeds=[11], policies=["wait-awhile"],
                device="cpu").run()
    with pytest.raises(ValueError, match="in-memory"):
        type(res).from_json(res.to_json()).attributions()


# --- profiler, run(), Sweep, explain() -----------------------------------------


def test_profiler_brackets_and_summary():
    import torch

    prof = pt.PhaseProfiler()
    with prof.phase("decide"):
        pass
    with prof.phase("decide", sync=torch.zeros(3)):
        pass
    with prof.phase("execute", sync={"a": [np.zeros(3), None]}):
        pass
    prof.add("custom", 0.5)
    s = prof.summary()
    assert list(s) == ["decide", "execute", "custom"]
    assert s["decide"]["calls"] == 2
    assert abs(sum(d["share"] for d in s.values()) - 1.0) < 1e-9
    assert prof.total() >= 0.5
    rprof = rt.PhaseProfiler()
    rprof.seconds, rprof.calls = dict(prof.seconds), dict(prof.calls)
    assert prof.table() == rprof.table()
    assert prof.summary() == rprof.summary()
    pt.PhaseProfiler.sync([torch.ones(2), np.ones(2)])      # CPU: no wait


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with pt.PhaseProfiler().trace():                         # off: passthrough
        pass
    prof = pt.PhaseProfiler(trace_dir=str(tmp_path / "trace"))
    with prof.trace():
        torch.ones(8).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


@pytest.mark.parametrize("engine", ["vector", "scan"])
def test_run_surfaces_labels_phases_and_progress(engine):
    """``run()``: every dispatch under ``"{policy}/w{week}"``, the four
    phases, the progress lines and ``to_dict``, against the reference's
    vector engine."""
    names = ["carbon-agnostic", "wait-awhile", "carbonflex"]
    sc = dict(BASE, eval_weeks=2)
    lines, rlines = [], []
    tel = pt.Telemetry(recorder=pt.MemoryRecorder(), profiler=pt.PhaseProfiler())
    rtel = rt.Telemetry(recorder=rt.MemoryRecorder(), profiler=rt.PhaseProfiler())
    res = run(Scenario(**sc, engine=engine), names, device="cpu",
              progress=lines.append, telemetry=tel)
    rres = ref_run(RefScenario(**sc), names, progress=rlines.append, telemetry=rtel)
    assert by_run(tel.recorder.events) == by_run(rtel.recorder.events)
    if engine == "vector":
        assert tel.recorder.events == [tuple(e) for e in rtel.recorder.events]
    assert {e.run for e in tel.recorder.events} == {
        f"{n}/w{w}" for n in names for w in range(2)}
    assert lines == rlines and len(lines) == 2
    assert set(tel.profiler.seconds) == {"provision", "learn", "decide", "execute"}
    assert tel.profiler.calls["learn"] == rtel.profiler.calls["learn"] == 2
    assert tel.profiler.calls["provision"] == 1
    d, rd = res.to_dict(), rres.to_dict()
    assert d["policies"] == rd["policies"] and d["kb_size"] == rd["kb_size"]
    assert d["scenario"] == dict(rd["scenario"], engine=engine)
    assert set(d) == set(rd)


def test_run_serving_records_tier_switches_under_week_labels():
    sc = dict(serving=ServingConfig(requests_per_day=2e5, servers=12),
              learn_weeks=1, seed=101, eval_weeks=2)
    rsc = dict(sc, serving=RefServingConfig(requests_per_day=2e5, servers=12))
    lines, rlines = [], []
    tel = pt.Telemetry(recorder=pt.MemoryRecorder(), profiler=pt.PhaseProfiler())
    rtel = rt.Telemetry(recorder=rt.MemoryRecorder())
    run(Scenario(**sc), device="cpu", progress=lines.append, telemetry=tel)
    ref_run(RefScenario(**rsc), progress=rlines.append, telemetry=rtel)
    assert [tuple(e) for e in tel.recorder.events] == \
        [tuple(e) for e in rtel.recorder.events]
    assert lines == rlines
    assert "serve-flex/w1" in {e.run for e in tel.recorder.by_kind("tier-switch")}


def by_run(events) -> dict:
    """Each run label's events, in emission order.  The scan engine runs a
    grid's delegated cells before its batched tiles, so only the vector
    engine keeps the reference's order across cells."""
    out: dict = {}
    for e in events:
        out.setdefault(e.run, []).append(tuple(e))
    return out


@pytest.mark.parametrize("engine", ["vector", "scan"])
def test_sweep_records_each_cell_under_its_label(engine):
    from repro.core import faults as ref_faults

    names = ["carbon-agnostic", "wait-awhile", "carbonflex-mpc"]
    fm = [None, faults.CorrelatedFaults(n_domains=2, rate=0.1, seed=3)]
    rfm = [None, ref_faults.CorrelatedFaults(n_domains=2, rate=0.1, seed=3)]
    tel = pt.Telemetry(recorder=pt.MemoryRecorder(), profiler=pt.PhaseProfiler())
    rtel = rt.Telemetry(recorder=rt.MemoryRecorder())
    res = Sweep(base=Scenario(**BASE, engine=engine), seeds=[11, 12], policies=names,
                faults=fm, telemetry=tel, device="cpu").run()
    rres = RefSweep(base=RefScenario(**BASE), seeds=[11, 12], policies=names,
                    faults=rfm, telemetry=rtel).run()
    assert res.to_json() == rres.to_json()
    assert by_run(tel.recorder.events) == by_run(rtel.recorder.events)
    if engine == "vector":
        assert tel.recorder.events == [tuple(e) for e in rtel.recorder.events]
    assert len(by_run(tel.recorder.events)) == len(res.rows()) == 12
    assert tel.profiler.calls["provision"] == tel.profiler.calls["learn"] == 2


def test_explain_text_equals_the_reference():
    rmat, pmat = worlds(regions=("california", "ontario"))
    texts = []
    for mat, pkg, sim, mk, ctx in (
            (rmat, rt, ref_simulate, ref_make_policy,
             ref_prepare_context(rmat, ["geo-static", "geo-flex"])),
            (pmat, pt, simulate, make_policy,
             prepare_context(pmat, ["geo-static", "geo-flex"], device="cpu"))):
        tel = pkg.Telemetry(recorder=pkg.MemoryRecorder(), run_label="flex")
        kw = {} if pkg is rt else {"device": "cpu"}
        base = sim(mat.eval_jobs, mat.mci, mat.geo, mk("geo-static", ctx), t0=mat.t0,
                   horizon=WEEK, **kw)
        res = sim(mat.eval_jobs, mat.mci, mat.geo, mk("geo-flex", ctx), t0=mat.t0,
                  horizon=WEEK, telemetry=tel, **kw)
        texts.append(pkg.explain(res, baseline=base, recorder=tel.recorder,
                                 run="flex"))
        texts.append(pkg.explain(res, recorder=pkg.MemoryRecorder()))
    assert texts[0] == texts[2] and texts[1] == texts[3]
    assert "attribution:" in texts[2] and "migrate" in texts[2]
    assert "events: none recorded" in texts[3]
    prof = pt.PhaseProfiler()
    prof.add("decide", 1.0)
    assert "phases:" in pt.explain(res, profiler=prof)
