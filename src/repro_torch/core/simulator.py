"""CarbonFlex-Simulator: slot-level cluster engine (paper §5, §6).

Discrete-time simulation of a cloud cluster running elastic batch jobs
under a pluggable provisioning+scheduling policy.  Per slot:

  1. admit arrivals into the active set;
  2. ask the policy for ``(m_t, allocations)``;
  3. enforce the capacity invariant (sum of allocations <= min(m_t, M));
  4. advance job progress / waiting budgets;
  5. account energy (Eq. 2–3) and carbon (Eq. 1);
  6. record completions, waiting times and SLO violations.

The engine runs past the nominal window until all admitted jobs finish
(run-to-completion semantics shared by every policy in §6).

Precedence-aware workloads (``core/dag.py``): a job whose ``deps`` name
unfinished predecessors is *gated* — kept out of the active set, invisible
to the policy, burning no waiting budget.  When its last predecessor
completes at slot ``t`` it is *released* at ``t + 1``, and its slack and
deadline count from the release slot.  The vector engine keeps a packed
predecessor-count array decremented through a successor CSR on parent
completion; the scalar path mirrors it with per-job counters — both
bit-identical.

Three engines, bit-for-bit identical outputs:

- ``engine="vector"`` (default) — struct-of-arrays fast path: per-job
  state lives in packed numpy vectors (``remaining``, ``slack_left``,
  ``waited``, allocations), energy/carbon accounting is vectorised per
  slot, and arrivals admit through a sorted pointer.  Policies that
  implement the optional ``decide_packed(t, eng, ci, cluster)`` protocol
  skip the per-job Python path entirely; others are served lightweight
  array-backed ``ActiveJob`` views.
- ``engine="scalar"`` — the readable per-ActiveJob reference
  implementation, kept as the parity oracle;
- ``engine="scan"`` — the slot loop on the device (``core/scan_engine.py``)
  for the threshold-fill policies, the DAG gating through a CUDA kernel;
  every other policy, and every case with a fault process, delegates to
  the vector engine.

A fault process (``core/faults.py``) disturbs the engines through the same
calls in the same order: ``begin_slot`` and ``available_capacity`` before
the decision, ``apply`` over the allocated live jobs in row order after
the energy sum (its restore energy billed into the slot), then progress
scaled by its factors.  A carbon-feed outage changes only the view the
policies read (``ci.degraded()``); accounting reads the true trace.

``simulate_many`` batches a (seeds x regions x policies) sweep through
the engines, packing each distinct job list once.

A ``GeoCluster`` with a ``MultiRegionCarbonService`` runs the
multi-region engines (``_simulate_geo_vector`` / ``_simulate_geo_scalar``,
bit-identical; ``engine="scan"`` puts their slot loop on the device): per
slot the geo policy places, runs or migrates each job, and energy and
carbon are accounted per region (a fault process shrinks capacity per
region, ``available_capacity_vec``).  No DAG jobs on a geo cluster.  The
accounting stays float64 numpy on the host, operation for operation as in
the JAX package, so both packages give bit-identical results.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Sequence

import numpy as np
import torch

from . import emissions
from .carbon import CarbonService, MultiRegionCarbonService
from .faults import FaultModel, FaultProcess, ensure_fault_process  # noqa: F401
from .policy import Policy
from .scheduling import ActiveJob, EntryBlocks, apply_slot
from .types import (ClusterConfig, GeoCluster, Job, ResilienceMetrics,
                    SimResult, SlotLog)
from ..telemetry import SlotEventTracker, Telemetry, emit_fault_events

_EPS = 1e-9


def _count_degraded(ci_pol, t0: int, t_end: int) -> int:
    return sum(1 for t in range(t0, t_end) if ci_pol.staleness(t) > 0)


def _run_resilience(faults, ci_pol, ci, t0: int,
                    t_end: int) -> ResilienceMetrics | None:
    """Fold fault-process metrics and feed-degradation time into the
    ``SimResult.resilience`` record (None when neither is in play)."""
    resil = faults.run_metrics() if faults is not None else None
    if ci_pol is not ci:
        if resil is None:
            resil = ResilienceMetrics()
        resil = dataclasses.replace(
            resil, degraded_slots=_count_degraded(ci_pol, t0, t_end))
    return resil


def _telemetry_hooks(telemetry: Telemetry | None, faults):
    """(event facade, profiler, tracker, fault kind) for one engine run —
    all None/"" when telemetry is off, so the hot-loop guards stay single
    branches and the off path performs zero extra work."""
    if telemetry is None:
        return None, None, None, ""
    tele = telemetry if telemetry.recorder is not None else None
    tracker = SlotEventTracker(tele) if tele is not None else None
    kind = getattr(faults, "kind", "") if faults is not None else ""
    return tele, telemetry.profiler, tracker, kind


# --- packed job tables ------------------------------------------------------


class PackedJobs:
    """Static struct-of-arrays view of a (arrival, job_id)-sorted job list.

    Throughput/marginal lookups go through tables built with the *same*
    ``Job.throughput``/``Job.marginal`` calls the scalar engine makes, so
    gathered values are bit-identical to the scalar path."""

    __slots__ = ("jobs", "n", "job_ids", "arrival", "length", "queue",
                 "k_min", "k_max", "deadline", "elast", "power", "comm",
                 "thr_tab", "blocks", "id2row", "has_deps", "dl_span",
                 "pred0", "succ_ptr", "succ_rows")

    def __init__(self, jobs_sorted: list[Job]) -> None:
        self.jobs = jobs_sorted
        n = self.n = len(jobs_sorted)
        self.job_ids = np.array([j.job_id for j in jobs_sorted], dtype=np.int64)
        self.arrival = np.array([j.arrival for j in jobs_sorted], dtype=np.int64)
        self.length = np.array([j.length for j in jobs_sorted], dtype=np.float64)
        self.queue = np.array([j.queue for j in jobs_sorted], dtype=np.int64)
        self.k_min = np.array([j.k_min for j in jobs_sorted], dtype=np.int64)
        self.k_max = np.array([j.k_max for j in jobs_sorted], dtype=np.int64)
        self.deadline = np.array([j.deadline for j in jobs_sorted], dtype=np.int64)
        self.elast = np.array([j.elasticity() for j in jobs_sorted], dtype=np.float64)
        self.power = np.array([j.power for j in jobs_sorted], dtype=np.float64)
        self.comm = np.array([j.comm_size for j in jobs_sorted], dtype=np.float64)
        kmax_g = int(self.k_max.max()) if n else 0
        self.thr_tab = np.zeros((n, kmax_g + 1))
        for i, job in enumerate(jobs_sorted):
            for k in range(1, kmax_g + 1):
                self.thr_tab[i, k] = job.throughput(k)
        self.blocks = EntryBlocks.build(jobs_sorted)
        self.id2row = {j.job_id: i for i, j in enumerate(jobs_sorted)}
        # Precedence structure (DAG workloads, core/dag.py): initial
        # in-degree per row plus a successor CSR so parent completions can
        # decrement child counters without a per-slot scan.
        self.dl_span = self.deadline - self.arrival
        pred0 = np.zeros(n, dtype=np.int64)
        succ_lists: list[list[int]] = [[] for _ in range(n)]
        has_deps = False
        for i, job in enumerate(jobs_sorted):
            for d in job.deps:
                p = self.id2row.get(d)
                if p is None:
                    raise ValueError(
                        f"job {job.job_id} depends on job {d}, which is not "
                        f"in the submitted job list (DAGs must be submitted "
                        f"whole)")
                if p == i:
                    raise ValueError(f"job {job.job_id} depends on itself")
                has_deps = True
                pred0[i] += 1
                succ_lists[p].append(i)
        self.has_deps = has_deps
        self.pred0 = pred0
        self.succ_ptr = np.zeros(n + 1, dtype=np.int64)
        if n:
            np.cumsum([len(s) for s in succ_lists], out=self.succ_ptr[1:])
        self.succ_rows = np.array([s for lst in succ_lists for s in lst],
                                  dtype=np.int64)
        if has_deps:
            self._check_acyclic()

    def _check_acyclic(self) -> None:
        """Kahn's algorithm: a cycle would deadlock the gating (jobs never
        released), so reject it at pack time."""
        indeg = self.pred0.copy()
        order = list(np.flatnonzero(indeg == 0))
        i = 0
        while i < len(order):
            r = int(order[i])
            for s in self.succ_rows[self.succ_ptr[r]:self.succ_ptr[r + 1]]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    order.append(int(s))
            i += 1
        if len(order) != self.n:
            stuck = [int(self.job_ids[r])
                     for r in np.flatnonzero(indeg > 0)[:5]]
            raise ValueError(f"dependency cycle among jobs {stuck}")


def pack(jobs: list[Job]) -> PackedJobs:
    return PackedJobs(sorted(jobs, key=lambda j: (j.arrival, j.job_id)))


class _PackedActiveJob:
    """ActiveJob-compatible view over the engine's packed arrays.

    Dict-protocol policies (and ``on_completion`` hooks) read the same
    attribute names as the scalar ``ActiveJob``; reads resolve into the
    engine state, so views are always current without per-slot syncing."""

    __slots__ = ("_eng", "row", "job")

    def __init__(self, eng: "EngineState", row: int) -> None:
        self._eng = eng
        self.row = row
        self.job = eng.packed.jobs[row]

    @property
    def remaining(self) -> float:
        return self._eng.remaining[self.row]

    @property
    def slack_left(self) -> int:
        return self._eng.slack_left[self.row]

    @property
    def waited(self) -> int:
        return self._eng.waited[self.row]

    @property
    def started(self) -> bool:
        return bool(self._eng.started[self.row])

    @property
    def forced(self) -> bool:
        return self._eng.slack_left[self.row] <= 0

    @property
    def done(self) -> bool:
        return self._eng.remaining[self.row] <= _EPS


class EngineState:
    """Dynamic per-run state of the vector engine (exposed to
    ``decide_packed`` policies as their struct-of-arrays view)."""

    __slots__ = ("packed", "remaining", "slack_left", "waited", "started",
                 "in_system", "admitted", "rows", "_views", "pred_left",
                 "deadline_eff", "pending_release", "blocked")

    def __init__(self, packed: PackedJobs) -> None:
        self.packed = packed
        self.remaining = packed.length.copy()
        self.slack_left = np.array([j.delay for j in packed.jobs], dtype=np.int64)
        self.waited = np.zeros(packed.n, dtype=np.int64)
        self.started = np.zeros(packed.n, dtype=bool)
        self.in_system = np.zeros(packed.n, dtype=bool)
        self.admitted = 0                  # sorted-arrival admission pointer
        self.rows = np.zeros(0, dtype=np.int64)
        self._views: dict[int, _PackedActiveJob] = {}
        # DAG gating state (no-ops for independent jobs): per-row live
        # in-degree, release-adjusted deadlines, rows becoming admissible
        # next slot, and the count of arrival-passed-but-gated rows.
        self.pred_left = packed.pred0.copy()
        self.deadline_eff = packed.deadline.copy()
        self.pending_release: list[int] = []
        self.blocked = 0

    def view(self, row: int) -> _PackedActiveJob:
        v = self._views.get(row)
        if v is None:
            v = self._views[row] = _PackedActiveJob(self, row)
        return v

    def active_views(self) -> list[_PackedActiveJob]:
        return [self.view(r) for r in self.rows.tolist()]


def simulate(
    jobs: list[Job],
    ci: CarbonService | MultiRegionCarbonService,
    cluster: ClusterConfig | GeoCluster,
    policy: Policy,
    t0: int = 0,
    horizon: int | None = None,
    max_overrun: int = 24 * 21,
    faults: FaultProcess | None = None,
    engine: str = "vector",
    telemetry: Telemetry | None = None,
    device: str | torch.device = "cuda",
) -> SimResult:
    """One window under one policy.  ``faults`` is a fault process
    (``core/faults.py``) disturbing every slot; ``telemetry`` records the
    run's decision events and phase times (``repro_torch.telemetry``; None
    leaves every engine on its untouched path); ``device`` is where the scan
    engine runs its slot loop (a faulted case runs on the vector engine
    instead); the host engines ignore it."""
    if engine not in ("vector", "scalar", "scan"):
        raise ValueError(f"unknown engine {engine!r}")
    if isinstance(cluster, GeoCluster) and not isinstance(
            ci, MultiRegionCarbonService):
        raise TypeError("a GeoCluster needs a MultiRegionCarbonService")
    if engine == "scan":
        from .scan_engine import simulate_scan
        return simulate_scan(jobs, ci, cluster, policy, t0, horizon,
                             max_overrun, faults, telemetry=telemetry,
                             device=device)
    if isinstance(cluster, GeoCluster):
        fn = _simulate_geo_scalar if engine == "scalar" else _simulate_geo_vector
        return fn(jobs, ci, cluster, policy, t0, horizon, max_overrun, faults,
                  telemetry=telemetry)
    if engine == "scalar":
        return _simulate_scalar(jobs, ci, cluster, policy, t0, horizon,
                                max_overrun, faults, telemetry=telemetry)
    return _simulate_vector(jobs, ci, cluster, policy, t0, horizon,
                            max_overrun, faults, telemetry=telemetry)


# --- vector engine ----------------------------------------------------------


def _simulate_vector(
    jobs: list[Job],
    ci: CarbonService,
    cluster: ClusterConfig,
    policy: Policy,
    t0: int = 0,
    horizon: int | None = None,
    max_overrun: int = 24 * 21,
    faults: FaultProcess | None = None,
    packed: PackedJobs | None = None,
    telemetry: Telemetry | None = None,
) -> SimResult:
    horizon = int(horizon if horizon is not None else len(ci) - t0)
    if packed is None:
        packed = pack(jobs)
    ci_pol = ci.degraded()              # policies read the (maybe degraded)
    faults = ensure_fault_process(faults)  # view; accounting the true feed
    if faults is not None:
        faults.on_run_start(t0, cluster.capacity)
    tele, prof, tracker, fault_kind = _telemetry_hooks(telemetry, faults)
    policy.on_window_start(ci_pol, t0, horizon, packed.jobs, cluster)
    decide_packed = getattr(policy, "decide_packed", None)
    packed_safe = bool(getattr(policy, "packed_safe", False))

    eng = EngineState(packed)
    n = packed.n
    id2row = packed.id2row
    # per-server power: job-specific when set, cluster default otherwise
    power = np.where(packed.power > 0, packed.power, cluster.power_per_server)
    thr_tab = packed.thr_tab
    slot_h = cluster.slot_hours
    eta = cluster.eta_net

    wait = np.zeros(n)
    violations = np.zeros(n, dtype=bool)
    completion = np.full(n, -1, dtype=np.int64)
    arrival = packed.arrival

    logs: list[SlotLog] = []
    total_energy = 0.0
    total_carbon = 0.0
    has_deps = packed.has_deps
    t = t0
    t_end = t0 + horizon
    rows_dirty = True
    while t < t_end + max_overrun:
        admits = [] if tracker is not None else None
        if has_deps and eng.pending_release:
            # Tasks whose last predecessor completed last slot: released
            # now, with slack/deadline counting from the release slot.
            for r in eng.pending_release:
                eng.in_system[r] = True
                eng.deadline_eff[r] = t + packed.dl_span[r]
            if admits is not None:
                admits.extend(eng.pending_release)
            eng.blocked -= len(eng.pending_release)
            eng.pending_release.clear()
            rows_dirty = True
        while eng.admitted < n and arrival[eng.admitted] <= t:
            if has_deps and eng.pred_left[eng.admitted] > 0:
                eng.blocked += 1       # gated: enters via the release path
            else:
                eng.in_system[eng.admitted] = True
                if admits is not None:
                    admits.append(eng.admitted)
                rows_dirty = True
            eng.admitted += 1
        if admits:
            for r in sorted(admits):
                tracker.admit(t, int(packed.job_ids[r]))
        if rows_dirty:
            eng.rows = np.flatnonzero(eng.in_system)
            rows_dirty = False
        rows = eng.rows
        if (not len(rows) and eng.admitted == n and not eng.blocked
                and t >= t_end):
            break

        if faults is not None:
            faults.begin_slot(t)
            cap_t = faults.available_capacity(cluster.capacity)
        else:
            cap_t = cluster.capacity
        if tele is not None and ci_pol is not ci:
            tele.emit(t, "forecast-read", value=float(ci_pol.staleness(t)))

        if prof is not None:
            _pt = time.perf_counter()
        if decide_packed is not None:
            m_pol, kvec = decide_packed(t, eng, ci_pol, cluster)
            m_t = int(min(m_pol, cap_t))
            if packed_safe:
                # Compliance is a class-level invariant of the decider
                # (``packed_safe = True``: k in {0} | [k_min, k_max],
                # active rows only, total within the m_t it was shown), so
                # the per-slot guards reduce to one check that only fires
                # when faults shrank capacity below what the policy saw.
                bad = m_t < int(m_pol) and int(kvec.sum()) > m_t
            else:
                # Defensive: the scalar engine unconditionally clips every
                # allocation into [k_min, k_max] and trims over-capacity
                # totals; route any non-compliant packed allocation
                # through the same trimmer instead of gathering
                # out-of-table scales.
                bad = (int(kvec.sum()) > m_t
                       or bool(((kvec > 0) & ((kvec < packed.k_min)
                                              | (kvec > packed.k_max))).any()))
                if has_deps and not bad:
                    # A gated row must never run (engine invariant); the
                    # trimmer drops non-active allocations.
                    bad = bool((kvec[~eng.in_system] > 0).any())
            if bad:
                kvec = _kvec_enforced(kvec, eng, m_t)
        else:
            m_t, alloc = policy.decide(t, eng.active_views(), ci_pol, cluster)
            m_t = int(min(m_t, cap_t))
            alloc = _enforce_capacity(alloc, eng.active_views(), m_t)
            kvec = np.zeros(n, dtype=np.int64)
            for jid, k in alloc.items():
                kvec[id2row[jid]] = k
        if prof is not None:
            _now = time.perf_counter()
            prof.add("decide", _now - _pt)
            _pt = _now

        civ = ci.ci(t)
        k_rows = kvec[rows]
        live = eng.remaining[rows] > _EPS      # "not done", pre-progress
        arows = rows[k_rows > 0]               # energy: done jobs included,
        k_a = kvec[arows]                      # matching the scalar loop
        if tracker is not None:
            tracker.step(t, packed.job_ids[arows].tolist(), k_a.tolist())
        thr_a = thr_tab[arows, k_a]
        # Fractional final slot (paper footnote 4): only the work actually
        # needed is charged.  Each elementwise op mirrors the scalar
        # ``emissions.slot_energy_kwh`` expression order, so per-job values
        # (and hence the sequential slot sum) are bit-identical.
        frac = np.minimum(1.0, eng.remaining[arows] / np.maximum(thr_a, 1e-9))
        e_comp = k_a * power[arows] * slot_h * frac
        ring = np.where(k_a <= 1, 0.0, 2.0 * (k_a - 1) / k_a)
        gbits = packed.comm[arows] * 8.0 * ring * k_a * frac
        e_vec = e_comp + eta * gbits / 3600.0 / 1000.0 * slot_h
        energy = 0.0
        for v in e_vec.tolist():               # sequential sum, scalar order
            energy += v
        # fault disturbance over the allocated live jobs, row order (the
        # same sequence the scalar engine builds); restore/transfer energy
        # is billed into this slot, at this CI
        prows = rows[(k_rows > 0) & live]
        thr_p = thr_tab[prows, kvec[prows]]
        dist = None
        if faults is not None:
            dist = faults.apply(t, [packed.jobs[r] for r in prows.tolist()],
                                kvec[prows], eng.remaining[prows], thr_p)
            if dist.extra_energy is not None:
                for v in dist.extra_energy.tolist():
                    if v:
                        energy += v
            if tele is not None:
                emit_fault_events(tele, t, packed.job_ids[prows].tolist(),
                                  dist, fault_kind)
        carbon = emissions.slot_carbon_g(energy, civ)
        total_energy += energy
        total_carbon += carbon

        # advance progress; degraded slots scale each allocated job's
        # progress (energy was already charged: a slow/failed host still
        # burns power); unallocated live jobs spend waiting budget
        if dist is None:
            eng.remaining[prows] -= thr_p
        else:
            eng.remaining[prows] -= thr_p * dist.factors
            if dist.lost is not None:
                eng.remaining[prows] += dist.lost
        eng.started[prows] = True
        wrows = rows[(k_rows == 0) & live]
        eng.slack_left[wrows] -= 1
        eng.waited[wrows] += 1

        fin = rows[eng.remaining[rows] <= _EPS]
        if len(fin):
            completion[fin] = t
            wait[fin] = eng.waited[fin]
            violations[fin] = t > eng.deadline_eff[fin]
            for r in fin.tolist():
                policy.on_completion(t, eng.view(r), bool(violations[r]))
                if tracker is not None:
                    tracker.finish(int(packed.job_ids[r]))
                if has_deps:
                    for s in packed.succ_rows[
                            packed.succ_ptr[r]:packed.succ_ptr[r + 1]]:
                        eng.pred_left[s] -= 1
                        if eng.pred_left[s] == 0 and s < eng.admitted:
                            eng.pending_release.append(int(s))
            eng.in_system[fin] = False
            rows_dirty = True

        used = int(k_a.sum())
        running = len(arows)
        logs.append(SlotLog(slot=t, ci=civ, provisioned=m_t, used=used,
                            energy_kwh=energy, carbon_g=carbon,
                            running=running,
                            queued=len(rows) - len(fin) - running))
        if prof is not None:
            prof.add("execute", time.perf_counter() - _pt)
        t += 1

    return SimResult(
        policy=policy.name,
        carbon_g=total_carbon,
        energy_kwh=total_energy,
        slots=logs,
        wait_slots=wait,
        violations=violations,
        completion=completion,
        num_jobs=n,
        resilience=_run_resilience(faults, ci_pol, ci, t0, t),
    )


def _kvec_enforced(kvec: np.ndarray, eng: EngineState, m_t: int) -> np.ndarray:
    """Route an over-capacity packed allocation through the scalar trimmer."""
    alloc = {int(eng.packed.job_ids[r]): int(kvec[r])
             for r in np.flatnonzero(kvec)}
    alloc = _enforce_capacity(alloc, eng.active_views(), m_t)
    out = np.zeros_like(kvec)
    for jid, k in alloc.items():
        out[eng.packed.id2row[jid]] = k
    return out


# --- batch sweep API --------------------------------------------------------


@dataclasses.dataclass
class SimCase:
    """One (trace, CI, cluster, policy) configuration of a sweep.
    ``faults`` is the case's own fault process (a fresh instance per
    case: its RNG stream is the case's).  ``telemetry`` records the case's
    events and phase times.  ``device`` is where the scan engine runs its
    slot loop; the host engines ignore it.  A
    ``GeoCluster`` + ``MultiRegionCarbonService`` pair makes the case
    geo-distributed (multi-region engine, geo policy)."""

    jobs: list[Job]
    ci: CarbonService | MultiRegionCarbonService
    cluster: ClusterConfig | GeoCluster
    policy: Policy
    t0: int = 0
    horizon: int | None = None
    max_overrun: int = 24 * 21
    faults: FaultProcess | None = None
    label: str = ""
    engine: str = "vector"
    telemetry: Telemetry | None = None
    device: str | torch.device = "cuda"


def simulate_many(cases: Iterable[SimCase] | Sequence[SimCase]) -> list[SimResult]:
    """Run a (seeds x regions x policies) sweep through the engines.

    Each distinct ``jobs`` list is packed into its struct-of-arrays form
    exactly once (sorting, throughput/marginal tables, scheduling entry
    blocks), so per-configuration cost is the slot loop itself rather
    than per-configuration re-setup.  Cases whose ``cluster`` is a
    :class:`GeoCluster` run the multi-region engines.  Cases with
    ``engine="scan"`` go through ``scan_engine.simulate_many_scan``, which
    runs structurally identical cases as one batched device program."""
    cases = list(cases)
    for case in cases:
        if case.engine not in ("vector", "scalar", "scan"):
            raise ValueError(f"unknown engine {case.engine!r}")
    packs: dict[int, PackedJobs] = {}
    out: list[SimResult | None] = [None] * len(cases)
    scan_idx = [i for i, c in enumerate(cases) if c.engine == "scan"]
    if scan_idx:
        from .scan_engine import simulate_many_scan
        for i, res in zip(scan_idx, simulate_many_scan(
                [cases[i] for i in scan_idx], packs)):
            out[i] = res
    for i, case in enumerate(cases):
        if case.engine == "scan":
            continue
        geo = isinstance(case.cluster, GeoCluster)
        if case.engine == "scalar":
            fn = _simulate_geo_scalar if geo else _simulate_scalar
            out[i] = fn(case.jobs, case.ci, case.cluster, case.policy, case.t0,
                        case.horizon, case.max_overrun, case.faults,
                        telemetry=case.telemetry)
        else:
            fn = _simulate_geo_vector if geo else _simulate_vector
            out[i] = fn(case.jobs, case.ci, case.cluster, case.policy, case.t0,
                        case.horizon, case.max_overrun, case.faults,
                        packed=packed_for(case.jobs, packs),
                        telemetry=case.telemetry)
    return out


def packed_for(jobs: list[Job], packs: dict[int, PackedJobs]) -> PackedJobs:
    """``pack(jobs)``, once per job list in ``packs`` (keyed by identity)."""
    packed = packs.get(id(jobs))
    if packed is None:
        packed = packs[id(jobs)] = pack(jobs)
    return packed


# --- scalar reference engine ------------------------------------------------


def _simulate_scalar(
    jobs: list[Job],
    ci: CarbonService,
    cluster: ClusterConfig,
    policy: Policy,
    t0: int = 0,
    horizon: int | None = None,
    max_overrun: int = 24 * 21,
    faults: FaultProcess | None = None,
    telemetry: Telemetry | None = None,
) -> SimResult:
    horizon = int(horizon if horizon is not None else len(ci) - t0)
    jobs = sorted(jobs, key=lambda j: (j.arrival, j.job_id))
    ci_pol = ci.degraded()
    faults = ensure_fault_process(faults)
    if faults is not None:
        faults.on_run_start(t0, cluster.capacity)
    tele, prof, tracker, fault_kind = _telemetry_hooks(telemetry, faults)
    policy.on_window_start(ci_pol, t0, horizon, jobs, cluster)

    active: list[ActiveJob] = []
    n = len(jobs)
    next_arrival = 0                  # pointer into the arrival-sorted list
    wait = np.zeros(n)
    violations = np.zeros(n, dtype=bool)
    completion = np.full(n, -1, dtype=np.int64)
    id2row = {j.job_id: i for i, j in enumerate(jobs)}

    # DAG gating (mirrors the vector engine's packed predecessor counters;
    # see PackedJobs): live in-degree per job, successor adjacency,
    # release-adjusted deadlines, and tasks pending release next slot.
    has_deps = any(j.deps for j in jobs)
    pred_left: dict[int, int] = {}
    succ: dict[int, list[Job]] = {}
    deadline_eff: dict[int, int] = {}
    pending_release: list[Job] = []
    blocked = 0
    if has_deps:
        by_id = {j.job_id: j for j in jobs}
        pred_left = {j.job_id: 0 for j in jobs}
        succ = {j.job_id: [] for j in jobs}
        for j in jobs:
            for d in j.deps:
                if d not in by_id:
                    raise ValueError(
                        f"job {j.job_id} depends on job {d}, which is not "
                        f"in the submitted job list (DAGs must be "
                        f"submitted whole)")
                if d == j.job_id:
                    raise ValueError(f"job {j.job_id} depends on itself")
                pred_left[j.job_id] += 1
                succ[d].append(j)
        order = [j for j in jobs if pred_left[j.job_id] == 0]
        indeg = dict(pred_left)
        i = 0
        while i < len(order):
            for c in succ[order[i].job_id]:
                indeg[c.job_id] -= 1
                if indeg[c.job_id] == 0:
                    order.append(c)
            i += 1
        if len(order) != n:
            stuck = [jid for jid, d in indeg.items() if d > 0][:5]
            raise ValueError(f"dependency cycle among jobs {stuck}")

    logs: list[SlotLog] = []
    total_energy = 0.0
    total_carbon = 0.0
    t = t0
    t_end = t0 + horizon
    while t < t_end + max_overrun:
        released = False
        admits = [] if tracker is not None else None
        if has_deps and pending_release:
            for j in pending_release:
                active.append(ActiveJob(job=j, remaining=j.length,
                                        slack_left=j.delay))
                if admits is not None:
                    admits.append(id2row[j.job_id])
                deadline_eff[j.job_id] = t + (j.deadline - j.arrival)
            blocked -= len(pending_release)
            pending_release = []
            released = True
        while next_arrival < n and jobs[next_arrival].arrival <= t:
            j = jobs[next_arrival]
            next_arrival += 1
            if has_deps and pred_left[j.job_id] > 0:
                blocked += 1          # gated: enters via the release path
                continue
            active.append(ActiveJob(job=j, remaining=j.length, slack_left=j.delay))
            if admits is not None:
                admits.append(id2row[j.job_id])
        if admits:
            for r in sorted(admits):
                tracker.admit(t, jobs[r].job_id)
        if released:
            # keep active in (arrival, job_id) row order, matching the
            # vector engine's sorted-row iteration (float-sum parity)
            active.sort(key=lambda a: id2row[a.job.job_id])
        if not active and next_arrival == n and not blocked and t >= t_end:
            break

        if faults is not None:
            faults.begin_slot(t)
            cap_t = faults.available_capacity(cluster.capacity)
        else:
            cap_t = cluster.capacity
        if tele is not None and ci_pol is not ci:
            tele.emit(t, "forecast-read", value=float(ci_pol.staleness(t)))

        if prof is not None:
            _pt = time.perf_counter()
        m_t, alloc = policy.decide(t, active, ci_pol, cluster)
        m_t = int(min(m_t, cap_t))
        alloc = _enforce_capacity(alloc, active, m_t)
        if prof is not None:
            _now = time.perf_counter()
            prof.add("decide", _now - _pt)
            _pt = _now
        if tracker is not None:
            ids = [a.job.job_id for a in active
                   if alloc.get(a.job.job_id, 0) > 0]
            tracker.step(t, ids, [alloc[j] for j in ids])

        civ = ci.ci(t)
        energy = 0.0
        for a in active:
            k = alloc.get(a.job.job_id, 0)
            if k > 0:
                # Fractional final slot (paper footnote 4): only the work
                # actually needed is charged.
                frac = min(1.0, a.remaining / max(a.job.throughput(k), 1e-9))
                energy += emissions.slot_energy_kwh(a.job, k, cluster, frac)
        # fault disturbance over the allocated live jobs in list order
        # (= row order), through the same arrays the vector engine gathers
        dist = None
        run: list[ActiveJob] = []
        if faults is not None:
            run = [a for a in active
                   if not a.done and alloc.get(a.job.job_id, 0) > 0]
            ks = np.array([alloc[a.job.job_id] for a in run], dtype=np.int64)
            rem = np.array([a.remaining for a in run], dtype=np.float64)
            thr = np.array([a.job.throughput(int(k))
                            for a, k in zip(run, ks)], dtype=np.float64)
            dist = faults.apply(t, [a.job for a in run], ks, rem, thr)
            if dist.extra_energy is not None:
                for v in dist.extra_energy.tolist():
                    if v:
                        energy += v
            if tele is not None:
                emit_fault_events(tele, t, [a.job.job_id for a in run],
                                  dist, fault_kind)
        carbon = emissions.slot_carbon_g(energy, civ)
        total_energy += energy
        total_carbon += carbon

        if dist is None:
            apply_slot(active, alloc)
        else:
            # degraded slots: scale each allocated job's progress; energy
            # was already charged (a slow/failed host still burns power)
            for i, a in enumerate(run):
                a.remaining -= thr[i] * dist.factors[i]
                if dist.lost is not None:
                    a.remaining += dist.lost[i]
                a.started = True
            for a in active:
                if a.done or alloc.get(a.job.job_id, 0) > 0:
                    continue
                a.slack_left -= 1
                a.waited += 1

        finished = [a for a in active if a.done]
        for a in finished:
            jid = a.job.job_id
            row = id2row[jid]
            completion[row] = t
            wait[row] = a.waited
            violations[row] = t > deadline_eff.get(jid, a.job.deadline)
            policy.on_completion(t, a, bool(violations[row]))
            if tracker is not None:
                tracker.finish(jid)
            if has_deps:
                for child in succ[jid]:
                    pred_left[child.job_id] -= 1
                    if pred_left[child.job_id] == 0 and child.arrival <= t:
                        pending_release.append(child)
        active = [a for a in active if not a.done]

        used = sum(alloc.values())
        logs.append(SlotLog(slot=t, ci=civ, provisioned=m_t, used=used,
                            energy_kwh=energy, carbon_g=carbon,
                            running=len(alloc), queued=len(active) - len(alloc)))
        if prof is not None:
            prof.add("execute", time.perf_counter() - _pt)
        t += 1

    return SimResult(
        policy=policy.name,
        carbon_g=total_carbon,
        energy_kwh=total_energy,
        slots=logs,
        wait_slots=wait,
        violations=violations,
        completion=completion,
        num_jobs=n,
        resilience=_run_resilience(faults, ci_pol, ci, t0, t),
    )


def _enforce_capacity(alloc: dict[int, int], active: list[ActiveJob], m_t: int) -> dict[int, int]:
    """Capacity invariant: trim allocations (lowest marginal first) to m_t."""
    by_id = {a.job.job_id: a for a in active}
    alloc = {jid: int(k) for jid, k in alloc.items()
             if jid in by_id and k > 0}
    for jid in list(alloc):
        a = by_id[jid]
        alloc[jid] = int(np.clip(alloc[jid], a.job.k_min, a.job.k_max))
    total = sum(alloc.values())
    if total <= m_t:
        return alloc
    # Shed the least carbon-efficient increments first.
    incs = []
    for jid, k in alloc.items():
        a = by_id[jid]
        for kk in range(a.job.k_min + 1, k + 1):
            incs.append((a.job.marginal(kk), jid, kk))
    incs.sort()                      # lowest marginal first
    for p, jid, kk in incs:
        if total <= m_t:
            break
        if alloc.get(jid, 0) == kk:
            alloc[jid] = kk - 1
            total -= 1
    # Still above capacity: drop whole base allocations, latest-slack first.
    if total > m_t:
        order = sorted(alloc, key=lambda jid: -by_id[jid].slack_left)
        for jid in order:
            if total <= m_t:
                break
            total -= alloc[jid]
            del alloc[jid]
    return alloc


# --- geo-distributed engines ------------------------------------------------
#
# The multi-region path generalises the slot loop in *space*: per-job state
# gains a region axis (current region, migration countdown), provisioning
# and capacity enforcement run per region, and energy turns into a
# per-region vector multiplied by the aligned CI vector.  Semantics:
#
# - every job arrives in its home region (``GeoCluster.home_region`` over
#   the (arrival, job_id)-sorted row index);
# - a policy returning a different region for a job that has NOT started is
#   a free *placement* (queued work has no state to move);
# - for a started job it is a *migration*: the job suspends for
#   ``MigrationModel.slots(job)`` slots (burning waiting budget like any
#   pause), and the checkpoint-transfer energy is charged once, billed at
#   the destination region's CI on the initiation slot;
# - per-slot carbon is sum_r energy_r * CI_r(t); migration energy counts
#   into the destination region's total.
#
# Both engines (vector = region-axis state arrays + vectorised accounting,
# scalar = the readable per-GeoActiveJob reference) share the placement/
# migration resolution and the per-region accumulation helpers, and are
# bit-for-bit identical (tests/test_torch_geo.py).


@dataclasses.dataclass
class GeoActiveJob(ActiveJob):
    """ActiveJob + the region axis (scalar geo reference engine)."""

    region: int = 0
    mig_left: int = 0               # remaining suspended migration slots

    @property
    def migrating(self) -> bool:
        return self.mig_left > 0


class _GeoPackedActiveJob(_PackedActiveJob):
    """Packed view + the region axis (vector geo engine)."""

    __slots__ = ()

    @property
    def region(self) -> int:
        return int(self._eng.region[self.row])

    @region.setter
    def region(self, value: int) -> None:
        self._eng.region[self.row] = value

    @property
    def mig_left(self) -> int:
        return int(self._eng.mig_left[self.row])

    @mig_left.setter
    def mig_left(self, value: int) -> None:
        self._eng.mig_left[self.row] = value

    @property
    def migrating(self) -> bool:
        return self._eng.mig_left[self.row] > 0


class GeoEngineState(EngineState):
    """EngineState + per-job region / migration-countdown vectors."""

    __slots__ = ("region", "mig_left")

    def __init__(self, packed: PackedJobs, geo: GeoCluster) -> None:
        super().__init__(packed)
        self.region = np.array([geo.home_region(i) for i in range(packed.n)],
                               dtype=np.int64)
        self.mig_left = np.zeros(packed.n, dtype=np.int64)

    def view(self, row: int) -> _GeoPackedActiveJob:
        v = self._views.get(row)
        if v is None:
            v = self._views[row] = _GeoPackedActiveJob(self, row)
        return v


def _resolve_geo(active, alloc: dict[int, tuple[int, int]], geo: GeoCluster,
                 tele: Telemetry | None = None, t: int = 0):
    """Apply placement/migration semantics to a policy's raw decision.

    Walks the active set in engine order, mutating each view's
    ``region``/``mig_left`` (free placement for never-started jobs,
    migration initiation for started ones) and splitting the surviving
    allocations per region.  Returns ``(per_region_alloc, migrations)``
    where ``migrations`` lists ``(view, dest_region)`` in decision order.
    Shared verbatim by both geo engines so their state transitions (and
    the migrate events emitted here) are identical."""
    per_r: list[dict[int, int]] = [dict() for _ in range(geo.n_regions)]
    migs = []
    for a in active:
        if a.done or a.migrating:
            continue
        entry = alloc.get(a.job.job_id)
        if entry is None:
            continue
        r, k = int(entry[0]), int(entry[1])
        if not 0 <= r < geo.n_regions:
            raise ValueError(f"policy placed job {a.job.job_id} in region "
                             f"{r}; cluster has {geo.n_regions} regions")
        if r != a.region:
            if a.started:
                if tele is not None:
                    tele.emit(t, "migrate", job=a.job.job_id, value=float(r),
                              detail=f"from={int(a.region)}")
                a.region = r
                a.mig_left = geo.migration.slots(a.job)
                migs.append((a, r))
                continue               # suspended while state moves
            a.region = r               # free placement before first start
        if k > 0:
            per_r[r][a.job.job_id] = k
    return per_r, migs


def _charge_migrations(migs, geo: GeoCluster, ci_vec: np.ndarray,
                       energy_r: np.ndarray) -> float:
    """Add each initiated migration's transfer energy to its destination
    region (event order) and return the migration carbon charged."""
    mig_carbon = 0.0
    for a, dest in migs:
        e = geo.migration.energy_kwh(a.job)
        energy_r[dest] += e
        mig_carbon += e * ci_vec[dest]
    return mig_carbon


def _accumulate_regions(energy_r: np.ndarray, ci_vec: np.ndarray,
                        region_energy: np.ndarray,
                        region_carbon: np.ndarray) -> tuple[float, float]:
    """Fold one slot's per-region energy into the run totals; returns the
    slot's (energy, carbon) scalars.  Sequential region order keeps the
    float stream identical across engines."""
    energy = 0.0
    carbon = 0.0
    for r in range(len(energy_r)):
        c = energy_r[r] * ci_vec[r]
        energy += energy_r[r]
        carbon += c
        region_energy[r] += energy_r[r]
        region_carbon[r] += c
    return energy, carbon


def _simulate_geo_vector(
    jobs: list[Job],
    mci: MultiRegionCarbonService,
    geo: GeoCluster,
    policy,
    t0: int = 0,
    horizon: int | None = None,
    max_overrun: int = 24 * 21,
    faults: FaultProcess | None = None,
    packed: PackedJobs | None = None,
    telemetry: Telemetry | None = None,
) -> SimResult:
    horizon = int(horizon if horizon is not None else len(mci) - t0)
    if packed is None:
        packed = pack(jobs)
    if packed.has_deps:
        raise ValueError("the geo engines do not support DAG jobs yet; "
                         "run precedence-gated workloads single-region")
    ci_pol = mci.degraded()             # the view policies read
    faults = ensure_fault_process(faults)
    if faults is not None:
        faults.on_run_start(t0, geo.capacity_vec())
    tele, prof, tracker, fault_kind = _telemetry_hooks(telemetry, faults)
    policy.on_window_start(ci_pol, t0, horizon, packed.jobs, geo)

    eng = GeoEngineState(packed, geo)
    n = packed.n
    n_regions = geo.n_regions
    caps = geo.capacity_vec()
    id2row = packed.id2row
    power = np.where(packed.power > 0, packed.power, geo.power_per_server)
    thr_tab = packed.thr_tab
    slot_h = geo.slot_hours
    eta = geo.eta_net

    wait = np.zeros(n)
    violations = np.zeros(n, dtype=bool)
    completion = np.full(n, -1, dtype=np.int64)
    final_region = np.full(n, -1, dtype=np.int64)
    region_energy = np.zeros(n_regions)
    region_carbon = np.zeros(n_regions)
    migrations = 0
    mig_carbon_total = 0.0
    arrival = packed.arrival

    logs: list[SlotLog] = []
    total_energy = 0.0
    total_carbon = 0.0
    t = t0
    t_end = t0 + horizon
    rows_dirty = True
    while t < t_end + max_overrun:
        admits = [] if tracker is not None else None
        while eng.admitted < n and arrival[eng.admitted] <= t:
            eng.in_system[eng.admitted] = True
            if admits is not None:
                admits.append(eng.admitted)
            eng.admitted += 1
            rows_dirty = True
        if admits:
            for r in sorted(admits):
                tracker.admit(t, int(packed.job_ids[r]))
        if rows_dirty:
            eng.rows = np.flatnonzero(eng.in_system)
            rows_dirty = False
        rows = eng.rows
        if not len(rows) and eng.admitted == n and t >= t_end:
            break

        if faults is not None:
            faults.begin_slot(t)
            caps_t = faults.available_capacity_vec(caps)
        else:
            caps_t = caps
        if tele is not None and ci_pol is not mci:
            tele.emit(t, "forecast-read", value=float(ci_pol.staleness(t)))
        if prof is not None:
            _pt = time.perf_counter()

        active_views = eng.active_views()
        m_vec, alloc = policy.decide_geo(t, active_views, ci_pol, geo)
        m_vec = np.minimum(np.asarray(m_vec, dtype=np.int64), caps_t)
        per_r, migs = _resolve_geo(active_views, alloc, geo, tele, t)
        kvec = np.zeros(n, dtype=np.int64)
        for r in range(n_regions):
            for jid, k in _enforce_capacity(per_r[r], active_views,
                                            int(m_vec[r])).items():
                kvec[id2row[jid]] = k
        if prof is not None:
            _now = time.perf_counter()
            prof.add("decide", _now - _pt)
            _pt = _now

        ci_vec = mci.ci_vec(t)
        k_rows = kvec[rows]
        live = eng.remaining[rows] > _EPS
        arows = rows[k_rows > 0]
        k_a = kvec[arows]
        if tracker is not None:
            tracker.step(t, packed.job_ids[arows].tolist(), k_a.tolist())
        thr_a = thr_tab[arows, k_a]
        # Elementwise ops mirror the scalar ``emissions.slot_energy_kwh``
        # expression order (see the single-region vector engine).
        frac = np.minimum(1.0, eng.remaining[arows] / np.maximum(thr_a, 1e-9))
        e_comp = k_a * power[arows] * slot_h * frac
        ring = np.where(k_a <= 1, 0.0, 2.0 * (k_a - 1) / k_a)
        gbits = packed.comm[arows] * 8.0 * ring * k_a * frac
        e_vec = e_comp + eta * gbits / 3600.0 / 1000.0 * slot_h
        a_regions = eng.region[arows]
        energy_r = np.zeros(n_regions)
        for r in range(n_regions):
            for v in e_vec[a_regions == r].tolist():   # sequential, row order
                energy_r[r] += v

        prows = rows[(k_rows > 0) & live]
        thr_p = thr_tab[prows, kvec[prows]]
        dist = None
        if faults is not None:
            p_reg = eng.region[prows]
            dist = faults.apply(t, [packed.jobs[r] for r in prows.tolist()],
                                kvec[prows], eng.remaining[prows], thr_p,
                                regions=p_reg)
            if dist.extra_energy is not None:
                for i, v in enumerate(dist.extra_energy.tolist()):
                    if v:
                        energy_r[int(p_reg[i])] += v
            if tele is not None:
                emit_fault_events(tele, t, packed.job_ids[prows].tolist(),
                                  dist, fault_kind)

        mc = _charge_migrations(migs, geo, ci_vec, energy_r)
        mig_carbon_total += mc
        migrations += len(migs)
        energy, carbon = _accumulate_regions(energy_r, ci_vec,
                                             region_energy, region_carbon)
        total_energy += energy
        total_carbon += carbon

        if dist is None:
            eng.remaining[prows] -= thr_p
        else:
            eng.remaining[prows] -= thr_p * dist.factors
            if dist.lost is not None:
                eng.remaining[prows] += dist.lost
        eng.started[prows] = True
        wrows = rows[(k_rows == 0) & live]
        eng.slack_left[wrows] -= 1
        eng.waited[wrows] += 1
        mrows = wrows[eng.mig_left[wrows] > 0]
        eng.mig_left[mrows] -= 1

        fin = rows[eng.remaining[rows] <= _EPS]
        if len(fin):
            completion[fin] = t
            wait[fin] = eng.waited[fin]
            violations[fin] = t > packed.deadline[fin]
            final_region[fin] = eng.region[fin]
            for r in fin.tolist():
                policy.on_completion(t, eng.view(r), bool(violations[r]))
                if tracker is not None:
                    tracker.finish(int(packed.job_ids[r]))
            eng.in_system[fin] = False
            rows_dirty = True

        used = int(k_a.sum())
        running = len(arows)
        logs.append(SlotLog(slot=t, ci=float(np.mean(ci_vec)),
                            provisioned=int(m_vec.sum()), used=used,
                            energy_kwh=energy, carbon_g=carbon,
                            running=running,
                            queued=len(rows) - len(fin) - running))
        if prof is not None:
            prof.add("execute", time.perf_counter() - _pt)
        t += 1

    return SimResult(
        policy=policy.name,
        carbon_g=total_carbon,
        energy_kwh=total_energy,
        slots=logs,
        wait_slots=wait,
        violations=violations,
        completion=completion,
        num_jobs=n,
        regions=geo.regions,
        region_carbon_g=region_carbon,
        region_energy_kwh=region_energy,
        final_region=final_region,
        migrations=migrations,
        migration_carbon_g=mig_carbon_total,
        resilience=_run_resilience(faults, ci_pol, mci, t0, t),
    )


def _simulate_geo_scalar(
    jobs: list[Job],
    mci: MultiRegionCarbonService,
    geo: GeoCluster,
    policy,
    t0: int = 0,
    horizon: int | None = None,
    max_overrun: int = 24 * 21,
    faults: FaultProcess | None = None,
    telemetry: Telemetry | None = None,
) -> SimResult:
    horizon = int(horizon if horizon is not None else len(mci) - t0)
    if any(j.deps for j in jobs):
        raise ValueError("the geo engines do not support DAG jobs yet; "
                         "run precedence-gated workloads single-region")
    jobs = sorted(jobs, key=lambda j: (j.arrival, j.job_id))
    ci_pol = mci.degraded()
    faults = ensure_fault_process(faults)
    if faults is not None:
        faults.on_run_start(t0, geo.capacity_vec())
    tele, prof, tracker, fault_kind = _telemetry_hooks(telemetry, faults)
    policy.on_window_start(ci_pol, t0, horizon, jobs, geo)

    n_regions = geo.n_regions
    caps = geo.capacity_vec()
    active: list[GeoActiveJob] = []
    n = len(jobs)
    next_arrival = 0
    wait = np.zeros(n)
    violations = np.zeros(n, dtype=bool)
    completion = np.full(n, -1, dtype=np.int64)
    final_region = np.full(n, -1, dtype=np.int64)
    region_energy = np.zeros(n_regions)
    region_carbon = np.zeros(n_regions)
    migrations = 0
    mig_carbon_total = 0.0
    id2row = {j.job_id: i for i, j in enumerate(jobs)}

    logs: list[SlotLog] = []
    total_energy = 0.0
    total_carbon = 0.0
    t = t0
    t_end = t0 + horizon
    while t < t_end + max_overrun:
        admits = [] if tracker is not None else None
        while next_arrival < n and jobs[next_arrival].arrival <= t:
            j = jobs[next_arrival]
            if admits is not None:
                admits.append(next_arrival)
            active.append(GeoActiveJob(
                job=j, remaining=j.length, slack_left=j.delay,
                region=geo.home_region(next_arrival)))
            next_arrival += 1
        if admits:
            for r in sorted(admits):
                tracker.admit(t, jobs[r].job_id)
        if not active and next_arrival == n and t >= t_end:
            break

        if faults is not None:
            faults.begin_slot(t)
            caps_t = faults.available_capacity_vec(caps)
        else:
            caps_t = caps
        if tele is not None and ci_pol is not mci:
            tele.emit(t, "forecast-read", value=float(ci_pol.staleness(t)))
        if prof is not None:
            _pt = time.perf_counter()

        m_vec, alloc = policy.decide_geo(t, active, ci_pol, geo)
        m_vec = np.minimum(np.asarray(m_vec, dtype=np.int64), caps_t)
        per_r, migs = _resolve_geo(active, alloc, geo, tele, t)
        final: dict[int, tuple[int, int]] = {}
        for r in range(n_regions):
            for jid, k in _enforce_capacity(per_r[r], active,
                                            int(m_vec[r])).items():
                final[jid] = (r, k)
        if prof is not None:
            _now = time.perf_counter()
            prof.add("decide", _now - _pt)
            _pt = _now
        if tracker is not None:
            ids = [a.job.job_id for a in active
                   if final.get(a.job.job_id, (0, 0))[1] > 0]
            tracker.step(t, ids, [final[j][1] for j in ids])

        ci_vec = mci.ci_vec(t)
        energy_r = np.zeros(n_regions)
        for a in active:
            entry = final.get(a.job.job_id)
            if entry is None:
                continue
            r, k = entry
            frac = min(1.0, a.remaining / max(a.job.throughput(k), 1e-9))
            energy_r[r] += emissions.slot_energy_kwh(a.job, k, geo, frac)
        dist = None
        run: list[GeoActiveJob] = []
        if faults is not None:
            run = [a for a in active
                   if not a.done and final.get(a.job.job_id) is not None]
            ks = np.array([final[a.job.job_id][1] for a in run],
                          dtype=np.int64)
            rem = np.array([a.remaining for a in run], dtype=np.float64)
            thr = np.array([a.job.throughput(int(k))
                            for a, k in zip(run, ks)], dtype=np.float64)
            regs = np.array([final[a.job.job_id][0] for a in run],
                            dtype=np.int64)
            dist = faults.apply(t, [a.job for a in run], ks, rem, thr,
                                regions=regs)
            if dist.extra_energy is not None:
                for i, v in enumerate(dist.extra_energy.tolist()):
                    if v:
                        energy_r[int(regs[i])] += v
            if tele is not None:
                emit_fault_events(tele, t, [a.job.job_id for a in run],
                                  dist, fault_kind)

        mc = _charge_migrations(migs, geo, ci_vec, energy_r)
        mig_carbon_total += mc
        migrations += len(migs)
        energy, carbon = _accumulate_regions(energy_r, ci_vec,
                                             region_energy, region_carbon)
        total_energy += energy
        total_carbon += carbon

        if dist is None:
            for a in active:
                if a.done:
                    continue
                entry = final.get(a.job.job_id)
                if entry is not None:
                    r, k = entry
                    a.remaining -= a.job.throughput(k)
                    a.started = True
                else:
                    a.slack_left -= 1
                    a.waited += 1
                    if a.mig_left > 0:
                        a.mig_left -= 1
        else:
            for i, a in enumerate(run):
                a.remaining -= thr[i] * dist.factors[i]
                if dist.lost is not None:
                    a.remaining += dist.lost[i]
                a.started = True
            for a in active:
                if a.done or final.get(a.job.job_id) is not None:
                    continue
                a.slack_left -= 1
                a.waited += 1
                if a.mig_left > 0:
                    a.mig_left -= 1

        finished = [a for a in active if a.done]
        for a in finished:
            row = id2row[a.job.job_id]
            completion[row] = t
            wait[row] = a.waited
            violations[row] = t > a.job.deadline
            final_region[row] = a.region
            policy.on_completion(t, a, bool(violations[row]))
            if tracker is not None:
                tracker.finish(a.job.job_id)
        active = [a for a in active if not a.done]

        used = sum(k for _, k in final.values())
        running = len(final)
        logs.append(SlotLog(slot=t, ci=float(np.mean(ci_vec)),
                            provisioned=int(m_vec.sum()), used=used,
                            energy_kwh=energy, carbon_g=carbon,
                            running=running,
                            queued=len(active) - running))
        if prof is not None:
            prof.add("execute", time.perf_counter() - _pt)
        t += 1

    return SimResult(
        policy=policy.name,
        carbon_g=total_carbon,
        energy_kwh=total_energy,
        slots=logs,
        wait_slots=wait,
        violations=violations,
        completion=completion,
        num_jobs=n,
        regions=geo.regions,
        region_carbon_g=region_carbon,
        region_energy_kwh=region_energy,
        final_region=final_region,
        migrations=migrations,
        migration_carbon_g=mig_carbon_total,
        resilience=_run_resilience(faults, ci_pol, mci, t0, t),
    )
