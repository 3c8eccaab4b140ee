"""Baseline policies from the paper's evaluation (§6.1) + VCC (§6.7).

All baselines honour run-to-completion after the permitted delay, share the
capacity limit M, and (for fairness, as in the paper) may use the *mean
historical job length* where the real length is needed.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .carbon import CarbonService
from .forecast import QuantileCIView
from .scheduling import ActiveJob
from .types import ClusterConfig


def _fcfs_base_alloc(active: list[ActiveJob], m_t: int,
                     eligible=lambda a: True) -> dict[int, int]:
    """FCFS non-elastic allocation at k_min; forced jobs always first."""
    alloc: dict[int, int] = {}
    used = 0
    ordered = sorted((a for a in active if not a.done),
                     key=lambda a: (not a.forced, a.job.arrival, a.job.job_id))
    for a in ordered:
        if not a.forced and not eligible(a):
            continue
        k = a.job.k_min
        if used + k > m_t:
            continue
        alloc[a.job.job_id] = k
        used += k
    return alloc


def _elastic_fill(active: list[ActiveJob], alloc: dict[int, int], m_t: int,
                  min_marginal: float = 0.35) -> None:
    """Scale allocated jobs up by marginal throughput until m_t is filled.

    ``min_marginal`` floors the scaling: below it the energy per unit work
    (1/p) exceeds the typical clean/dirty CI ratio, so filling capacity
    with such increments *increases* carbon (observed on Fig. 14's
    VCC-scaling before the floor was added)."""
    by_id = {a.job.job_id: a for a in active}
    used = sum(alloc.values())
    entries = []
    for jid, k0 in alloc.items():
        a = by_id[jid]
        for k in range(k0 + 1, a.job.k_max + 1):
            if a.job.marginal(k) >= min_marginal:
                entries.append((-a.job.marginal(k), jid, k))
    entries.sort()
    for negp, jid, k in entries:
        if used >= m_t:
            break
        if alloc.get(jid, 0) == k - 1:
            alloc[jid] = k
            used += 1


@dataclasses.dataclass
class CarbonAgnosticPolicy:
    """Status quo: FCFS, no elasticity, run immediately, full capacity."""

    # decide_packed is compliant by construction (k in {0, k_min}, active
    # rows only, fill capped at the m_t it returns) -> the vector engine
    # skips its per-slot defensive re-validation (see _simulate_vector)
    packed_safe = True

    name: str = "carbon-agnostic"

    def on_window_start(self, ci, t0, horizon, jobs, cluster) -> None:
        pass

    def decide(self, t, active, ci, cluster):
        return cluster.capacity, _fcfs_base_alloc(active, cluster.capacity)

    def decide_packed(self, t, eng, ci, cluster):
        """Vector-engine fast path: FCFS over packed arrays.  Active rows
        are already (arrival, job_id)-sorted, so the FCFS order is forced
        rows then unforced rows, each in row order — identical to the
        ``_fcfs_base_alloc`` sort key."""
        rows = eng.rows[eng.remaining[eng.rows] > 1e-9]   # skip done jobs
        slack = eng.slack_left[rows]
        order = np.concatenate([rows[slack <= 0], rows[slack > 0]])
        kmin = eng.packed.k_min
        kvec = np.zeros(eng.packed.n, dtype=np.int64)
        m_t = cluster.capacity
        used = 0
        for r in order.tolist():
            k = int(kmin[r])
            if used + k > m_t:
                continue
            kvec[r] = k
            used += k
        return m_t, kvec

    def on_completion(self, t, job, violated) -> None:
        pass


@dataclasses.dataclass
class GaiaPolicy:
    """GAIA's Lowest-Window policy: per job, at arrival, choose the start
    time within its slack minimising mean CI over the *estimated* (mean
    historical) job length; non-elastic; FCFS on conflicts."""

    mean_length: float = 4.0
    name: str = "gaia"

    def on_window_start(self, ci, t0, horizon, jobs, cluster) -> None:
        self._start: dict[int, int] = {}

    def _plan(self, a: ActiveJob, t: int, ci: CarbonService) -> int:
        ell = max(1, int(round(self.mean_length)))
        horizon = a.job.delay + ell
        fc = ci.forecast(t, horizon)
        best_s, best_c = 0, np.inf
        for s in range(0, a.job.delay + 1):
            c = float(np.mean(fc[s:s + ell])) if s + ell <= len(fc) else np.inf
            if c < best_c:
                best_s, best_c = s, c
        return t + best_s

    def decide(self, t, active, ci, cluster):
        for a in active:
            if a.job.job_id not in self._start:
                self._start[a.job.job_id] = self._plan(a, t, ci)
        alloc = _fcfs_base_alloc(
            active, cluster.capacity,
            eligible=lambda a: t >= self._start[a.job.job_id] or a.started,
        )
        return cluster.capacity, alloc

    def on_completion(self, t, job, violated) -> None:
        pass


@dataclasses.dataclass
class WaitAwhilePolicy:
    """Threshold Wait-Awhile: suspend/resume on the 30th percentile of the
    next-24h CI forecast; run to completion once the delay is spent."""

    percentile: float = 30.0
    name: str = "wait-awhile"

    def on_window_start(self, ci, t0, horizon, jobs, cluster) -> None:
        pass

    def decide(self, t, active, ci, cluster):
        thresh = ci.percentile_threshold(t, self.percentile)
        low_carbon = ci.ci(t) <= thresh + 1e-12
        alloc = _fcfs_base_alloc(active, cluster.capacity,
                                 eligible=lambda a: low_carbon)
        return cluster.capacity, alloc

    def on_completion(self, t, job, violated) -> None:
        pass


@dataclasses.dataclass
class RobustWaitAwhilePolicy(WaitAwhilePolicy):
    """Wait-Awhile thresholding on a configurable forecast *quantile*
    instead of the point forecast (the forecast-error robust variant).

    Under noisy forecasts the plain policy chases phantom dips; computing
    the threshold from the ``quantile`` band of the forecast distribution
    filters that single-path noise.  Under a perfect forecast every band
    collapses onto the truth and the policy is bit-identical to
    ``wait-awhile``."""

    quantile: float = 0.7
    name: str = "wait-awhile-robust"

    def decide(self, t, active, ci, cluster):
        # the plain rule, with every forecast read routed through the
        # quantile band (ci()/gradient() still read the truth) — one
        # shared threshold implementation, one quantile knob
        return super().decide(t, active, QuantileCIView(ci, self.quantile),
                              cluster)


@dataclasses.dataclass
class CarbonScalerPolicy:
    """CarbonScaler adapted to a multi-job cluster (§6.1): each job plans
    its own elastic schedule over its window using the mean historical
    length; at runtime, cluster capacity is reconciled by prioritising
    higher-marginal-throughput increments."""

    mean_length: float = 4.0
    name: str = "carbonscaler"

    def on_window_start(self, ci, t0, horizon, jobs, cluster) -> None:
        self._plan: dict[int, np.ndarray] = {}
        self._plan_t0: dict[int, int] = {}

    def _make_plan(self, a: ActiveJob, t: int, ci: CarbonService) -> np.ndarray:
        """Single-job Algorithm-1 greedy over the job's own window, using the
        estimated length (this is CarbonScaler's per-job schedule)."""
        job = a.job
        est = max(1.0, self.mean_length)
        span = int(np.ceil(est)) + job.delay
        fc = ci.forecast(t, span)
        entries = []
        for s in range(span):
            for k in range(job.k_min, job.k_max + 1):
                p = job.marginal(k)
                entries.append((-p / max(fc[s], 1e-9), s, k, p))
        entries.sort()
        alloc = np.zeros(span, dtype=np.int64)
        work = 0.0
        for negscore, s, k, p in entries:
            if work >= est - 1e-9:
                break
            is_base = k == job.k_min
            if is_base and alloc[s] != 0:
                continue
            if not is_base and alloc[s] != k - 1:
                continue
            alloc[s] = k
            work += 1.0 if is_base else p
        return alloc

    def decide(self, t, active, ci, cluster):
        desired: dict[int, int] = {}
        for a in active:
            if a.done:
                continue
            if a.forced or (a.started and a.job.job_id not in self._plan):
                desired[a.job.job_id] = a.job.k_min
                continue
            if a.job.job_id not in self._plan:
                self._plan[a.job.job_id] = self._make_plan(a, t, ci)
                self._plan_t0[a.job.job_id] = t
            plan = self._plan[a.job.job_id]
            rel = t - self._plan_t0[a.job.job_id]
            if rel < len(plan) and plan[rel] > 0:
                desired[a.job.job_id] = int(plan[rel])
            elif rel >= len(plan):
                desired[a.job.job_id] = a.job.k_min   # plan exhausted: run out
        # Cluster-capacity reconciliation: highest marginal increments win.
        by_id = {a.job.job_id: a for a in active}
        incs = []
        for jid, k in desired.items():
            job = by_id[jid].job
            incs.append((-1.0, by_id[jid].slack_left, jid, job.k_min, job.k_min))
            for kk in range(job.k_min + 1, k + 1):
                incs.append((-job.marginal(kk), by_id[jid].slack_left, jid, kk, 1))
        incs.sort()
        alloc: dict[int, int] = {}
        used = 0
        for negp, slack, jid, k, add in incs:
            cur = alloc.get(jid, 0)
            is_base = k == by_id[jid].job.k_min
            if is_base and cur != 0:
                continue
            if not is_base and cur != k - 1:
                continue
            if used + add > cluster.capacity:
                continue
            alloc[jid] = k
            used += add
        return cluster.capacity, alloc

    def on_completion(self, t, job, violated) -> None:
        self._plan.pop(job.job.job_id, None)


@dataclasses.dataclass
class VCCPolicy:
    """Google's Variable Capacity Curve (§6.7): shape the day's capacity to
    the lowest-CI slots while meeting expected daily demand; schedule FCFS
    (non-elastic) or elastically (``scaling=True``)."""

    scaling: bool = False
    utilization: float = 0.5
    name: str = "vcc"

    def __post_init__(self) -> None:
        if self.scaling:
            self.name = "vcc-scaling"

    def on_window_start(self, ci, t0, horizon, jobs, cluster) -> None:
        self._curve: dict[int, int] = {}
        self._daily_demand = self.utilization * cluster.capacity * 24

    def _plan_day(self, day_start: int, ci: CarbonService, cluster: ClusterConfig) -> None:
        fc = ci.forecast(day_start, 24)
        order = np.argsort(fc)
        m = np.zeros(24, dtype=np.int64)
        remaining = self._daily_demand
        for idx in order:
            give = int(min(cluster.capacity, np.ceil(remaining)))
            m[idx] = give
            remaining -= give
            if remaining <= 0:
                break
        for i in range(24):
            self._curve[day_start + i] = int(m[i])

    def decide(self, t, active, ci, cluster):
        if t not in self._curve:
            self._plan_day(t, ci, cluster)
        m_t = self._curve[t]
        forced_need = sum(a.job.k_min for a in active if a.forced and not a.done)
        m_t = max(m_t, min(forced_need, cluster.capacity))
        alloc = _fcfs_base_alloc(active, m_t)
        if self.scaling:
            _elastic_fill(active, alloc, m_t)
        return m_t, alloc

    def on_completion(self, t, job, violated) -> None:
        pass
