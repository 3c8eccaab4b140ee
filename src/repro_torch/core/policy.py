"""The CarbonFlex runtime policy: continuous learning + phi + psi.

``learn_window`` is the learning phase (§4.2): replay a historical slice
through the offline oracle (Algorithm 1), featurise each slot's system
state (Table 2) and store ``STATE -> (m_t, rho_t)`` in the knowledge base.
Per the implementation section, the trace can be replayed at several start
offsets to densify the case base.

``CarbonFlexPolicy`` is the execution phase (§4.3): at each slot build the
current state, run Algorithm 2 (provisioning, with delay-violation
feedback) and Algorithm 3 (scheduling) against the learned knowledge base.

``OraclePolicy`` runs Algorithm 1 *on the evaluation trace itself* with
full future knowledge — the CarbonFlex(Oracle) baseline of §6.
"""
from __future__ import annotations

import dataclasses
import logging
from collections import deque
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from . import oracle
from .carbon import CarbonService
from .forecast import QuantileCIView
from .knowledge import KnowledgeBase, build_state, states_from_schedule
from .provisioning import ProvisioningConfig, provision
from .scheduling import ActiveJob, schedule, schedule_packed
from .types import ClusterConfig, Job

_EPS = 1e-9

logger = logging.getLogger(__name__)


@runtime_checkable
class Policy(Protocol):
    """The provisioning+scheduling policy protocol the simulator drives.

    Per slot the engine calls ``decide`` with the active set and expects
    ``(m_t, allocations)``; ``on_window_start`` resets per-window state and
    ``on_completion`` feeds back each finished job (the violation-feedback
    input of Algorithm 2).  Policies may additionally implement the optional
    ``decide_packed(t, eng, ci, cluster)`` fast path to run directly over
    the vector engine's struct-of-arrays state."""

    name: str

    def on_window_start(self, ci: CarbonService, t0: int, horizon: int,
                        jobs: list[Job], cluster: ClusterConfig) -> None: ...

    def decide(self, t: int, active: list[ActiveJob], ci: CarbonService,
               cluster: ClusterConfig) -> tuple[int, dict[int, int]]: ...

    def on_completion(self, t: int, job: ActiveJob, violated: bool) -> None: ...


@dataclasses.dataclass
class LearnOutcome:
    """Result of one ``learn_window`` call: the per-offset oracle solutions
    plus which replay offsets actually contributed cases (an offset whose
    window holds no arrivals is skipped, not an error — ``empty`` records
    it so callers can see a silent gap in the case base)."""

    results: list[oracle.OracleResult]
    contributed: tuple[int, ...]
    empty: tuple[int, ...]


def learn_window(
    kb: KnowledgeBase,
    jobs: list[Job],
    ci: CarbonService,
    t0: int,
    horizon: int,
    cluster: ClusterConfig,
    offsets: tuple[int, ...] = (0,),
    backend: str = "numpy",
) -> LearnOutcome:
    """Learning phase over one historical window (optionally replayed at
    several start offsets, §5 'Continuous Learning').

    ``backend`` is the oracle's greedy pass (``oracle.solve``); with
    ``"device"`` it runs where the knowledge base lives (``kb.device``).
    Offsets whose window contains no arrivals are skipped and reported in
    ``LearnOutcome.empty``.
    """
    capacity = cluster.capacity
    nq = len(cluster.queues)

    results: list[oracle.OracleResult] = []
    contributed: list[int] = []
    empty: list[int] = []
    for off in offsets:
        s0 = t0 + off
        window_jobs = [
            dataclasses.replace(j, arrival=j.arrival - s0)
            for j in jobs
            if s0 <= j.arrival < s0 + horizon
        ]
        if not window_jobs:
            empty.append(off)
            continue
        ci_slice = ci.trace[s0:s0 + horizon]
        res = oracle.solve(window_jobs, ci_slice, capacity, horizon=horizon,
                           backend=backend, device=kb.device)
        states = states_from_schedule(window_jobs, res.schedule.alloc,
                                      ci, nq, t0=s0)
        kb.add_window(states, res.capacity_curve, res.rho_curve)
        results.append(res)
        contributed.append(off)
    if empty:
        logger.info("learn_window: offsets %s held no arrivals in "
                    "[t0+off, t0+off+%d) and were skipped", tuple(empty), horizon)
    return LearnOutcome(results=results, contributed=tuple(contributed),
                        empty=tuple(empty))


@dataclasses.dataclass
class CarbonFlexPolicy:
    """Execution-phase policy (Algorithms 2 + 3 over the knowledge base).

    ``forecast_quantile`` (the robust variant, registered as
    ``carbonflex-robust``): when set, every forecast-derived Table-2
    feature (day-ahead rank, min/mean CI ratios) is computed through a
    :class:`~repro_torch.core.forecast.QuantileCIView` at that quantile instead
    of the point forecast, so single-path forecast noise cannot whipsaw
    the KNN state.  Under a perfect forecast the band collapses onto the
    truth and the robust variant is bit-identical to plain carbonflex."""

    # decide_packed allocates only live active rows, scales from the entry
    # blocks' [k_min, k_max] tables, fill capped at the m_t it returns ->
    # the vector engine skips per-slot re-validation (see _simulate_vector)
    packed_safe = True

    kb: KnowledgeBase
    cfg: ProvisioningConfig = dataclasses.field(default_factory=ProvisioningConfig)
    violation_window: int = 24          # completions remembered for v
    forecast_quantile: float | None = None
    name: str = "carbonflex"

    def __post_init__(self) -> None:
        self._recent: deque[bool] = deque(maxlen=self.violation_window)
        self._current_m = 0

    def _ci_view(self, ci):
        if self.forecast_quantile is None:
            return ci
        return QuantileCIView(ci, self.forecast_quantile)

    # Policy protocol ------------------------------------------------------

    def on_window_start(self, ci, t0, horizon, jobs, cluster) -> None:
        self._recent.clear()
        self._current_m = 0
        self._num_queues = len(cluster.queues)
        self._arrivals: dict[int, tuple[int, int]] = {}   # job_id -> (arrival, queue)
        self._backlog_sum = 0.0
        self._backlog_n = 0

    def decide(self, t, active: list[ActiveJob], ci: CarbonService,
               cluster: ClusterConfig):
        live = [a for a in active if not a.done]
        counts = np.zeros(self._num_queues)
        for a in live:
            counts[a.job.queue] += 1
            self._arrivals.setdefault(a.job.job_id, (a.job.arrival, a.job.queue))
        arr24 = np.zeros(self._num_queues)
        for arr, q in self._arrivals.values():
            if t - 24 < arr <= t:
                arr24[q] += 1
        mean_el = float(np.mean([a.job.elasticity() for a in live])) if live else 0.0
        total = counts.sum()
        self._backlog_sum += total
        self._backlog_n += 1
        rel = float(total / max(self._backlog_sum / self._backlog_n, 1e-9))
        state = build_state(self._ci_view(ci), t, counts, mean_el, arr24, rel)
        v = float(np.mean(self._recent)) if self._recent else 0.0
        min_required = sum(a.job.k_min for a in live if a.forced)
        m_t, rho = provision(state, self.kb, cluster.capacity, self._current_m,
                             v, self.cfg, min_required=min_required)
        self._current_m = m_t
        return m_t, schedule(live, m_t, rho)

    def decide_packed(self, t, eng, ci: CarbonService, cluster: ClusterConfig):
        """Struct-of-arrays fast path for the vector engine.

        Mirrors ``decide`` operation-for-operation (bincounts over the
        packed queue array, arrival pressure over the admission pointer,
        ``schedule_packed`` for Algorithm 3) so decisions are identical —
        asserted by tests/test_engine_parity.py."""
        ps = eng.packed
        nq = self._num_queues
        rows = eng.rows[eng.remaining[eng.rows] > _EPS]   # live jobs
        counts = np.bincount(ps.queue[rows], minlength=nq).astype(np.float64)
        # arrival pressure: every job admitted so far (and long enough to
        # have been live for >= 1 slot, matching _arrivals bookkeeping)
        adm = slice(0, eng.admitted)
        seen = ps.length[adm] > _EPS
        recent = seen & (ps.arrival[adm] > t - 24) & (ps.arrival[adm] <= t)
        arr24 = np.bincount(ps.queue[adm][recent], minlength=nq).astype(np.float64)
        mean_el = float(np.mean(ps.elast[rows])) if len(rows) else 0.0
        total = counts.sum()
        self._backlog_sum += total
        self._backlog_n += 1
        rel = float(total / max(self._backlog_sum / self._backlog_n, 1e-9))
        state = build_state(self._ci_view(ci), t, counts, mean_el, arr24, rel)
        v = float(np.mean(self._recent)) if self._recent else 0.0
        forced = rows[eng.slack_left[rows] <= 0]
        min_required = int(ps.k_min[forced].sum())
        m_t, rho = provision(state, self.kb, cluster.capacity, self._current_m,
                             v, self.cfg, min_required=min_required)
        self._current_m = m_t
        return m_t, schedule_packed(ps.blocks, ps.k_min, eng.slack_left,
                                    rows, m_t, rho)

    def on_completion(self, t, job: ActiveJob, violated: bool) -> None:
        self._recent.append(violated)


@dataclasses.dataclass
class OraclePolicy:
    """CarbonFlex(Oracle): Algorithm 1 with full future knowledge (§6.1).
    ``backend`` and ``device`` pick the oracle's greedy pass
    (``oracle.solve``); ``device`` matters only for ``backend="device"``."""

    backend: str = "numpy"
    device: str | torch.device = "cuda"
    name: str = "oracle"

    def on_window_start(self, ci, t0, horizon, jobs, cluster) -> None:
        # Solve over the full run (window + overrun room) so late arrivals fit.
        span = min(len(ci) - t0, horizon + max(q.delay for q in cluster.queues) + 24 * 14)
        shifted = [dataclasses.replace(j, arrival=j.arrival - t0) for j in jobs]
        res = oracle.solve(shifted, ci.trace[t0:t0 + span], cluster.capacity,
                           horizon=span, backend=self.backend, device=self.device)
        self._alloc = {j.job_id: res.schedule.alloc[i] for i, j in enumerate(shifted)}
        # row-indexed view for decide_packed: the engine packs the same
        # (arrival, job_id)-sorted list it passed to us, so oracle row i
        # is engine row i
        self._alloc_mat = res.schedule.alloc
        self._t0 = t0
        self.result = res

    def decide(self, t, active, ci, cluster):
        rel = t - self._t0
        alloc = {}
        for a in active:
            row = self._alloc.get(a.job.job_id)
            if row is not None and 0 <= rel < len(row) and row[rel] > 0:
                alloc[a.job.job_id] = int(row[rel])
        return sum(alloc.values()), alloc

    def decide_packed(self, t, eng, ci, cluster):
        """Vector-engine fast path: one column gather from the solved
        allocation matrix instead of a per-job dict walk."""
        rel = t - self._t0
        kvec = np.zeros(eng.packed.n, dtype=np.int64)
        if 0 <= rel < self._alloc_mat.shape[1]:
            kvec[eng.rows] = self._alloc_mat[eng.rows, rel]
        return int(kvec.sum()), kvec

    def on_completion(self, t, job, violated) -> None:
        pass


# The receding-horizon execution phase (``carbonflex-mpc`` /
# ``carbonflex-scale`` / ``oracle-estimated``) lives in ``core/mpc.py``;
# re-exported here, where the JAX package's callers import it from.
from .mpc import (CarbonFlexMPCPolicy, CarbonFlexScalePolicy,  # noqa: E402
                  EstimatedOraclePolicy, MPCConfig)

__all__ = [
    "CarbonFlexMPCPolicy", "CarbonFlexPolicy", "CarbonFlexScalePolicy",
    "EstimatedOraclePolicy", "LearnOutcome", "MPCConfig", "OraclePolicy",
    "Policy", "learn_window",
]
