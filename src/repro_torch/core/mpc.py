"""Receding-horizon (MPC) execution phase for CarbonFlex.

The oracle's advantage over the per-slot KNN execution phase is mostly
*when* jobs run, not how many servers are provisioned.  This module
attacks that axis with a model-predictive execution phase:

- Each decision epoch the planner scores, for every live job, whether the
  current slot belongs to the cheapest ``need`` slots of the job's
  feasible window (the next ``slack + need`` slots, capped at the
  planning horizon) under the day-ahead forecast.  ``need`` is the job's
  *estimated* remaining work from a learned per-queue conditional length
  distribution — MPC gets the same information the paper grants every
  baseline (historical lengths), never the true length.
- The argmin-carbon plan under that rule is "run each job in its cheapest
  feasible slots"; executing its first step and replanning next epoch is
  the classic receding-horizon loop.  Jobs whose slack is exhausted are
  forced at ``k_min`` first, so deadline safety is identical to every
  baseline.
- ``CarbonFlexScalePolicy`` adds CarbonScaler-style marginal-capacity
  scale-up: in *clean* slots (current slot within the cheapest
  ``clean_frac`` of the horizon) unforced jobs request the largest scale
  whose marginal throughput still clears a rho threshold learned from the
  knowledge base's oracle rho-curve (median of the KB's stored rho
  values).

Everything the per-slot decision needs is precomputed host-side at
``on_window_start`` into integer tables (``rank``/``clean`` per slot from
the forecast, a ``need`` LUT per (queue, done-bucket) from history).  The
per-slot rule is pure integer logic over those tables plus the engine's
own ``remaining``/``slack`` state, which is why the scalar, vector, and
scan engines produce bit-identical decisions (the scan engine consumes the
same tables on the device; see ``core/scan_engine.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import oracle
from .knowledge import KnowledgeBase

_EPS = 1e-9

#: Decision tables extend this far past the nominal window so
#: run-to-completion overruns (simulator default ``max_overrun=24*21``)
#: stay on planned slots; further slots clamp to the last table row.
PLAN_TAIL = 24 * 21


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    """Knobs of the receding-horizon execution phase.

    The defaults are the JAX package's tuned values.  ``horizon=0`` is
    reserved for the registry's degenerate pin: the ``carbonflex-mpc``
    builder then returns plain ``CarbonFlexPolicy`` (no look-ahead means
    no plan)."""

    horizon: int = 48            # H: planning look-ahead (slots)
    replan_every: int = 1        # refresh cadence of the forecast tables
    percentile: float = 85.0     # conditional remaining-length percentile
    prior_mean: float = 6.0      # length prior before any history (slots)
    history_cap: int = 512       # per-queue completed-length window
    max_done: int = 64           # D: done-work buckets of the need LUT
    clean_frac: float = 0.25     # scale-up window (carbonflex-scale only)
    scale_rho: float | None = None   # None = learn from the KB rho curve

    def __post_init__(self) -> None:
        if self.horizon < 0:
            raise ValueError(f"horizon must be >= 0, got {self.horizon}")
        if self.replan_every < 1:
            raise ValueError(
                f"replan_every must be >= 1, got {self.replan_every}")
        if self.max_done < 1:
            raise ValueError(f"max_done must be >= 1, got {self.max_done}")
        if not 0.0 <= self.clean_frac <= 1.0:
            raise ValueError(
                f"clean_frac must be in [0, 1], got {self.clean_frac}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "MPCConfig":
        return cls(**d)


@dataclasses.dataclass
class CarbonFlexMPCPolicy:
    """Receding-horizon temporal shifting over the forecast window.

    Per slot, a live unforced job is *eligible* to run iff the current
    slot ranks among its estimated-``need`` cheapest slots within its
    feasible window ``W = clip(slack + need, 1, H)``::

        eligible  <=>  #{u in 1..W-1 : forecast[t+u] < forecast[t]} < need

    (strict comparison: ties prefer running now — earlier is always safer
    under estimate error).  Forced jobs (slack exhausted) run at ``k_min``
    unconditionally.  Capacity fills forced rows first, then eligible rows,
    both in engine row order with continue-on-overflow semantics — the
    exact walk the scan engine's device fill performs.
    """

    # decide_packed allocates live active rows only, at k in
    # [k_min, k_max], total capped at the capacity it reports -> the
    # vector engine skips per-slot re-validation (see _simulate_vector).
    packed_safe = True
    # Subclass hook: CarbonFlexScalePolicy turns on clean-window scale-up.
    scales = False

    cfg: MPCConfig = dataclasses.field(default_factory=MPCConfig)
    name: str = "carbonflex-mpc"

    def __post_init__(self) -> None:
        if self.cfg.horizon < 1:
            raise ValueError(
                "CarbonFlexMPCPolicy needs horizon >= 1; the registry maps "
                "MPCConfig(horizon=0) to plain CarbonFlexPolicy instead")
        self._hist: dict[int, list[float]] = {}

    # --- learned per-queue length history ---------------------------------

    def _q_hist(self, q: int) -> list[float]:
        h = self._hist.get(q)
        if h is None:
            h = self._hist[q] = [float(self.cfg.prior_mean)]
        return h

    def warm_start(self, historical_jobs) -> None:
        """Seed the per-queue length histories from completed historical
        jobs (the same logs the learning phase replays).  History changes
        only here — never mid-window — so all three engines see identical
        need tables (the scan engine has no per-completion callback)."""
        for j in historical_jobs:
            h = self._q_hist(j.queue)
            h.append(float(j.length))
            if len(h) > self.cfg.history_cap:
                del h[0]

    def _build_need(self, nq: int) -> np.ndarray:
        """(nq, D) LUT of estimated remaining k_min-slots given floor(done).

        Entry [q, d] is the ``percentile`` of the conditional distribution
        {L | L > d} minus d (a plain mean under-schedules the heavy tail
        and blows deadlines), floored at one slot."""
        cfg = self.cfg
        lut = np.ones((nq, cfg.max_done), dtype=np.int64)
        for q in range(nq):
            arr = np.asarray(self._q_hist(q), dtype=np.float64)
            for d in range(cfg.max_done):
                longer = arr[arr > d]
                if len(longer):
                    est = float(np.percentile(longer, cfg.percentile)) - d
                else:
                    # beyond the longest seen: assume a mean-chunk remains
                    est = max(float(arr.mean()) * 0.5, 1.0)
                lut[q, d] = max(int(np.ceil(est - 1e-9)), 1)
        return lut

    # --- forecast decision tables -----------------------------------------

    def _build_tables(self, ci, t0: int, horizon: int) -> None:
        """Per-slot rank rows + clean flags over window + overrun tail.

        ``rank[s, j] = #{u in 1..j : fc[u] < fc[0]}`` for the forecast
        window anchored at slot ``t0 + s``; with replan cadence R the
        window is anchored at the epoch start and offset to the slot, so
        slots between replans reuse the stale forecast — exactly what a
        live replanning loop would see.  Forecast models are deterministic
        per (seed, trace, slot) (core/forecast.py), so precomputing here
        is equivalent to querying live and keeps all engines identical."""
        cfg = self.cfg
        h = cfg.horizon
        span = int(horizon) + PLAN_TAIL
        rank = np.zeros((span, h), dtype=np.int32)
        clean_cnt = np.zeros(span, dtype=np.int32)
        r = cfg.replan_every
        for e0 in range(0, span, r):
            m = min(r, span - e0)
            fc = np.asarray(ci.forecast_extended(t0 + e0, m + h),
                            dtype=np.float64)
            for o in range(m):
                w = fc[o:o + h + 1]
                cum = np.cumsum((w[1:] < w[0]).astype(np.int32))
                rank[e0 + o, 1:] = cum[:h - 1]
                clean_cnt[e0 + o] = cum[h - 1]
        self._rank = rank
        self._clean = clean_cnt < int(np.ceil(cfg.clean_frac * h))

    # --- scale-up tables (carbonflex-scale) -------------------------------

    def _resolve_rho(self) -> float:
        return 0.5

    def _build_k_up(self, jobs) -> np.ndarray:
        if not self.scales:
            return self._kmin
        rho = self._resolve_rho()
        out = np.empty(len(jobs), dtype=np.int64)
        for i, j in enumerate(jobs):
            k = j.k_min
            for kk in range(j.k_min + 1, j.k_max + 1):
                if j.marginal(kk) >= rho:
                    k = kk
                else:
                    break                 # profiles are monotone decreasing
            out[i] = k
        return out

    # --- Policy protocol --------------------------------------------------

    def on_window_start(self, ci, t0, horizon, jobs, cluster) -> None:
        self._t0 = int(t0)
        self._h = int(self.cfg.horizon)
        self._need = self._build_need(len(cluster.queues))
        self._build_tables(ci, t0, int(horizon))
        self._length = np.array([j.length for j in jobs], dtype=np.float64)
        self._queue = np.array([j.queue for j in jobs], dtype=np.int64)
        self._kmin = np.array([j.k_min for j in jobs], dtype=np.int64)
        self._id2row = {j.job_id: i for i, j in enumerate(jobs)}
        self._k_up = self._build_k_up(jobs)

    def _slot(self, t: int) -> int:
        return min(max(t - self._t0, 0), len(self._rank) - 1)

    def decide(self, t, active, ci, cluster):
        live = [a for a in active if not a.done]
        s = self._slot(t)
        rank_row = self._rank[s]
        clean = bool(self.scales and self._clean[s])
        m_cap = int(cluster.capacity)
        dmax = self._need.shape[1] - 1
        used = 0
        alloc: dict[int, int] = {}
        # Forced rows first (row order, continue semantics), then eligible
        # unforced rows — mirroring the scan engine's device fill walk.
        unforced = []
        for a in live:
            if a.slack_left <= 0:
                k = int(a.job.k_min)
                if used + k <= m_cap:
                    alloc[a.job.job_id] = k
                    used += k
            else:
                unforced.append(a)
        for a in unforced:
            row = self._id2row[a.job.job_id]
            done = self._length[row] - a.remaining
            d = min(max(int(np.floor(done)), 0), dmax)
            need = int(self._need[self._queue[row], d])
            w = min(max(a.slack_left + need, 1), self._h)
            if int(rank_row[w - 1]) >= need:
                continue
            k = int(self._k_up[row]) if clean else int(a.job.k_min)
            if used + k <= m_cap:
                alloc[a.job.job_id] = k
                used += k
        return m_cap, alloc

    def decide_packed(self, t, eng, ci, cluster):
        """Struct-of-arrays fast path: the same table lookups vectorised,
        with the identical forced-then-eligible row-order fill."""
        ps = eng.packed
        rows = eng.rows[eng.remaining[eng.rows] > _EPS]   # live jobs
        kvec = np.zeros(ps.n, dtype=np.int64)
        m_cap = int(cluster.capacity)
        if not len(rows):
            return m_cap, kvec
        s = self._slot(t)
        rank_row = self._rank[s]
        clean = bool(self.scales and self._clean[s])
        slack = eng.slack_left[rows]
        forced = slack <= 0
        done = ps.length[rows] - eng.remaining[rows]
        d = np.clip(np.floor(done).astype(np.int64), 0,
                    self._need.shape[1] - 1)
        need = self._need[ps.queue[rows], d]
        w = np.clip(slack + need, 1, self._h)
        elig = rank_row[w - 1] < need
        used = 0
        for r in rows[forced].tolist():
            k = int(ps.k_min[r])
            if used + k <= m_cap:
                kvec[r] = k
                used += k
        krow = self._k_up if clean else ps.k_min
        for r in rows[~forced & elig].tolist():
            k = int(krow[r])
            if used + k <= m_cap:
                kvec[r] = k
                used += k
        return m_cap, kvec

    def on_completion(self, t, job, violated) -> None:
        # History is intentionally frozen within a window (see warm_start):
        # the scan engine never observes completions mid-flight, so feeding
        # them back here would break cross-engine bit-parity.
        pass

    # --- scan-engine integration (core/scan_engine.py) --------------------

    def scan_tables(self) -> dict[str, np.ndarray]:
        """Row-static device constants of the decision rule."""
        return {"need_lut": self._need}

    def rank_rows(self, ts: np.ndarray) -> np.ndarray:
        """(S, H) rank rows for absolute slots ``ts`` (clamped)."""
        idx = np.clip(np.asarray(ts, dtype=np.int64) - self._t0, 0,
                      len(self._rank) - 1)
        return self._rank[idx]

    def clean_rows(self, ts: np.ndarray) -> np.ndarray:
        """(S,) clean-slot flags for absolute slots ``ts`` (clamped)."""
        idx = np.clip(np.asarray(ts, dtype=np.int64) - self._t0, 0,
                      len(self._clean) - 1)
        return self._clean[idx]


@dataclasses.dataclass
class CarbonFlexScalePolicy(CarbonFlexMPCPolicy):
    """MPC + CarbonScaler marginal-capacity scale-up in clean windows.

    In slots the forecast places within the cheapest ``clean_frac`` of
    the horizon, unforced eligible jobs request the largest scale whose
    marginal throughput clears ``rho`` (learned as the median of the
    knowledge base's oracle rho curve when ``cfg.scale_rho`` is None) —
    pulling work forward into clean energy at acceptable efficiency.
    Forced jobs stay at ``k_min`` (scale-up never eats the safety
    headroom), so deadline behaviour is unchanged from the base MPC."""

    scales = True

    name: str = "carbonflex-scale"
    kb: KnowledgeBase | None = None

    def _resolve_rho(self) -> float:
        if self.cfg.scale_rho is not None:
            return float(self.cfg.scale_rho)
        if self.kb is not None and len(self.kb):
            return float(np.median(self.kb.rho_values()))
        return 0.5


@dataclasses.dataclass
class EstimatedOraclePolicy:
    """Algorithm 1 with perfect CI knowledge but *estimated* job lengths.

    The plain oracle is granted two kinds of clairvoyance carbonflex is
    denied: the true future CI *and* every job's true length.  This
    variant keeps the first and drops the second — each job's length is
    replaced by the per-queue ``percentile`` of the learned length
    history before solving — which separates timing skill from length
    clairvoyance.  ``backend`` and ``device`` pick the oracle's greedy
    pass (``oracle.solve``), as for ``OraclePolicy``.

    Execution follows the solved plan; jobs that outlive their estimate
    (the plan thinks they are done) fall back to forced-at-``k_min`` once
    their slack is exhausted, capacity permitting — the same safety net
    every baseline has."""

    cfg: MPCConfig = dataclasses.field(default_factory=MPCConfig)
    backend: str = "numpy"
    device: str | torch.device = "cuda"
    name: str = "oracle-estimated"

    def __post_init__(self) -> None:
        self._hist: dict[int, list[float]] = {}

    def _q_hist(self, q: int) -> list[float]:
        h = self._hist.get(q)
        if h is None:
            h = self._hist[q] = [float(self.cfg.prior_mean)]
        return h

    def warm_start(self, historical_jobs) -> None:
        for j in historical_jobs:
            h = self._q_hist(j.queue)
            h.append(float(j.length))
            if len(h) > self.cfg.history_cap:
                del h[0]

    def on_window_start(self, ci, t0, horizon, jobs, cluster) -> None:
        # Same solve span as OraclePolicy (window + overrun room).
        span = min(len(ci) - t0,
                   horizon + max(q.delay for q in cluster.queues) + 24 * 14)
        est = {q: max(float(np.percentile(
                   np.asarray(self._q_hist(q), dtype=np.float64),
                   self.cfg.percentile)), 1.0)
               for q in sorted({j.queue for j in jobs})}
        shifted = [dataclasses.replace(j, arrival=j.arrival - t0,
                                       length=est[j.queue]) for j in jobs]
        res = oracle.solve(shifted, ci.trace[t0:t0 + span], cluster.capacity,
                           horizon=span, backend=self.backend,
                           device=self.device)
        # row-indexed: the engine packs the same (arrival, job_id)-sorted
        # list it passed here, so plan row i is engine row i
        self._alloc_mat = res.schedule.alloc
        self._t0 = int(t0)
        self._id2row = {j.job_id: i for i, j in enumerate(jobs)}

    def decide(self, t, active, ci, cluster):
        rel = t - self._t0
        span = self._alloc_mat.shape[1]
        m_cap = int(cluster.capacity)
        live = [a for a in active if not a.done]
        used = 0
        alloc: dict[int, int] = {}
        for a in live:
            row = self._id2row[a.job.job_id]
            k = int(self._alloc_mat[row, rel]) if 0 <= rel < span else 0
            if k > 0 and used + k <= m_cap:
                alloc[a.job.job_id] = k
                used += k
        # Underestimated jobs outlive the plan: forced fallback at k_min.
        for a in live:
            if a.slack_left <= 0 and a.job.job_id not in alloc:
                k = int(a.job.k_min)
                if used + k <= m_cap:
                    alloc[a.job.job_id] = k
                    used += k
        return m_cap, alloc

    def on_completion(self, t, job, violated) -> None:
        pass
