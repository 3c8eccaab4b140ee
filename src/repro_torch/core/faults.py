"""Resilience subsystem: structured fault processes + carbon-feed outages.

CarbonFlex's value proposition is suspend/resume and rescale under a
*changing* environment, yet the original disturbance model was a single
iid per-job straggler/failure coin-flip plus a carbon feed that is always
fresh.  This module makes failure a pluggable, structured process:

- :class:`IidFaults`         — the historical ``FaultModel`` semantics,
  bit-for-bit (``FaultModel`` is kept as an alias / deprecation shim);
- :class:`CorrelatedFaults`  — a seeded Markov (burst on/off) outage
  process over *failure domains* (node group / rack / region slice) that
  removes capacity for a duration and evicts the jobs placed there;
- :class:`PreemptionFaults`  — per-job kill events with checkpoint/restore
  semantics: work since the last checkpoint is lost, a configurable
  checkpoint cadence charges overhead slots, and the restore transfer is
  billed at the *current* CI (the :class:`~repro_torch.core.types.MigrationModel`
  accounting shape).

Separately, :class:`CarbonDataOutage` + :class:`DegradedCIView` inject
stale/gap windows into ``CarbonService`` / ``MultiRegionCarbonService``:
while the feed is stale the policy stack sees last-known-good values, and
past ``stale_after`` slots it falls back to last-known-good +
:class:`~repro_torch.core.forecast.PersistenceForecast` instead of reading
garbage.  ``fetch`` exposes the retry/backoff schedule.  Recovery metrics
(evictions, lost work, time degraded, MTTR) land on
``SimResult.resilience``.

Both simulator engines consume a fault process through the *same*
``begin_slot``/``available_capacity``/``apply`` calls in the same
row-ordered job sequence, so cross-engine bit-identity holds by
construction.  The module is host numpy: the processes draw their RNG
mid-slot, so ``engine="scan"`` runs a faulted case on the vector engine,
while a carbon-feed outage (a pure per-slot function of the trace) runs on
the device slot loop.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Protocol, Sequence, runtime_checkable

import numpy as np

from .forecast import (ForecastFeatureMixin, PersistenceForecast,
                       _trace_salt)
from .types import Job, ResilienceMetrics


@dataclasses.dataclass
class SlotDisturbance:
    """What a fault process did to one slot's allocated live jobs.

    ``factors`` scales each job's progress this slot (0 = slot lost).
    ``lost`` is per-job work *re-added* to ``remaining`` after the progress
    update (checkpoint rollback).  ``extra_energy`` is per-job energy (kWh)
    charged this slot at the current CI (restore transfer).  ``evicted``
    flags jobs kicked off failed capacity.  The optional arrays stay
    ``None`` when untouched so the legacy paths skip them entirely —
    bit-identical floats to the pre-subsystem engines."""

    factors: np.ndarray
    lost: np.ndarray | None = None
    extra_energy: np.ndarray | None = None
    evicted: np.ndarray | None = None


@runtime_checkable
class FaultProcess(Protocol):
    """The disturbance protocol both simulator engines drive.

    Per run: ``on_run_start(t0, capacity)`` resets the seeded RNG and all
    per-run state (so one instance is reusable across ``simulate`` calls
    with reproducible streams).  Per slot, in engine order:
    ``begin_slot(t)`` advances environment chains (before the policy
    decides), ``available_capacity``/``available_capacity_vec`` report the
    capacity the scheduler may use, and ``apply`` disturbs the allocated
    live jobs (row order — identical across engines).  ``run_metrics``
    summarises the run."""

    kind: str

    def on_run_start(self, t0: int, capacity) -> None: ...

    def begin_slot(self, t: int) -> None: ...

    def available_capacity(self, capacity: int) -> int: ...

    def available_capacity_vec(self, caps: np.ndarray) -> np.ndarray: ...

    def apply(self, t: int, jobs: Sequence[Job], k: np.ndarray,
              remaining: np.ndarray, thr: np.ndarray,
              regions: np.ndarray | None = None) -> SlotDisturbance: ...

    def run_metrics(self) -> ResilienceMetrics: ...


@dataclasses.dataclass
class IidFaults:
    """Iid per-job straggler/failure injection.

    Each slot, every allocated job independently suffers a *straggler*
    event with probability ``straggler_rate`` (progress scaled by
    ``straggler_slowdown``) or a *failure* with probability
    ``failure_rate`` (the slot's progress is lost).  Seeded and
    deterministic; bit-for-bit the historical ``FaultModel`` behaviour
    (``FaultModel`` aliases this class).  ``on_run_start`` re-seeds the
    stream, so reusing one instance across simulations is reproducible."""

    straggler_rate: float = 0.0
    straggler_slowdown: float = 0.5
    failure_rate: float = 0.0
    seed: int = 0

    kind: ClassVar[str] = "iid"

    def __post_init__(self) -> None:
        self._reset()

    def _reset(self) -> None:
        self._rng = np.random.default_rng(self.seed)
        self._lost_work = 0.0

    # --- FaultProcess protocol ---------------------------------------------

    def on_run_start(self, t0: int, capacity) -> None:
        self._reset()

    def begin_slot(self, t: int) -> None:
        pass

    def available_capacity(self, capacity: int) -> int:
        return capacity

    def available_capacity_vec(self, caps: np.ndarray) -> np.ndarray:
        return caps

    def apply(self, t: int, jobs: Sequence[Job], k: np.ndarray,
              remaining: np.ndarray, thr: np.ndarray,
              regions: np.ndarray | None = None) -> SlotDisturbance:
        f = self.draw_factors(len(thr))
        if len(thr):
            self._lost_work += float(np.sum(thr * (1.0 - f)))
        return SlotDisturbance(factors=f)

    def run_metrics(self) -> ResilienceMetrics:
        return ResilienceMetrics(lost_work_slots=self._lost_work)

    # --- historical FaultModel surface -------------------------------------

    def progress_factor(self, t: int, job_id: int) -> float:
        u = self._rng.random()
        if u < self.failure_rate:
            return 0.0
        if u < self.failure_rate + self.straggler_rate:
            return self.straggler_slowdown
        return 1.0

    def draw_factors(self, count: int) -> np.ndarray:
        """Vectorised batch of ``count`` progress factors.

        ``Generator.random(count)`` consumes exactly the same underlying
        bit stream as ``count`` successive ``progress_factor`` calls, so
        the vector engine's per-slot batch draw reproduces the scalar
        engine's sequential draws bit-for-bit (asserted by the parity
        tests)."""
        u = self._rng.random(count)
        return np.where(
            u < self.failure_rate, 0.0,
            np.where(u < self.failure_rate + self.straggler_rate,
                     self.straggler_slowdown, 1.0))


#: Deprecation shim: the historical name resolves to the iid process.  An
#: alias (not a subclass) so dataclass equality, ``isinstance`` checks and
#: ``dataclasses.replace`` keep working across old and new call sites.
FaultModel = IidFaults


@dataclasses.dataclass
class CorrelatedFaults:
    """Markov burst outages over failure domains (rack / zone slices).

    The cluster's server positions are partitioned into ``n_domains``
    near-equal contiguous domains.  Each slot every *up* domain fails with
    probability ``rate`` and every *down* domain recovers with probability
    ``1/mean_duration`` (geometric outage length with mean
    ``mean_duration`` slots).  A failure is revealed mid-slot: the
    scheduler only sees the shrunken capacity from the *next* slot on,
    and every job whose servers land in the failed domain this slot is
    evicted (the slot's progress is lost; the job re-queues under the
    reduced capacity).  Job placement is the engines' row-ordered
    sequential packing into the domains that were up at decision time —
    deterministic, hence bit-identical across engines."""

    n_domains: int = 4
    rate: float = 0.02
    mean_duration: float = 8.0
    seed: int = 0

    kind: ClassVar[str] = "correlated"

    def __post_init__(self) -> None:
        if self.n_domains < 1:
            raise ValueError("CorrelatedFaults needs n_domains >= 1")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")
        if self.mean_duration < 1.0:
            raise ValueError("mean_duration must be >= 1 slot")
        self.on_run_start(0, 0)

    # --- FaultProcess protocol ---------------------------------------------

    def on_run_start(self, t0: int, capacity) -> None:
        caps = np.atleast_1d(np.asarray(capacity, dtype=np.int64))
        self._region_caps = caps
        self._rlo = np.concatenate(([0], np.cumsum(caps)))
        total = int(caps.sum())
        base, rem = divmod(total, self.n_domains)
        self._dcaps = np.array([base + (1 if i < rem else 0)
                                for i in range(self.n_domains)],
                               dtype=np.int64)
        self._dlo = np.concatenate(([0], np.cumsum(self._dcaps)))
        self._down = np.zeros(self.n_domains, dtype=bool)
        self._newly = np.zeros(self.n_domains, dtype=bool)
        self._down_at = np.zeros(self.n_domains, dtype=np.int64)
        self._rng = np.random.default_rng(self.seed)
        self._evictions = 0
        self._lost_work = 0.0
        self._outages = 0
        self._mttr_sum = 0
        self._mttr_n = 0

    def begin_slot(self, t: int) -> None:
        # last slot's failures become known to the scheduler now
        self._down |= self._newly
        self._newly = np.zeros(self.n_domains, dtype=bool)
        u = self._rng.random(self.n_domains)
        p_rec = 1.0 / self.mean_duration
        for i in range(self.n_domains):
            if self._down[i]:
                if u[i] < p_rec:
                    self._down[i] = False
                    self._mttr_sum += int(t - self._down_at[i])
                    self._mttr_n += 1
            elif u[i] < self.rate and self._dcaps[i] > 0:
                self._newly[i] = True
                self._down_at[i] = t
                self._outages += 1

    def available_capacity(self, capacity: int) -> int:
        lost = int(self._dcaps[self._down].sum())
        return max(0, int(capacity) - lost)

    def available_capacity_vec(self, caps: np.ndarray) -> np.ndarray:
        out = np.asarray(caps, dtype=np.int64).copy()
        for d in np.flatnonzero(self._down):
            dlo, dhi = int(self._dlo[d]), int(self._dlo[d + 1])
            for r in range(len(out)):
                a = max(dlo, int(self._rlo[r]))
                b = min(dhi, int(self._rlo[r + 1]))
                if a < b:
                    out[r] -= b - a
        return np.maximum(out, 0)

    def _up_segments(self, lo: int, hi: int) -> list[tuple[int, bool]]:
        """(length, failed_this_slot) runs of up-at-decision-time server
        positions inside ``[lo, hi)``, in position order."""
        segs = []
        for d in range(self.n_domains):
            a = max(lo, int(self._dlo[d]))
            b = min(hi, int(self._dlo[d + 1]))
            if a < b and not self._down[d]:
                segs.append((b - a, bool(self._newly[d])))
        return segs

    def apply(self, t: int, jobs: Sequence[Job], k: np.ndarray,
              remaining: np.ndarray, thr: np.ndarray,
              regions: np.ndarray | None = None) -> SlotDisturbance:
        m = len(thr)
        f = np.ones(m)
        if m == 0 or not self._newly.any():
            return SlotDisturbance(factors=f)
        regs = (np.zeros(m, dtype=np.int64) if regions is None
                else np.asarray(regions, dtype=np.int64))
        ev = np.zeros(m, dtype=bool)
        for r in range(len(self._region_caps)):
            segs = self._up_segments(int(self._rlo[r]), int(self._rlo[r + 1]))
            total_up = sum(length for length, _ in segs)
            off = 0
            for i in np.flatnonzero(regs == r):
                kk = int(k[i])
                lo, hi = off, off + kk
                off = hi
                if hi > total_up:
                    ev[i] = True       # spilled past usable capacity
                    continue
                pos = 0
                for length, newly in segs:
                    nxt = pos + length
                    if newly and lo < nxt and hi > pos:
                        ev[i] = True
                        break
                    pos = nxt
                    if pos >= hi:
                        break
        if ev.any():
            f[ev] = 0.0
            self._evictions += int(ev.sum())
            self._lost_work += float(np.sum(thr[ev]))
            return SlotDisturbance(factors=f, evicted=ev)
        return SlotDisturbance(factors=f)

    def run_metrics(self) -> ResilienceMetrics:
        mttr = self._mttr_sum / self._mttr_n if self._mttr_n else 0.0
        return ResilienceMetrics(
            evictions=self._evictions, lost_work_slots=self._lost_work,
            capacity_outages=self._outages, mttr_slots=mttr)


@dataclasses.dataclass
class PreemptionFaults:
    """Per-job preemption with checkpoint/restore semantics.

    Each slot every allocated job is killed with probability ``rate``:
    progress since its last checkpoint is rolled back, the checkpoint
    payload (``max(min_gb, comm_size)`` GB — the
    :class:`~repro_torch.core.types.MigrationModel` shape) is re-transferred at
    ``energy_kwh_per_gb``, billed at the *current* CI, and the job then
    spends ``restore_slots`` slots restoring: holding its servers and
    burning energy without progress.  Every ``checkpoint_every``-th
    uninterrupted running slot is a checkpoint slot, charging
    ``checkpoint_overhead`` of that slot's progress to save state."""

    rate: float = 0.05
    checkpoint_every: int = 4
    checkpoint_overhead: float = 0.25
    restore_slots: int = 1
    energy_kwh_per_gb: float = 0.05
    min_gb: float = 1.0
    seed: int = 0

    kind: ClassVar[str] = "preemption"

    def __post_init__(self) -> None:
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")
        if self.checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1 slot")
        if not 0.0 <= self.checkpoint_overhead < 1.0:
            raise ValueError("checkpoint_overhead must be in [0, 1)")
        if self.restore_slots < 0:
            raise ValueError("restore_slots must be >= 0")
        self.on_run_start(0, 0)

    # --- FaultProcess protocol ---------------------------------------------

    def on_run_start(self, t0: int, capacity) -> None:
        self._rng = np.random.default_rng(self.seed)
        self._ckpt: dict[int, float] = {}        # remaining at last ckpt
        self._run_slots: dict[int, int] = {}     # slots since last restart
        self._restore: dict[int, int] = {}       # restore slots left
        self._preemptions = 0
        self._lost_work = 0.0
        self._restore_energy = 0.0

    def begin_slot(self, t: int) -> None:
        pass

    def available_capacity(self, capacity: int) -> int:
        return capacity

    def available_capacity_vec(self, caps: np.ndarray) -> np.ndarray:
        return caps

    def apply(self, t: int, jobs: Sequence[Job], k: np.ndarray,
              remaining: np.ndarray, thr: np.ndarray,
              regions: np.ndarray | None = None) -> SlotDisturbance:
        m = len(thr)
        f = np.ones(m)
        lost: np.ndarray | None = None
        extra: np.ndarray | None = None
        u = self._rng.random(m)
        for i in range(m):
            jid = jobs[i].job_id
            rleft = self._restore.get(jid, 0)
            if rleft > 0:
                # restoring: holds servers, burns energy, no progress
                f[i] = 0.0
                self._restore[jid] = rleft - 1
                continue
            if u[i] < self.rate:
                # killed: roll back to the last checkpoint and re-transfer
                f[i] = 0.0
                ckpt = self._ckpt.get(jid, jobs[i].length)
                rb = float(ckpt - remaining[i])
                if rb != 0.0:
                    if lost is None:
                        lost = np.zeros(m)
                    lost[i] = rb
                e = self.energy_kwh_per_gb * max(self.min_gb,
                                                 jobs[i].comm_size)
                if extra is None:
                    extra = np.zeros(m)
                extra[i] = e
                self._preemptions += 1
                self._lost_work += rb + float(thr[i])
                self._restore_energy += e
                if self.restore_slots > 0:
                    self._restore[jid] = self.restore_slots
                self._run_slots[jid] = 0
                continue
            ns = self._run_slots.get(jid, 0) + 1
            self._run_slots[jid] = ns
            if ns % self.checkpoint_every == 0:
                # checkpoint slot: part of the slot goes to saving state;
                # the stored value is the engine's exact post-slot
                # remaining (same IEEE expression), so a later rollback
                # restores it bit-for-bit
                f[i] = 1.0 - self.checkpoint_overhead
                self._ckpt[jid] = float(remaining[i] - thr[i] * f[i])
        return SlotDisturbance(factors=f, lost=lost, extra_energy=extra)

    def run_metrics(self) -> ResilienceMetrics:
        return ResilienceMetrics(
            preemptions=self._preemptions, lost_work_slots=self._lost_work,
            restore_energy_kwh=self._restore_energy)


class _LegacyFaultAdapter:
    """FaultProcess facade over a foreign object that only implements the
    historical ``draw_factors`` surface (API compat for user-defined fault
    models predating the protocol)."""

    kind = "legacy"

    def __init__(self, inner) -> None:
        self.inner = inner

    def on_run_start(self, t0: int, capacity) -> None:
        pass                           # legacy models manage their own stream

    def begin_slot(self, t: int) -> None:
        pass

    def available_capacity(self, capacity: int) -> int:
        return capacity

    def available_capacity_vec(self, caps: np.ndarray) -> np.ndarray:
        return caps

    def apply(self, t: int, jobs: Sequence[Job], k: np.ndarray,
              remaining: np.ndarray, thr: np.ndarray,
              regions: np.ndarray | None = None) -> SlotDisturbance:
        return SlotDisturbance(factors=self.inner.draw_factors(len(thr)))

    def run_metrics(self) -> ResilienceMetrics:
        return ResilienceMetrics()


def ensure_fault_process(faults):
    """Adapt whatever the caller passed as ``faults`` to the protocol."""
    if faults is None or hasattr(faults, "apply"):
        return faults
    if hasattr(faults, "draw_factors"):
        return _LegacyFaultAdapter(faults)
    raise TypeError(f"{type(faults).__name__} implements neither the "
                    f"FaultProcess protocol nor the legacy draw_factors "
                    f"surface")


# --- carbon-data outages ------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CarbonDataOutage:
    """Stale/gap windows of the carbon-intensity feed.

    Either explicit ``windows`` (``(lo, hi)`` slot ranges, hi exclusive)
    or a seeded Markov process: each slot the feed goes stale with
    probability ``rate`` and recovers with probability
    ``1/mean_duration``.  Slot 0 is always fresh (a last-known-good value
    must exist).  ``stale_after`` is the staleness threshold past which
    policies stop trusting the last issued forecast and fall back to
    last-known-good + persistence (:class:`DegradedCIView`).
    ``retry_delay`` is the exponential-backoff schedule of the feed
    re-fetch loop surfaced by :meth:`DegradedCIView.fetch`."""

    rate: float = 0.01
    mean_duration: float = 6.0
    stale_after: int = 3
    backoff_base: int = 1
    backoff_cap: int = 16
    seed: int = 0
    windows: tuple[tuple[int, int], ...] = ()

    kind: ClassVar[str] = "carbon-outage"

    def __post_init__(self) -> None:
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")
        if self.mean_duration < 1.0:
            raise ValueError("mean_duration must be >= 1 slot")
        if self.stale_after < 0:
            raise ValueError("stale_after must be >= 0")
        if self.backoff_base < 1 or self.backoff_cap < self.backoff_base:
            raise ValueError("need 1 <= backoff_base <= backoff_cap")
        # normalize (JSON round-trips lists of lists)
        object.__setattr__(self, "windows", tuple(
            (int(lo), int(hi)) for lo, hi in self.windows))
        for lo, hi in self.windows:
            if lo >= hi:
                raise ValueError(f"empty outage window ({lo}, {hi})")

    def stale_mask(self, n: int, trace: np.ndarray) -> np.ndarray:
        """Boolean per-slot staleness over an ``n``-slot trace.  The RNG
        stream is salted per trace so aligned multi-region services sharing
        one config see *independent* outages."""
        mask = np.zeros(n, dtype=bool)
        if self.windows:
            for lo, hi in self.windows:
                mask[max(lo, 0):min(hi, n)] = True
        elif self.rate > 0.0:
            rng = np.random.default_rng(np.random.SeedSequence(
                [3, self.seed, _trace_salt(trace)]))
            u = rng.random(n)
            p_rec = 1.0 / self.mean_duration
            down = False
            for t in range(n):
                if down:
                    if u[t] < p_rec:
                        down = False
                elif u[t] < self.rate:
                    down = True
                mask[t] = down
        if n:
            mask[0] = False            # slot 0 is always observed
        return mask

    def retry_delay(self, attempt: int) -> int:
        """Backoff (slots) before retry number ``attempt`` (0-based)."""
        return int(min(self.backoff_cap,
                       self.backoff_base * 2 ** max(int(attempt), 0)))


@dataclasses.dataclass(frozen=True)
class FeedSample:
    """One read of the (possibly stale) carbon feed."""

    value: float
    fresh: bool
    staleness: int                    # slots since the last fresh sample
    attempts: int                     # re-fetches issued since it went stale
    next_retry_in: int                # slots until the next scheduled retry


# NOTE on imports: carbon.py imports this module (CarbonService grows an
# ``outage`` field + ``degraded()``), so nothing here may import carbon.
# The views below duck-type over any service exposing trace/forecast.


class DegradedCIView(ForecastFeatureMixin):
    """What the *policy stack* sees when the carbon feed has outages.

    Observed values forward-fill from the last fresh slot.  Forecasts
    degrade in two stages: while staleness is within ``stale_after`` the
    view re-serves the forecast *issued at the last fresh slot* (shifted
    to the query horizon — stale but still model-grade); past the
    threshold it stops trusting the feed and falls back to
    last-known-good + :class:`PersistenceForecast` over the observed
    (forward-filled) trace.  Deterministic per (service, outage), so both
    engines reading it stay bit-identical.  Accounting always uses the
    *true* service — physics does not go stale."""

    def __init__(self, base, outage: CarbonDataOutage) -> None:
        self.base = base
        self.outage = outage
        n = len(base.trace)
        self._stale = outage.stale_mask(n, base.trace)
        idx = np.arange(n)
        self._lkg = np.maximum.accumulate(np.where(~self._stale, idx, -1))
        self._ffill = np.asarray(base.trace)[self._lkg]
        self._fallback = PersistenceForecast()

    # --- observed surface ---------------------------------------------------

    @property
    def trace(self) -> np.ndarray:
        return self._ffill

    @property
    def horizon(self) -> int:
        return self.base.horizon

    def __len__(self) -> int:
        return len(self.base)

    def staleness(self, t: int) -> int:
        """Slots since the last fresh feed sample at slot ``t`` (0 = fresh)."""
        tt = min(max(int(t), 0), len(self._lkg) - 1)
        return int(tt - self._lkg[tt])

    def ci(self, t: int) -> float:
        return float(self._ffill[min(t, len(self._ffill) - 1)])

    def gradient(self, t: int) -> float:
        if t == 0:
            return 0.0
        prev, cur = self._ffill[t - 1], self._ffill[t]
        return float((cur - prev) / max(prev, 1e-9))

    # --- degraded forecasts -------------------------------------------------

    def forecast(self, t: int, horizon: int | None = None) -> np.ndarray:
        h = int(horizon or self.horizon)
        s = self.staleness(t)
        if s == 0:
            return self.base.forecast(t, h)
        if s <= self.outage.stale_after:
            # stale but trusted: the forecast issued at the last fresh
            # slot, shifted onto the queried horizon
            return self.base.forecast(t - s, s + h)[s:]
        return self._fallback.predict(self._ffill, t, h)

    def forecast_quantile(self, t: int, horizon: int | None = None,
                          q: float = 0.5) -> np.ndarray:
        if self.staleness(t) == 0:
            return self.base.forecast_quantile(t, horizon, q=q)
        return self.forecast(t, horizon)   # degraded mode has no bands

    # --- feed access --------------------------------------------------------

    def fetch(self, t: int) -> FeedSample:
        """Read the feed at slot ``t``, reporting the retry/backoff state
        of the re-fetch loop (exponential backoff per
        :meth:`CarbonDataOutage.retry_delay`)."""
        s = self.staleness(t)
        if s == 0:
            return FeedSample(value=self.ci(t), fresh=True, staleness=0,
                              attempts=0, next_retry_in=0)
        attempts = 0
        elapsed = 0
        while elapsed + self.outage.retry_delay(attempts) <= s:
            elapsed += self.outage.retry_delay(attempts)
            attempts += 1
        nxt = elapsed + self.outage.retry_delay(attempts) - s
        return FeedSample(value=self.ci(t), fresh=False, staleness=s,
                          attempts=attempts, next_retry_in=int(nxt))


class DegradedMultiRegionView:
    """Per-region :class:`DegradedCIView` s behind the
    ``MultiRegionCarbonService`` surface the geo policies read."""

    def __init__(self, base) -> None:
        self.base = base
        self.regions = base.regions
        self.views = tuple(s.degraded() for s in base.services)

    @property
    def n_regions(self) -> int:
        return len(self.regions)

    def __len__(self) -> int:
        return len(self.base)

    def index(self, region: str) -> int:
        return self.base.index(region)

    def service(self, region):
        if isinstance(region, str):
            region = self.index(region)
        return self.views[region]

    def ci(self, t: int, region=0) -> float:
        return self.service(region).ci(t)

    def ci_vec(self, t: int) -> np.ndarray:
        return np.array([v.ci(t) for v in self.views])

    def forecast_matrix(self, t: int, horizon: int | None = None) -> np.ndarray:
        return np.stack([v.forecast(t, horizon) for v in self.views])

    def rank_vec(self, t: int) -> np.ndarray:
        return np.array([v.rank(t) for v in self.views])

    def cleanest(self, t: int) -> int:
        return int(np.argmin(self.ci_vec(t)))

    def staleness(self, t: int) -> int:
        """Worst staleness across regions (drives the degraded-slot count)."""
        out = 0
        for v in self.views:
            s = getattr(v, "staleness", None)
            if s is not None:
                out = max(out, s(t))
        return out


# --- registry / serialization / labels ---------------------------------------


FAULT_KINDS: dict[str, type] = {
    IidFaults.kind: IidFaults,
    CorrelatedFaults.kind: CorrelatedFaults,
    PreemptionFaults.kind: PreemptionFaults,
}


def fault_to_dict(faults) -> dict | None:
    """JSON-safe payload round-tripped by :func:`fault_from_dict`."""
    if faults is None:
        return None
    kind = getattr(faults, "kind", None)
    if kind not in FAULT_KINDS:
        raise ValueError(f"unregistered fault kind {kind!r}; known kinds: "
                         f"{', '.join(sorted(FAULT_KINDS))}")
    return {"kind": kind,
            **{f.name: getattr(faults, f.name)
               for f in dataclasses.fields(faults)}}


def fault_from_dict(d: dict | None):
    """Inverse of :func:`fault_to_dict`.  A payload without ``kind`` is
    the legacy 4-field ``FaultModel`` shape and resolves to
    :class:`IidFaults`; an unknown kind raises naming the registry."""
    if d is None:
        return None
    d = dict(d)
    kind = d.pop("kind", IidFaults.kind)
    try:
        cls = FAULT_KINDS[kind]
    except KeyError:
        raise ValueError(f"unknown fault kind {kind!r}; known kinds: "
                         f"{', '.join(sorted(FAULT_KINDS))}") from None
    return cls(**d)


def outage_to_dict(outage: CarbonDataOutage | None) -> dict | None:
    if outage is None:
        return None
    d = {"kind": outage.kind,
         **{f.name: getattr(outage, f.name)
            for f in dataclasses.fields(outage)}}
    d["windows"] = [list(w) for w in outage.windows]
    return d


def outage_from_dict(d: dict | None) -> CarbonDataOutage | None:
    if d is None:
        return None
    d = dict(d)
    kind = d.pop("kind", CarbonDataOutage.kind)
    if kind != CarbonDataOutage.kind:
        raise ValueError(f"unknown carbon-outage kind {kind!r}; expected "
                         f"{CarbonDataOutage.kind!r}")
    return CarbonDataOutage(**d)


def fault_label(fm) -> str:
    """Short sweep-row label per fault process (the iid format is frozen —
    golden fixtures and EXPERIMENTS tables key on it)."""
    if fm is None:
        return "none"
    kind = getattr(fm, "kind", None)
    if kind == "iid":
        return f"straggler={fm.straggler_rate:g},failure={fm.failure_rate:g}"
    if kind == "correlated":
        return (f"outage(d={fm.n_domains},p={fm.rate:g},"
                f"len={fm.mean_duration:g})")
    if kind == "preemption":
        return f"preempt(p={fm.rate:g},ckpt={fm.checkpoint_every})"
    return str(kind or "fault")
