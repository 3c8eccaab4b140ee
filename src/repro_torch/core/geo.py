"""Geo-distributed placement and scheduling policies.

CarbonFlex shifts work in *time*; the policies here extend the same
cluster machinery to shifting work in *space* across regions with aligned
CI traces (Radovanović et al.'s cross-location flexible load, CarbonScaler
elasticity profiles telling us which jobs tolerate relocation):

- ``geo-static``  — the spatial status quo: every job pinned to its
  arrival region, FCFS at base scale (carbon-agnostic per region);
- ``geo-greedy``  — admission-time placement into the currently cleanest
  region with free capacity, and migration of started jobs when the
  instantaneous CI gap pays for the move;
- ``geo-flex``    — CarbonFlex-style state extended with the per-region
  day-ahead CI rank: placement by forecast over the job's estimated run,
  per-region suspend/resume on the forecast-percentile threshold, and
  suspend-migrate-resume when the forecast gap between regions exceeds
  the migration carbon cost (checkpoint/restore slots + transfer energy
  charged by the engine's :class:`~repro_torch.core.types.MigrationModel`).

All three run non-elastically at ``k_min`` — the spatial axis is studied
orthogonally to the elasticity axis, as in the paper's §6 ablations.

The engine drives them through the :class:`GeoPolicy` protocol: per slot
``decide_geo`` sees the active set (views exposing ``region`` and
``migrating`` on top of the single-region attributes) and returns a
per-region provisioning vector plus ``{job_id: (region, k)}``.  Returning
a region different from the job's current one is a *placement* while the
job has never run (free) and a *migration request* once it has (the
engine suspends the job for the migration window and charges the cost).
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np

from .carbon import MultiRegionCarbonService
from .types import GeoCluster, Job

_EPS = 1e-9


@runtime_checkable
class GeoPolicy(Protocol):
    """Placement+scheduling protocol the geo engines drive."""

    name: str

    def on_window_start(self, mci: MultiRegionCarbonService, t0: int,
                        horizon: int, jobs: list[Job],
                        geo: GeoCluster) -> None: ...

    def decide_geo(self, t: int, active: list, mci: MultiRegionCarbonService,
                   geo: GeoCluster) -> tuple[np.ndarray, dict[int, tuple[int, int]]]: ...

    def on_completion(self, t: int, job, violated: bool) -> None: ...


def _fcfs_order(active) -> list:
    """FCFS decision order shared by every geo policy: forced jobs first,
    then arrival/job_id; done and in-transit jobs are not schedulable."""
    return sorted((a for a in active if not a.done and not a.migrating),
                  key=lambda a: (not a.forced, a.job.arrival, a.job.job_id))


@dataclasses.dataclass
class GeoStaticPolicy:
    """Spatial status quo: jobs pinned to their arrival region, FCFS at
    base scale with full per-region capacity — the baseline every geo
    policy is measured against."""

    name: str = "geo-static"

    def on_window_start(self, mci, t0, horizon, jobs, geo) -> None:
        pass

    def decide_geo(self, t, active, mci, geo):
        m_vec = geo.capacity_vec()
        used = np.zeros(geo.n_regions, dtype=np.int64)
        alloc: dict[int, tuple[int, int]] = {}
        for a in _fcfs_order(active):
            r, k = a.region, a.job.k_min
            if used[r] + k <= m_vec[r]:
                alloc[a.job.job_id] = (r, k)
                used[r] += k
        return m_vec, alloc

    def on_completion(self, t, job, violated) -> None:
        pass


@dataclasses.dataclass
class GeoGreedyPolicy:
    """Admit each job to the currently cleanest region with free base
    capacity (ties -> lowest region index), and migrate started jobs when
    the *instantaneous* CI gap pays for the move.

    Greedy means myopic, not immobile: every decision — placement and
    migration alike — reads only the current CI vector, never the
    forecast (that is geo-flex's edge).  The myopic migration rule below
    keeps the greedy/flex contrast; a two-region trace whose CI ranking
    flips after the job starts pins it (``tests/test_torch_geo.py``)."""

    saving_margin: float = 0.25        # relative saving required to move
    max_migrations_per_job: int = 1    # ping-pong guard
    name: str = "geo-greedy"

    def on_window_start(self, mci, t0, horizon, jobs, geo) -> None:
        self._placed: dict[int, int] = {}
        self._moves: dict[int, int] = {}

    def decide_geo(self, t, active, mci, geo):
        m_vec = geo.capacity_vec()
        used = np.zeros(geo.n_regions, dtype=np.int64)
        ci_now = mci.ci_vec(t)
        clean_order = np.argsort(ci_now, kind="stable")
        alloc: dict[int, tuple[int, int]] = {}
        for a in _fcfs_order(active):
            jid, k = a.job.job_id, a.job.k_min
            if jid not in self._placed:
                if a.started:
                    self._placed[jid] = a.region
                else:
                    r = next((int(rr) for rr in clean_order
                              if used[rr] + k <= m_vec[rr]), None)
                    if r is None:
                        continue          # nothing free: retry next slot
                    self._placed[jid] = r
            r = self._placed[jid]
            if a.started:
                dest = self._migration_target(a, r, ci_now, geo)
                if dest is not None:
                    alloc[jid] = (dest, k)        # engine starts the move
                    self._placed[jid] = dest
                    self._moves[jid] = self._moves.get(jid, 0) + 1
                    continue
            if used[r] + k <= m_vec[r]:
                alloc[jid] = (r, k)
                used[r] += k
        return m_vec, alloc

    def _migration_target(self, a, r: int, ci_now: np.ndarray,
                          geo: GeoCluster) -> int | None:
        """Destination iff moving beats staying *at current CI* by the
        margin — the forecast-free analogue of geo-flex's rule, with the
        same slack/remaining guards against unfinishable moves."""
        if self._moves.get(a.job.job_id, 0) >= self.max_migrations_per_job:
            return None
        mig_slots = geo.migration.slots(a.job)
        if a.slack_left <= mig_slots + 1 or a.remaining <= mig_slots:
            return None
        h = int(max(1, np.ceil(a.remaining)))
        power = a.job.power if a.job.power > 0 else geo.power_per_server
        e_run = a.job.k_min * power * geo.slot_hours * h
        stay = float(ci_now[r]) * e_run
        mig_carbon = np.array([geo.migration.carbon_g(a.job, c)
                               for c in ci_now])
        move = ci_now * e_run + mig_carbon
        move[r] = np.inf
        best = int(np.argmin(move))
        if move[best] < stay * (1.0 - self.saving_margin):
            return best
        return None

    def on_completion(self, t, job, violated) -> None:
        jid = job.job.job_id
        self._placed.pop(jid, None)
        self._moves.pop(jid, None)


@dataclasses.dataclass
class GeoFlexPolicy:
    """CarbonFlex's provisioning/scheduling state extended in space.

    Per region the policy keeps the day-ahead forecast block and runs the
    suspend/resume rule on a forecast-percentile threshold (the rank
    feature of Table 2 generalised per region: a slot is runnable when it
    is among the region's cleanest ``percentile`` % of the next day, or
    the job is forced).  On top:

    - *placement* — an arriving job goes to the region with the lowest
      mean forecast over its estimated run (capacity permitting);
    - *migration* — a started job suspends-migrates-resumes when some
      other region's forecast over the remaining work, shifted past the
      migration window, undercuts staying put by more than the migration
      carbon (transfer energy at the destination's current CI) times the
      hysteresis margin — and only while enough slack remains to absorb
      the checkpoint/restore slots.
    """

    percentile: float = 40.0
    lookahead: int = 24
    saving_margin: float = 0.25        # relative saving required to move
    max_migrations_per_job: int = 1    # ping-pong guard
    name: str = "geo-flex"

    def on_window_start(self, mci, t0, horizon, jobs, geo) -> None:
        self._placed: dict[int, int] = {}
        self._moves: dict[int, int] = {}

    def decide_geo(self, t, active, mci, geo):
        m_vec = geo.capacity_vec()
        n_regions = geo.n_regions
        fc = mci.forecast_matrix(t, self.lookahead)       # (R, H)
        ci_now = mci.ci_vec(t)
        thresh = np.percentile(fc, self.percentile, axis=1)
        used = np.zeros(n_regions, dtype=np.int64)
        alloc: dict[int, tuple[int, int]] = {}
        for a in _fcfs_order(active):
            jid, k = a.job.job_id, a.job.k_min
            if not a.started:
                if jid not in self._placed:
                    h = int(min(self.lookahead, max(1, np.ceil(a.remaining))))
                    means = fc[:, :h].mean(axis=1)
                    order = np.argsort(means, kind="stable")
                    r = next((int(rr) for rr in order
                              if used[rr] + k <= m_vec[rr]), None)
                    if r is None:
                        continue          # nothing free: retry next slot
                    self._placed[jid] = r
                r = self._placed[jid]
            else:
                r = a.region
                dest = self._migration_target(a, r, fc, ci_now, geo)
                if dest is not None:
                    alloc[jid] = (dest, k)        # engine starts the move
                    self._placed[jid] = dest
                    self._moves[jid] = self._moves.get(jid, 0) + 1
                    continue
            if a.forced or ci_now[r] <= thresh[r] + _EPS:
                if used[r] + k <= m_vec[r]:
                    alloc[jid] = (r, k)
                    used[r] += k
        return m_vec, alloc

    def _migration_target(self, a, r: int, fc: np.ndarray,
                          ci_now: np.ndarray, geo: GeoCluster) -> int | None:
        """Destination region iff moving beats staying by the margin."""
        if self._moves.get(a.job.job_id, 0) >= self.max_migrations_per_job:
            return None
        mig_slots = geo.migration.slots(a.job)
        if a.slack_left <= mig_slots + 1 or a.remaining <= mig_slots:
            return None
        h = int(min(self.lookahead - mig_slots, max(1, np.ceil(a.remaining))))
        if h < 1:
            return None
        power = a.job.power if a.job.power > 0 else geo.power_per_server
        e_run = a.job.k_min * power * geo.slot_hours * h
        stay = float(fc[r, :h].mean()) * e_run
        mig_carbon = np.array([geo.migration.carbon_g(a.job, c)
                               for c in ci_now])
        move = fc[:, mig_slots:mig_slots + h].mean(axis=1) * e_run + mig_carbon
        move[r] = np.inf
        best = int(np.argmin(move))
        if move[best] < stay * (1.0 - self.saving_margin):
            return best
        return None

    def on_completion(self, t, job, violated) -> None:
        jid = job.job.job_id
        self._placed.pop(jid, None)
        self._moves.pop(jid, None)
