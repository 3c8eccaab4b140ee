"""Core datatypes for the CarbonFlex cluster resource manager.

The unit model follows Section 3 of the paper:

- time is discretised into slots (1 hour in the paper, configurable);
- a *job* j arrives at slot ``a_j``, carries ``l_j`` slots of work measured
  at its base scale ``k_min`` (throughput at ``k_min`` is normalised to 1),
  and is submitted to a queue with slack ``d_i`` slots;
- allocating ``k`` servers to job j during one slot advances its progress by
  ``throughput(k) = sum_{i<=k} p_j(i)`` where ``p_j`` is the (monotone
  decreasing) marginal-throughput profile with ``p_j(k_min) = 1``.

A job may be one task of a DAG: ``Job.deps`` names its predecessors (see
``core/dag.py``).  A ``GeoCluster`` spreads the capacity over regions with
aligned CI traces, and a ``MigrationModel`` prices moving a running job
between them (``core/geo.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class QueueConfig:
    """A submission queue with a slack (maximum tolerated delay), in slots."""

    name: str
    delay: int                     # d_i: max waiting/paused slots
    max_length: float = np.inf     # jobs with l_j <= max_length go here


# The paper's default queue setup (Section 6.1): short<=2h -> 6h slack,
# medium<=12h -> 24h, long -> 48h.
def default_queues(scale: float = 1.0) -> list[QueueConfig]:
    return [
        QueueConfig("short", delay=max(1, int(6 * scale)), max_length=2),
        QueueConfig("medium", delay=max(1, int(24 * scale)), max_length=12),
        QueueConfig("long", delay=max(1, int(48 * scale)), max_length=np.inf),
    ]


@dataclasses.dataclass
class Job:
    """An elastic batch job (Section 3), optionally one task of a DAG.

    ``deps`` lists the ``job_id`` s of predecessor tasks in the same
    submitted job list: the engines gate this job until every predecessor
    has completed (see ``core/dag.py`` for the DAG model and the
    precedence-aware policies).  Independent jobs leave it empty.  While
    gated the job is invisible to the policy, burns no waiting budget, and
    its slack/deadline count from its *release* slot instead of arrival."""

    job_id: int
    arrival: int                   # a_j, slot index
    length: float                  # l_j, slots of work at scale k_min
    queue: int                     # index into the cluster's queue list
    delay: int                     # d_j, slack in slots (from the queue)
    profile: np.ndarray            # marginal throughput, profile[i] = p(k_min + i)
    k_min: int = 1
    # Per-server-slot energy in kWh (E^R of Eq. 2) and per-slot network
    # traffic at scale k in GB (feeds E^net = eta_net * Mem, Eq. 3).
    power: float = 1.0
    comm_size: float = 0.0
    arch: str = "generic"          # which assigned architecture this job trains
    deps: tuple[int, ...] = ()     # predecessor job_ids (precedence gating)

    @property
    def k_max(self) -> int:
        return self.k_min + len(self.profile) - 1

    @property
    def deadline(self) -> int:
        """Latest slot (exclusive) by which the job must finish."""
        return int(self.arrival + int(np.ceil(self.length)) + self.delay)

    def throughput(self, k: int) -> float:
        """Cumulative normalised throughput at scale k."""
        if k <= 0:
            return 0.0
        k = min(k, self.k_max)
        return float(np.sum(self.profile[: k - self.k_min + 1]))

    def marginal(self, k: int) -> float:
        """Marginal throughput p_j(k) of the k-th server."""
        if k < self.k_min or k > self.k_max:
            return 0.0
        return float(self.profile[k - self.k_min])

    def elasticity(self) -> float:
        """Scalar elasticity summary used in the Table-2 state (mean marginal
        throughput over the profile — 1.0 means perfectly linear scaling)."""
        return float(np.mean(self.profile))


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """Cluster-level configuration (Section 3)."""

    capacity: int                          # M: max concurrently usable servers
    queues: tuple[QueueConfig, ...]
    slot_hours: float = 1.0
    power_per_server: float = 1.0          # kW per server (CPU-cluster mode)
    eta_net: float = 0.1                   # W/Gbps network energy (Section 5)

    @staticmethod
    def default(capacity: int = 150) -> "ClusterConfig":
        return ClusterConfig(capacity=capacity, queues=tuple(default_queues()))


@dataclasses.dataclass(frozen=True)
class MigrationModel:
    """Cost of moving a running job between regions (checkpoint + WAN
    transfer + restore).

    A migration suspends the job for ``slots(job)`` slots — a fixed
    checkpoint/restore overhead plus a term scaling with the job's size
    (bigger jobs have more state to serialise) — during which the job
    burns waiting budget like any paused job.  It also charges a one-off
    transfer energy proportional to the job's state size (``comm_size``
    stands in for the checkpoint payload, floored at ``min_gb``), billed
    at the *destination* region's CI on the initiation slot (restore-side
    accounting)."""

    base_slots: int = 1                # fixed checkpoint+restore slots
    slots_per_length: float = 0.02     # extra suspended slots per slot of work
    energy_kwh_per_gb: float = 0.05    # WAN transfer + restore energy
    min_gb: float = 1.0                # checkpoint payload floor

    def slots(self, job: "Job") -> int:
        return int(self.base_slots + np.ceil(self.slots_per_length * job.length))

    def data_gb(self, job: "Job") -> float:
        return float(max(self.min_gb, job.comm_size))

    def energy_kwh(self, job: "Job") -> float:
        return self.energy_kwh_per_gb * self.data_gb(job)

    def carbon_g(self, job: "Job", ci_dest: float) -> float:
        """Estimated migration carbon when the destination runs at
        ``ci_dest`` (the break-even input of the geo-flex trigger)."""
        return self.energy_kwh(job) * ci_dest


@dataclasses.dataclass(frozen=True)
class GeoCluster:
    """A geo-distributed cluster: per-region capacities over aligned CI
    traces, with a migration cost model (Section 3 generalised in space).

    The scalar knobs (``slot_hours``, ``power_per_server``, ``eta_net``)
    are shared across regions — regions differ in carbon intensity and
    capacity, not hardware — so the energy model (Eq. 2-3) applies
    unchanged per region."""

    regions: tuple[str, ...]
    capacities: tuple[int, ...]
    queues: tuple[QueueConfig, ...]
    migration: MigrationModel = MigrationModel()
    slot_hours: float = 1.0
    power_per_server: float = 1.0
    eta_net: float = 0.1

    def __post_init__(self) -> None:
        if len(self.regions) != len(self.capacities):
            raise ValueError("regions and capacities must align")
        if not self.regions:
            raise ValueError("GeoCluster needs >= 1 region")
        if any(c <= 0 for c in self.capacities):
            raise ValueError(f"capacities must be positive: {self.capacities}")

    @property
    def n_regions(self) -> int:
        return len(self.regions)

    @property
    def capacity(self) -> int:
        """Total capacity across regions (M of the aggregate cluster)."""
        return int(sum(self.capacities))

    def capacity_vec(self) -> np.ndarray:
        return np.array(self.capacities, dtype=np.int64)

    def home_region(self, row: int) -> int:
        """Arrival region of the job at (arrival, job_id)-sorted row
        ``row``: deterministic round-robin, so every region sees a
        balanced submission stream."""
        return row % self.n_regions

    def region_cluster(self, r: int) -> ClusterConfig:
        """Single-region view (capacity of region ``r``, shared queues)."""
        return ClusterConfig(capacity=self.capacities[r], queues=self.queues,
                             slot_hours=self.slot_hours,
                             power_per_server=self.power_per_server,
                             eta_net=self.eta_net)

    @staticmethod
    def split(capacity: int, regions: Sequence[str],
              queues: tuple[QueueConfig, ...] | None = None,
              migration: MigrationModel | None = None,
              **kw) -> "GeoCluster":
        """Split a total capacity evenly across ``regions`` (remainder to
        the first regions), the Scenario default."""
        n = len(regions)
        if n == 0:
            raise ValueError("GeoCluster.split needs >= 1 region")
        base, rem = divmod(int(capacity), n)
        caps = tuple(base + (1 if i < rem else 0) for i in range(n))
        return GeoCluster(regions=tuple(regions), capacities=caps,
                          queues=queues if queues is not None
                          else tuple(default_queues()),
                          migration=migration or MigrationModel(), **kw)


@dataclasses.dataclass
class Schedule:
    """A full allocation matrix produced by the oracle: alloc[j, t] servers."""

    alloc: np.ndarray              # (num_jobs, T) int
    jobs: list[Job]
    feasible: bool
    extended: np.ndarray           # per-job extra slots granted (paper §4.2 fix)


@dataclasses.dataclass
class SlotLog:
    """Per-slot accounting emitted by the simulator."""

    slot: int
    ci: float                       # g CO2 / kWh
    provisioned: int                # m_t
    used: int                       # sum of allocations
    energy_kwh: float
    carbon_g: float
    running: int
    queued: int


@dataclasses.dataclass(frozen=True)
class ResilienceMetrics:
    """Recovery accounting of one simulated window (``core/faults.py``).

    ``lost_work_slots`` counts progress destroyed by faults (evicted /
    failed slots plus checkpoint rollbacks), in base-scale work slots.
    ``mttr_slots`` is the mean duration of *recovered* capacity outages;
    ``degraded_slots`` the slots the policy stack ran on a stale carbon
    feed (:class:`~repro_torch.core.faults.DegradedCIView`)."""

    evictions: int = 0
    preemptions: int = 0
    lost_work_slots: float = 0.0
    restore_energy_kwh: float = 0.0
    capacity_outages: int = 0
    mttr_slots: float = 0.0
    degraded_slots: int = 0

    def to_dict(self) -> dict:
        return {
            "evictions": int(self.evictions),
            "preemptions": int(self.preemptions),
            "lost_work_slots": float(self.lost_work_slots),
            "restore_energy_kwh": float(self.restore_energy_kwh),
            "capacity_outages": int(self.capacity_outages),
            "mttr_slots": float(self.mttr_slots),
            "degraded_slots": int(self.degraded_slots),
        }


@dataclasses.dataclass
class ServingMetrics:
    """Request-serving accounting of one simulated window
    (``serving/engine.py``) — the interactive-traffic counterpart of the
    per-job arrays, which stay empty on serving runs.

    Lives here (like :class:`ResilienceMetrics`) so :class:`SimResult`
    never imports the serving package.  The trajectory arrays
    (``balance`` / ``utilization`` / ``quality`` / ``violation_frac``,
    one entry per slot) are in-memory extras for figures and tests and
    are dropped by ``to_dict``."""

    requests: float = 0.0
    violated_requests: float = 0.0        # SLO-violating requests
    quality_mean: float = 1.0             # request-weighted quality
    ledger_final: float = 0.0
    ledger_min: float = 0.0
    ledger_max: float = 0.0
    tier_names: tuple[str, ...] = ()
    tier_requests: tuple[float, ...] = ()
    balance: np.ndarray | None = None
    utilization: np.ndarray | None = None
    quality: np.ndarray | None = None
    violation_frac: np.ndarray | None = None
    energy: np.ndarray | None = None      # per-slot kWh (telemetry)
    carbon: np.ndarray | None = None      # per-slot gCO2 at true CI

    @property
    def violation_rate(self) -> float:
        """Fraction of requests that blew the latency SLO."""
        if self.requests <= 0:
            return 0.0
        return float(self.violated_requests / self.requests)

    def to_dict(self) -> dict:
        return {
            "requests": float(self.requests),
            "violated_requests": float(self.violated_requests),
            "violation_rate": self.violation_rate,
            "quality_mean": float(self.quality_mean),
            "ledger_final": float(self.ledger_final),
            "ledger_min": float(self.ledger_min),
            "ledger_max": float(self.ledger_max),
            "tier_names": list(self.tier_names),
            "tier_requests": [float(x) for x in self.tier_requests],
        }


@dataclasses.dataclass
class SimResult:
    """Aggregate result of one simulated window under one policy."""

    policy: str
    carbon_g: float
    energy_kwh: float
    slots: list[SlotLog]
    wait_slots: np.ndarray          # per-job waiting time (first-run delay + pauses)
    violations: np.ndarray          # per-job bool: finished after deadline
    completion: np.ndarray          # per-job completion slot (-1 = unfinished)
    num_jobs: int
    # Geo-engine extras (None/zero for single-region runs).  Migration
    # carbon is included in carbon_g and attributed to the destination
    # region in region_carbon_g; migration_carbon_g breaks it out.
    regions: tuple[str, ...] | None = None
    region_carbon_g: np.ndarray | None = None
    region_energy_kwh: np.ndarray | None = None
    final_region: np.ndarray | None = None   # per-job region at completion
    migrations: int = 0
    migration_carbon_g: float = 0.0
    # Recovery metrics (core/faults.py); None on fault-free, fresh-feed
    # runs so pre-resilience payloads (and golden fixtures) are unchanged.
    resilience: ResilienceMetrics | None = None
    # Serving metrics (serving/engine.py); None on batch runs so batch
    # payloads (and golden fixtures) are unchanged.  On serving runs the
    # per-job arrays are empty and violation_rate is request-weighted.
    serving: ServingMetrics | None = None

    @property
    def mean_wait(self) -> float:
        return float(np.mean(self.wait_slots)) if len(self.wait_slots) else 0.0

    @property
    def violation_rate(self) -> float:
        if self.serving is not None:
            return self.serving.violation_rate
        return float(np.mean(self.violations)) if len(self.violations) else 0.0

    def savings_vs(self, baseline: "SimResult") -> float:
        """Carbon savings (%) relative to a baseline run."""
        if baseline.carbon_g <= 0:
            return 0.0
        return 100.0 * (1.0 - self.carbon_g / baseline.carbon_g)

    def to_dict(self, include_per_job: bool = False,
                include_slots: bool = False) -> dict:
        """JSON-serialisable summary (sweep rows), the JAX package's keys in
        its order.

        Aggregates only by default; ``include_per_job`` adds the per-job
        wait/violation/completion arrays, ``include_slots`` the full
        per-slot log."""
        d = {
            "policy": self.policy,
            "carbon_g": float(self.carbon_g),
            "energy_kwh": float(self.energy_kwh),
            "num_jobs": int(self.num_jobs),
            "mean_wait": self.mean_wait,
            "violation_rate": self.violation_rate,
        }
        if self.regions is not None:
            d["regions"] = list(self.regions)
            d["region_carbon_g"] = np.asarray(
                self.region_carbon_g, dtype=float).tolist()
            d["region_energy_kwh"] = np.asarray(
                self.region_energy_kwh, dtype=float).tolist()
            d["migrations"] = int(self.migrations)
            d["migration_carbon_g"] = float(self.migration_carbon_g)
        if self.resilience is not None:
            d["resilience"] = self.resilience.to_dict()
        if self.serving is not None:
            d["serving"] = self.serving.to_dict()
        if include_per_job:
            d["wait_slots"] = np.asarray(self.wait_slots, dtype=float).tolist()
            d["violations"] = np.asarray(self.violations, dtype=bool).tolist()
            d["completion"] = np.asarray(self.completion, dtype=np.int64).tolist()
            if self.regions is not None:
                d["final_region"] = np.asarray(self.final_region,
                                               dtype=np.int64).tolist()
        if include_slots:
            d["slots"] = [dataclasses.asdict(s) for s in self.slots]
        return d
