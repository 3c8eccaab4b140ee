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
``core/dag.py``).  Single-region only: no geo cluster and no migration
model.
"""
from __future__ import annotations

import dataclasses

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

    @property
    def mean_wait(self) -> float:
        return float(np.mean(self.wait_slots)) if len(self.wait_slots) else 0.0

    @property
    def violation_rate(self) -> float:
        return float(np.mean(self.violations)) if len(self.violations) else 0.0

    def savings_vs(self, baseline: "SimResult") -> float:
        """Carbon savings (%) relative to a baseline run."""
        if baseline.carbon_g <= 0:
            return 0.0
        return 100.0 * (1.0 - self.carbon_g / baseline.carbon_g)

    def to_dict(self, include_per_job: bool = False,
                include_slots: bool = False) -> dict:
        """JSON-serialisable summary (sweep rows), the JAX package's keys in
        its order for a single-region batch run.

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
        if include_per_job:
            d["wait_slots"] = np.asarray(self.wait_slots, dtype=float).tolist()
            d["violations"] = np.asarray(self.violations, dtype=bool).tolist()
            d["completion"] = np.asarray(self.completion, dtype=np.int64).tolist()
        if include_slots:
            d["slots"] = [dataclasses.asdict(s) for s in self.slots]
        return d
