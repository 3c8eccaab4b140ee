"""Precedence-aware workloads: DAG jobs, criticality, and DAG policies.

Real cluster traces are dominated by multi-stage pipelines whose
precedence constraints change what carbon-aware suspension can save:
Bostandoost et al. ("Quantifying the Carbon Reduction of DAG Workloads")
show DAG structure caps the savings per-job schedulers report, and PCAPS
(Lechowicz et al., "Carbon- and Precedence-Aware Scheduling for Data
Processing Clusters") shows criticality-weighted scheduling recovers most
of it.  This module is the DAG subsystem on top of the existing engine (the
JAX package's ``core/dag.py``, ported line for line):

- :class:`TaskNode` / :class:`DagSpec` — a job as a DAG of tasks, each
  task keeping the existing elasticity-profile machinery (``profile``,
  ``k_min``, ``power``, ``comm_size``);
- :func:`chain_tasks` / :func:`map_reduce_tasks` / :func:`layered_tasks`
  — builders for the published pipeline shapes (linear chains, fan-out/
  fan-in map-reduce stages, random layered DAGs);
- :func:`expand_dags` — flatten DAG specs into the engine's ``Job`` list,
  precedence carried as ``Job.deps`` (predecessor job_ids) that both
  engine paths gate on (``core/simulator.py``);
- :func:`criticality_from_jobs` — longest-path-to-sink analysis over an
  expanded job list (the PCAPS criticality weights);
- the three DAG policies registered as ``dag-fcfs`` / ``dag-carbon`` /
  ``dag-cap`` in ``experiment/registry.py``.

Engine semantics (shared bit-for-bit by the vector and scalar paths): a
task with unfinished predecessors is *gated* — not admitted to the active
set, invisible to the policy, burning no waiting budget.  When its last
predecessor completes at slot ``t`` the task is *released* at ``t + 1``;
its slack and deadline then count from the release slot, so a deep task
is not pre-expired by time its ancestors spent running.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .baselines import CarbonAgnosticPolicy, WaitAwhilePolicy, _fcfs_base_alloc
from .types import Job, QueueConfig

_EPS = 1e-9


# --- the DAG model -----------------------------------------------------------


@dataclasses.dataclass
class TaskNode:
    """One task of a DAG job.

    ``deps`` are indices into the owning :class:`DagSpec`'s task tuple and
    must point strictly backwards (topological authoring order), which
    makes cycles unrepresentable by construction."""

    length: float                       # slots of work at k_min
    deps: tuple[int, ...] = ()          # predecessor indices within the DAG
    profile: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(1))
    k_min: int = 1
    power: float = 1.0
    comm_size: float = 0.0
    name: str = "task"


@dataclasses.dataclass
class DagSpec:
    """A job that is a DAG of tasks (arriving as a unit at ``arrival``)."""

    dag_id: int
    arrival: int
    tasks: tuple[TaskNode, ...]
    name: str = "dag"

    def __post_init__(self) -> None:
        self.tasks = tuple(self.tasks)
        if not self.tasks:
            raise ValueError(f"dag {self.dag_id}: needs >= 1 task")
        for i, task in enumerate(self.tasks):
            for d in task.deps:
                if not 0 <= d < i:
                    raise ValueError(
                        f"dag {self.dag_id}: task {i} depends on {d}; deps "
                        f"must point to earlier tasks (topological order)")

    @property
    def n_tasks(self) -> int:
        return len(self.tasks)

    def total_work(self) -> float:
        return float(sum(t.length for t in self.tasks))

    def edges(self) -> list[tuple[int, int]]:
        return [(d, i) for i, t in enumerate(self.tasks) for d in t.deps]

    def depth(self) -> int:
        """Number of tasks on the longest chain (1 for independent tasks)."""
        lvl = [0] * self.n_tasks
        for i, t in enumerate(self.tasks):
            lvl[i] = 1 + max((lvl[d] for d in t.deps), default=0)
        return max(lvl)

    def critical_path_length(self) -> float:
        """Work (in k_min-slots) along the longest path to any sink."""
        head = [0.0] * self.n_tasks
        for i, t in enumerate(self.tasks):
            head[i] = t.length + max((head[d] for d in t.deps), default=0.0)
        return float(max(head))


# --- shape builders ----------------------------------------------------------


def chain_tasks(lengths: Sequence[float], **task_kw) -> tuple[TaskNode, ...]:
    """A linear pipeline: task i depends on task i-1."""
    return tuple(TaskNode(length=float(ln), deps=(i - 1,) if i else (),
                          name=f"stage{i}", **task_kw)
                 for i, ln in enumerate(lengths))


def map_reduce_tasks(source_length: float, map_lengths: Sequence[float],
                     reduce_length: float, **task_kw) -> tuple[TaskNode, ...]:
    """Fan-out/fan-in: source -> W parallel mappers -> reducer."""
    if not len(map_lengths):
        raise ValueError("map_reduce_tasks needs >= 1 mapper")
    tasks = [TaskNode(length=float(source_length), name="source", **task_kw)]
    for i, ln in enumerate(map_lengths):
        tasks.append(TaskNode(length=float(ln), deps=(0,),
                              name=f"map{i}", **task_kw))
    w = len(map_lengths)
    tasks.append(TaskNode(length=float(reduce_length),
                          deps=tuple(range(1, w + 1)), name="reduce",
                          **task_kw))
    return tuple(tasks)


def layered_tasks(layer_sizes: Sequence[int], lengths: Sequence[float],
                  rng: np.random.Generator, max_parents: int = 3,
                  **task_kw) -> tuple[TaskNode, ...]:
    """A random layered DAG: every task in layer ``i`` draws 1..max_parents
    predecessors uniformly from layer ``i - 1`` (layer 0 tasks are roots).
    ``lengths`` supplies one work length per task, layer by layer."""
    if sum(layer_sizes) != len(lengths):
        raise ValueError(f"layered_tasks: {sum(layer_sizes)} tasks in "
                         f"layer_sizes but {len(lengths)} lengths")
    if any(s < 1 for s in layer_sizes):
        raise ValueError(f"layer sizes must be >= 1: {tuple(layer_sizes)}")
    tasks: list[TaskNode] = []
    prev: list[int] = []
    li = 0
    for depth, size in enumerate(layer_sizes):
        cur = []
        for _ in range(size):
            deps: tuple[int, ...] = ()
            if prev:
                n_par = int(rng.integers(1, min(max_parents, len(prev)) + 1))
                deps = tuple(sorted(int(p) for p in rng.choice(
                    prev, size=n_par, replace=False)))
            cur.append(len(tasks))
            tasks.append(TaskNode(length=float(lengths[li]), deps=deps,
                                  name=f"l{depth}t{len(cur) - 1}", **task_kw))
            li += 1
        prev = cur
    return tuple(tasks)


# --- expansion to engine jobs ------------------------------------------------


def expand_dags(dags: Sequence[DagSpec], queues: tuple[QueueConfig, ...],
                id_base: int = 0, independent: bool = False) -> list[Job]:
    """Flatten DAG specs into the engine's ``Job`` list.

    Every task becomes one ``Job`` arriving at its DAG's arrival slot
    (the engines gate non-root tasks until their predecessors finish, so
    a DAG never straddles an arrival-based trace split); task -> queue
    assignment follows the existing per-length rule.  ``independent=True``
    strips the precedence edges — the independent-task *upper bound* the
    DAG studies compare against."""
    jobs: list[Job] = []
    jid = id_base
    for dag in dags:
        base = jid
        for task in dag.tasks:
            qidx = next(i for i, q in enumerate(queues)
                        if task.length <= q.max_length)
            deps = () if independent else tuple(base + d for d in task.deps)
            jobs.append(Job(
                job_id=jid, arrival=dag.arrival, length=task.length,
                queue=qidx, delay=queues[qidx].delay, profile=task.profile,
                k_min=task.k_min, power=task.power, comm_size=task.comm_size,
                arch=f"{dag.name}/{task.name}", deps=deps))
            jid += 1
    return jobs


# --- criticality (the PCAPS weights) ----------------------------------------


def criticality_from_jobs(jobs: Sequence[Job]) -> dict[int, bool]:
    """Longest-path analysis over an expanded job list.

    Returns ``{job_id: on_critical_path}``: a task is critical when some
    longest path of its (weakly connected) DAG component runs through it —
    ``head(v) + tail(v) - length(v)`` reaches the component's critical-path
    length.  Tasks with no edges form their own component and are always
    critical (they ARE their longest path).  Dependencies pointing outside
    ``jobs`` are ignored (the engine validates closure separately)."""
    by_id = {j.job_id: j for j in jobs}
    preds = {j.job_id: [d for d in j.deps if d in by_id] for j in jobs}
    succs: dict[int, list[int]] = {j.job_id: [] for j in jobs}
    for jid, ps in preds.items():
        for p in ps:
            succs[p].append(jid)

    # Kahn topological order (job lists from expand_dags are already
    # topological by construction; hand-built lists might not be).
    indeg = {jid: len(ps) for jid, ps in preds.items()}
    order = [jid for jid, d in indeg.items() if d == 0]
    i = 0
    while i < len(order):
        for s in succs[order[i]]:
            indeg[s] -= 1
            if indeg[s] == 0:
                order.append(s)
        i += 1
    if len(order) != len(jobs):
        raise ValueError("dependency cycle in job list")

    head: dict[int, float] = {}
    tail: dict[int, float] = {}
    for jid in order:
        head[jid] = by_id[jid].length + max(
            (head[p] for p in preds[jid]), default=0.0)
    for jid in reversed(order):
        tail[jid] = by_id[jid].length + max(
            (tail[s] for s in succs[jid]), default=0.0)

    # Weakly-connected components via union-find over the edges.
    root = {jid: jid for jid in by_id}

    def find(x: int) -> int:
        while root[x] != x:
            root[x] = root[root[x]]
            x = root[x]
        return x

    for jid, ps in preds.items():
        for p in ps:
            root[find(p)] = find(jid)
    cp: dict[int, float] = {}
    for jid in by_id:
        r = find(jid)
        cp[r] = max(cp.get(r, 0.0), head[jid])
    return {jid: head[jid] + tail[jid] - by_id[jid].length
            >= cp[find(jid)] - _EPS for jid in by_id}


# --- DAG policies ------------------------------------------------------------


@dataclasses.dataclass
class DagFcfsPolicy(CarbonAgnosticPolicy):
    """Precedence-only baseline: FCFS at base scale over *ready* tasks.

    Identical to ``carbon-agnostic`` (including the packed vector fast
    path) — all precedence handling lives in the engine's gating, so this
    measures what the pipeline costs with no carbon awareness at all."""

    name: str = "dag-fcfs"


@dataclasses.dataclass
class DagCarbonPolicy(WaitAwhilePolicy):
    """CarbonFlex-style CI-rank suspend/resume applied per ready task.

    Every released task independently waits for the cleanest
    ``percentile`` % of the next-24h forecast (forced tasks run
    regardless, the run-to-completion SLO shared by all policies).  This
    IS ``wait-awhile`` — inherited, so the two stay equivalent — at a
    wider percentile, applied per ready task: the per-job carbon
    scheduler of the Bostandoost et al. study.  On independent tasks it
    is the savings upper bound; on real DAGs the precedence structure
    serialises the waits of successive stages."""

    percentile: float = 40.0
    name: str = "dag-carbon"


@dataclasses.dataclass
class DagCapPolicy:
    """PCAPS-style criticality-aware carbon scheduling.

    Longest-path-to-sink weights are computed once per DAG at window
    start: tasks on the critical path are exempt from suspension (every
    slot they spend waiting extends the whole pipeline), while slack
    tasks are deferred into the cleanest ``percentile`` % CI windows —
    recovering most of ``dag-carbon``'s savings at a fraction of its
    completion-time cost."""

    percentile: float = 40.0
    name: str = "dag-cap"

    def on_window_start(self, ci, t0, horizon, jobs, cluster) -> None:
        self._critical = criticality_from_jobs(jobs)

    def decide(self, t, active, ci, cluster):
        thresh = ci.percentile_threshold(t, self.percentile)
        low_carbon = ci.ci(t) <= thresh + 1e-12
        crit = self._critical
        alloc = _fcfs_base_alloc(
            active, cluster.capacity,
            eligible=lambda a: low_carbon or crit.get(a.job.job_id, True))
        return cluster.capacity, alloc

    def on_completion(self, t, job, violated) -> None:
        pass
