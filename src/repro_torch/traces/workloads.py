"""Synthetic workload-trace generators (offline stand-ins).

The paper evaluates on the Azure 2017 VM trace, the Alibaba-PAI 2022 GPU
trace, and the SURF Lisa HPC trace.  Those datasets are not bundled, so we
generate seeded synthetic traces calibrated to the published
characteristics the paper relies on:

- *hour+ jobs only* (the paper filters shorter jobs);
- log-normal job lengths — Azure longer-tailed (high mean length),
  Alibaba-PAI shorter ML jobs, SURF in between with a heavy tail;
- diurnal (and weekday) Poisson arrivals;
- arrival rate calibrated so the expected base-scale demand hits a target
  cluster utilisation (the paper's default: 50%);
- length-based queue assignment (short <= 2 h -> d=6 h, medium <= 12 h ->
  d=24 h, long -> d=48 h);
- elasticity profiles drawn from the Table-3 workload mix (or forced to a
  single class for the Fig. 10 study).

Every draw comes from one numpy ``Generator`` seeded with ``spec.seed``,
so a seed builds the same trace as the JAX package's generator; the DAG
generator (``DagConfig``, ``generate_dag_trace``) draws op for op as its
counterpart there.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.dag import (DagSpec, chain_tasks, expand_dags, layered_tasks,
                                  map_reduce_tasks)
from repro_torch.core.profiles import TABLE3_WORKLOADS, WorkloadSpec, class_profile
from repro_torch.core.types import ClusterConfig, Job, QueueConfig

# (log-normal mu of hours, sigma, diurnal amplitude)
TRACE_FAMILIES: dict[str, tuple[float, float, float]] = {
    "azure": (1.6, 0.9, 0.35),      # longer jobs (mean ~7 h)
    "alibaba": (0.8, 0.8, 0.45),    # shorter ML training jobs (mean ~3 h)
    "surf": (1.2, 1.1, 0.25),       # HPC mix, heavy tail
}


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    family: str = "azure"
    hours: int = 24 * 7
    utilization: float = 0.5         # target base-scale utilisation of M
    capacity: int = 150
    k_min: int = 1
    k_max: int = 16
    elasticity: str = "mix"          # "mix" | "high" | "moderate" | "low" | "none"
    mode: str = "cpu"                # "cpu" fixed power | "gpu" heterogeneous
    seed: int = 0
    length_scale: float = 1.0        # Fig. 13 distribution-shift knobs
    rate_scale: float = 1.0


def mean_length(spec: TraceSpec) -> float:
    mu, sigma, _ = TRACE_FAMILIES[spec.family]
    raw = float(np.exp(mu + sigma**2 / 2)) * spec.length_scale
    return max(1.0, raw)


def _pick_profile(rng: np.random.Generator, spec: TraceSpec) -> tuple[np.ndarray, float, float, str]:
    if spec.elasticity == "none":
        return np.ones(1), 0.0, 1.0, "rigid"
    if spec.elasticity == "tpu":
        raise NotImplementedError(
            "elasticity='tpu' derives profiles from compiled model dry-runs, "
            "which this package does not carry yet")
    if spec.elasticity == "mix":
        w: WorkloadSpec = TABLE3_WORKLOADS[rng.integers(len(TABLE3_WORKLOADS))]
        prof = w.profile(spec.k_min, spec.k_max)
        power = w.power_kw if spec.mode == "gpu" else 1.0
        return prof, w.comm_size_mb / 1024.0, power, w.name
    prof = class_profile(spec.elasticity, spec.k_min, spec.k_max)
    power = {"high": 1.0, "moderate": 0.85, "low": 0.7}[spec.elasticity] \
        if spec.mode == "gpu" else 1.0
    return prof, 0.05, power, spec.elasticity


@dataclasses.dataclass(frozen=True)
class DagConfig:
    """Shape knobs of the seeded DAG trace generator (all JSON scalars, so
    ``Scenario.to_dict`` round-trips it).

    Calibrated to published pipeline shapes: linear ``chain`` s (ETL /
    retraining pipelines), ``mapreduce`` fan-out/fan-in stages, and random
    ``layered`` DAGs with configurable width/depth (the Alibaba batch-DAG
    shape family).  ``independent=True`` generates the *same* tasks with
    the precedence edges stripped — the independent-task upper bound the
    DAG-vs-per-job savings comparison needs."""

    shapes: tuple[str, ...] = ("chain", "mapreduce", "layered")
    width: int = 4                  # max fan-out / layer width
    depth: int = 3                  # max stages / layers (chains: tasks)
    task_mu: float = 0.5            # log-normal mu of task hours
    task_sigma: float = 0.6
    max_parents: int = 3            # layered: parents drawn per task
    independent: bool = False       # strip edges (upper-bound twin)

    def __post_init__(self) -> None:
        object.__setattr__(self, "shapes", tuple(self.shapes))
        unknown = set(self.shapes) - {"chain", "mapreduce", "layered"}
        if not self.shapes or unknown:
            raise ValueError(f"DagConfig.shapes must be a non-empty subset "
                             f"of chain/mapreduce/layered, got {self.shapes}")
        if self.width < 2 or self.depth < 2:
            raise ValueError("DagConfig needs width >= 2 and depth >= 2")


def dag_mean_task_length(dag: DagConfig, length_scale: float = 1.0) -> float:
    """Expected task length in slots (the mean-historical-length input the
    baselines are granted, per-task for DAG scenarios).  ``length_scale``
    is the Fig.-13 distribution-shift knob — included here so arrival-rate
    calibration stays linear in it, exactly like ``mean_length``."""
    return max(1.0, float(np.exp(dag.task_mu + dag.task_sigma ** 2 / 2))
               * length_scale)


def _expected_tasks(dag: DagConfig) -> float:
    """Expected tasks per DAG under the shape mix (arrival-rate calibration
    only — the same role the log-normal mean plays in ``generate_trace``)."""
    per = {"chain": (2 + dag.depth) / 2,                  # depth ~ U[2, D]
           "mapreduce": (2 + dag.width) / 2 + 2,          # fan-out ~ U[2, W]
           "layered": ((2 + dag.depth) / 2) * (1 + dag.width) / 2}
    return float(np.mean([per[s] for s in dag.shapes]))


def generate_dag_specs(spec: TraceSpec, dag: DagConfig) -> list[DagSpec]:
    """Seeded DAG-job trace: Poisson diurnal arrivals of whole DAGs, shape
    drawn uniformly from ``dag.shapes``, task lengths log-normal
    (``task_mu``/``task_sigma``, clipped to [1, 48] slots), per-task
    elasticity profiles from the same Table-3 machinery as the flat
    generator.  The arrival rate is calibrated so the expected base-scale
    *task* demand hits ``spec.utilization * spec.capacity``."""
    rng = np.random.default_rng(spec.seed)
    _, _, diurnal = TRACE_FAMILIES[spec.family]
    mean_task = dag_mean_task_length(dag, spec.length_scale)
    base_rate = (spec.utilization * spec.capacity
                 / (_expected_tasks(dag) * mean_task * spec.k_min))
    base_rate *= spec.rate_scale

    def _len(n: int) -> list[float]:
        raw = np.exp(rng.normal(dag.task_mu, dag.task_sigma, n))
        raw = raw * spec.length_scale
        return [float(v) for v in np.clip(raw, 1.0, 48.0)]

    dags: list[DagSpec] = []
    for t in range(spec.hours):
        hod = t % 24
        dow = (t // 24) % 7
        rate = base_rate * (1.0 + diurnal * np.sin(2 * np.pi * (hod - 10) / 24.0))
        if dow >= 5:
            rate *= 0.8
        for _ in range(rng.poisson(max(rate, 0.0))):
            shape = dag.shapes[rng.integers(len(dag.shapes))]
            if shape == "chain":
                d = int(rng.integers(2, dag.depth + 1))
                tasks = chain_tasks(_len(d))
            elif shape == "mapreduce":
                w = int(rng.integers(2, dag.width + 1))
                lens = _len(w + 2)
                tasks = map_reduce_tasks(lens[0], lens[1:w + 1], lens[w + 1])
            else:
                d = int(rng.integers(2, dag.depth + 1))
                sizes = [int(rng.integers(1, dag.width + 1)) for _ in range(d)]
                tasks = layered_tasks(sizes, _len(sum(sizes)), rng,
                                      max_parents=dag.max_parents)
            for task in tasks:          # Table-3 elasticity per task
                prof, comm, power, _ = _pick_profile(rng, spec)
                task.profile = prof
                task.comm_size = comm
                task.power = power
                task.k_min = spec.k_min
            dags.append(DagSpec(dag_id=len(dags), arrival=t, tasks=tasks,
                                name=f"{shape}{len(dags)}"))
    return dags


def generate_dag_trace(spec: TraceSpec, dag: DagConfig,
                       queues: tuple[QueueConfig, ...] | None = None) -> list[Job]:
    """Seeded DAG workload expanded to the engine's ``Job`` list (every
    task one job arriving at its DAG's slot, precedence in ``Job.deps``;
    ``dag.independent`` strips the edges for the upper-bound twin)."""
    if queues is None:
        queues = ClusterConfig.default(spec.capacity).queues
    return expand_dags(generate_dag_specs(spec, dag), queues,
                       independent=dag.independent)


def generate_trace(spec: TraceSpec, queues: tuple[QueueConfig, ...] | None = None) -> list[Job]:
    """Seeded synthetic job trace over ``spec.hours`` slots."""
    if queues is None:
        queues = ClusterConfig.default(spec.capacity).queues
    rng = np.random.default_rng(spec.seed)
    mu, sigma, diurnal = TRACE_FAMILIES[spec.family]
    mean_len = mean_length(spec)
    # expected demand per slot = rate * mean_len * k_min = util * M
    base_rate = spec.utilization * spec.capacity / (mean_len * spec.k_min)
    base_rate *= spec.rate_scale

    jobs: list[Job] = []
    jid = 0
    for t in range(spec.hours):
        hod = t % 24
        dow = (t // 24) % 7
        rate = base_rate * (1.0 + diurnal * np.sin(2 * np.pi * (hod - 10) / 24.0))
        if dow >= 5:
            rate *= 0.8
        n = rng.poisson(max(rate, 0.0))
        for _ in range(n):
            length = float(np.exp(rng.normal(mu, sigma))) * spec.length_scale
            length = float(np.clip(length, 1.0, 24 * 4))    # hour+ jobs
            qidx = next(i for i, q in enumerate(queues) if length <= q.max_length)
            prof, comm, power, name = _pick_profile(rng, spec)
            jobs.append(Job(
                job_id=jid,
                arrival=t,
                length=length,
                queue=qidx,
                delay=queues[qidx].delay,
                profile=prof,
                k_min=spec.k_min,
                power=power,
                comm_size=comm,
                arch=name,
            ))
            jid += 1
    return jobs
