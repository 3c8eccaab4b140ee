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
so a seed builds the same trace as the JAX package's generator.
"""
from __future__ import annotations

import dataclasses

import numpy as np

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
