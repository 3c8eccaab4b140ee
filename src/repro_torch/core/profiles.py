"""Elastic scaling profiles (paper §2.3 / §3).

Parametric families (Amdahl-style) mirroring the paper's Table 3
High/Moderate/Low scalability classes: the marginal-throughput profiles
``p_j(k)`` behind every job of the synthetic traces.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# Mirrors Table 3 scalability classes. Values chosen so that the mean
# marginal throughput (elasticity) is ~0.95 / ~0.75 / ~0.45.
_CLASS_SIGMA = {"high": 0.05, "moderate": 0.35, "low": 0.9}


def amdahl_profile(k_min: int, k_max: int, sigma: float) -> np.ndarray:
    """Marginal-throughput profile from an Amdahl-like throughput curve.

    Throughput at scale k: T(k) = k / (1 + sigma * (k - 1)).  sigma = 0 is
    linear scaling; larger sigma = more communication per unit compute.
    Returns marginals p[i] = T(k_min+i) - T(k_min+i-1), normalised so
    p(k_min) = 1 (paper §3 requires p_j(k_min) = 1).
    """
    ks = np.arange(k_min - 1, k_max + 1, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(ks > 0, ks / (1.0 + sigma * (ks - 1.0)), 0.0)
    marg = np.diff(t)
    base = marg[0]
    if base <= 0:
        raise ValueError("degenerate profile")
    # Negative marginals (sigma > 1: adding servers would *hurt*) clamp to
    # zero — a rational scheduler simply never allocates past the peak.
    p = np.maximum(marg / base, 0.0)
    # Guard strict monotone decrease (Theorem 4.1 condition 1).
    p = np.minimum.accumulate(p)
    return p


def class_profile(scalability: str, k_min: int = 1, k_max: int = 16) -> np.ndarray:
    return amdahl_profile(k_min, k_max, _CLASS_SIGMA[scalability])


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """One entry of the paper's Table 3: a profiled elastic workload."""

    name: str
    impl: str                  # "MPI" | "Pytorch" | "JAX"
    comm_size_mb: float
    scalability: str           # "high" | "moderate" | "low"
    power_kw: float = 1.0      # per-server draw (GPU cluster: heterogeneous)

    def profile(self, k_min: int = 1, k_max: int = 16) -> np.ndarray:
        return class_profile(self.scalability, k_min, k_max)


# The paper's Table 3 workload mix (names + comm sizes + classes).  Power
# numbers for the GPU cluster follow the paper's observation that highly
# scalable (compute-dense) workloads draw more power.
TABLE3_WORKLOADS: tuple[WorkloadSpec, ...] = (
    WorkloadSpec("nbody-100k", "MPI", 5.3, "high", 1.00),
    WorkloadSpec("nbody-50k", "MPI", 0.53, "high", 1.00),
    WorkloadSpec("nbody-2k", "MPI", 0.16, "moderate", 0.85),
    WorkloadSpec("jacobi-10k", "MPI", 0.1, "moderate", 0.85),
    WorkloadSpec("jacobi-1k", "MPI", 51.2, "low", 0.70),
    WorkloadSpec("lammps", "MPI", 28.6, "low", 0.70),
    WorkloadSpec("gromacs", "MPI", 7.16, "low", 0.70),
    WorkloadSpec("vgg16", "Pytorch", 233.1, "low", 0.70),
    WorkloadSpec("resnet18", "Pytorch", 44.7, "low", 0.72),
    WorkloadSpec("resnet50", "Pytorch", 97.8, "moderate", 0.85),
    WorkloadSpec("efficientnetv2-s", "Pytorch", 170.5, "high", 1.00),
    WorkloadSpec("effnet-s", "Pytorch", 82.7, "high", 1.00),
    WorkloadSpec("vit-b32", "Pytorch", 336.6, "moderate", 0.85),
)

