"""Elastic scaling profiles (paper §2.3 / §3).

Two sources of profiles:

1. Parametric families (Amdahl-style) mirroring the paper's Table 3
   High/Moderate/Low scalability classes: the marginal-throughput profiles
   ``p_j(k)`` behind every job of the synthetic traces.

2. Roofline-derived profiles: given a model's per-slice step FLOPs, HBM
   bytes and DP gradient bytes (a dry-run cell, ``launch/dryrun.py``),
   derive the step time at DP degree k

       tau(k) = max(compute / k, memory / k) + collective(k)

   with ring-all-reduce collective time 2*(k-1)/k * grad_bytes / link_bw,
   then the normalised marginal throughput

       T(k) = tau(k_min) / tau(k) * k_min,  p(k) = T(k) - T(k-1),
       p(k_min) = 1 by construction.

Both are host float64 numpy, expression for expression the JAX package's.
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


# --- roofline-derived profiles -------------------------------------------


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """Per-slice step roofline inputs (seconds are derived).

    The rate defaults are the ones the reference assumes for its own
    dry-run cells (a TPU v5e chip: bf16 peak, HBM bandwidth, one ICI
    link), kept so that a reference cell gives the reference's terms.  They
    are not the H100's rates: a cell counted by this package carries its
    device's rates, and ``terms_from_dryrun`` passes them in."""

    flops: float                 # FLOPs per step per slice
    hbm_bytes: float             # bytes accessed per step per slice
    grad_bytes: float            # DP all-reduce payload per step (model grads)
    peak_flops: float = 197e12   # the reference's rate (TPU v5e bf16)
    hbm_bw: float = 819e9        # the reference's rate (TPU v5e HBM), bytes/s
    link_bw: float = 50e9        # the reference's rate (one ICI link), bytes/s

    def step_time(self, k: int) -> float:
        """Roofline step time when the job's work is split over k slices."""
        compute = self.flops / k / self.peak_flops
        memory = self.hbm_bytes / k / self.hbm_bw
        if k == 1:
            coll = 0.0
        else:
            coll = 2.0 * (k - 1) / k * self.grad_bytes / self.link_bw
        return max(compute, memory) + coll


def roofline_profile(terms: RooflineTerms, k_min: int = 1, k_max: int = 16) -> np.ndarray:
    """Marginal-throughput profile from roofline terms.

    Strong scaling of a fixed per-step workload: throughput at k slices is
    T(k) = tau(k_min) / tau(k) * k_min; marginals are the discrete
    derivative, normalised to p(k_min) = 1 per the paper's §3 convention."""
    ks = np.arange(k_min - 1, k_max + 1)
    t = np.zeros(len(ks))
    base = terms.step_time(max(k_min, 1))
    for i, k in enumerate(ks):
        t[i] = 0.0 if k <= 0 else base / terms.step_time(int(k)) * max(k_min, 1)
    marg = np.diff(t)
    base_m = marg[0]
    if base_m <= 0:
        raise ValueError("degenerate roofline profile")
    p = np.maximum(marg / base_m, 0.0)
    return np.minimum.accumulate(p)


def elasticity_of(profile: np.ndarray) -> float:
    return float(np.mean(profile))


#: The keys of a dry-run cell's ``rates`` that name ``RooflineTerms`` fields.
RATE_FIELDS = ("peak_flops", "hbm_bw", "link_bw")


def terms_from_dryrun(arch: str, dryrun_dir: str = "results/dryrun_opt",
                      shape: str = "train_4k", mesh: str = "16x16",
                      tokens_per_step: int = 65_536) -> RooflineTerms:
    """RooflineTerms of an architecture from its dry-run cell file
    ``{dryrun_dir}/{arch}__{shape}__{mesh}.json`` (the reference's layout).

    Unit convention (per device, the job on k fixed-size DP slices of
    ``slice_chips`` devices): the cell was counted with the job spread over
    ``chips/slice_chips`` slices, so the per-device work at k=1 is the
    cell's per-device FLOPs and bytes scaled back up; the DP all-reduce
    payload per device is the slice's shard of the gradients (2 bytes x
    active params / slice_chips), the ring factor applied inside
    ``RooflineTerms.step_time``.  A cell that carries ``rates`` (one counted
    by ``repro_torch.launch.dryrun``) gives its device's rates; a reference
    cell carries none and keeps the reference's defaults."""
    import json
    import os

    slice_chips = 16
    path = os.path.join(dryrun_dir, f"{arch}__{shape}__{mesh}.json")
    with open(path) as f:
        d = json.load(f)
    slices_measured = max(d["chips"] // slice_chips, 1)
    # The cell was counted at train_4k's 1M-token global batch; a cluster
    # job's per-step batch (tokens_per_step) scales the compute/memory
    # terms while the gradient-sync payload stays fixed: the monotone-
    # decreasing marginal throughput, and why bigger models (more compute
    # per sync byte) are more elastic (the paper's §2.3).
    cell_tokens = 256 * 4096 if shape == "train_4k" else 32 * 32_768
    scale = tokens_per_step / cell_tokens
    rates = {k: float(v) for k, v in (d.get("rates") or {}).items() if k in RATE_FIELDS}
    return RooflineTerms(
        flops=float(d["hlo_stats"]["flops"]) * slices_measured * scale,
        hbm_bytes=float(d["hlo_stats"]["hbm_bytes"]) * slices_measured * scale,
        grad_bytes=2.0 * float(d["params_active"]) / slice_chips,
        **rates,
    )


def profile_from_dryrun(arch: str, k_min: int = 1, k_max: int = 16,
                        **kw) -> np.ndarray:
    return roofline_profile(terms_from_dryrun(arch, **kw), k_min, k_max)
