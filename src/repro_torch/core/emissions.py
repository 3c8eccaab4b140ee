"""Operational energy & carbon accounting (paper §5, Eq. 1–3).

    C_t     = sum_j E_js * CI_t                                   (1)
    E_js    = E^R_js + E^net_js                                   (2)
    E^net_js = eta_net * Mem_js                                   (3)

``E^R`` is compute energy: servers x per-server power x slot length.  The
CPU-cluster mode uses a fixed per-server power (the paper's carbon-
accounting convention); the GPU mode uses per-job heterogeneous power
(the paper measures nvidia-smi; the traces carry a per-workload power).
``Mem_js`` is the data moved by the job at scale s during the slot; for
ring-all-reduce DP training that is
``2 (k-1)/k * model_bytes * steps_per_slot`` — we fold this into the job's
``comm_size`` (GB per server-slot at base scale) scaled by the ring factor.
"""
from __future__ import annotations

from .types import ClusterConfig, Job


def slot_energy_kwh(job: Job, k: int, cluster: ClusterConfig, frac: float = 1.0) -> float:
    """Energy of running ``job`` at scale ``k`` for ``frac`` of one slot."""
    if k <= 0 or frac <= 0:
        return 0.0
    power = job.power if job.power > 0 else cluster.power_per_server
    e_compute = k * power * cluster.slot_hours * frac
    # Ring all-reduce traffic grows as 2(k-1)/k of the payload per step;
    # comm_size is GB transferred per server-slot at base scale.
    ring = 0.0 if k <= 1 else 2.0 * (k - 1) / k
    gbits = job.comm_size * 8.0 * ring * k * frac
    # eta_net is W/Gbps; energy = eta * (Gbit / 3600s) ... expressed per slot:
    e_net_kwh = cluster.eta_net * gbits / 3600.0 / 1000.0 * cluster.slot_hours
    return e_compute + e_net_kwh


def slot_carbon_g(energy_kwh: float, ci_g_per_kwh: float) -> float:
    return energy_kwh * ci_g_per_kwh
