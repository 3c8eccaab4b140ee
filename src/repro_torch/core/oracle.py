"""CarbonFlex offline oracle — Algorithm 1 of the paper.

Greedy carbon-optimal scheduling: enumerate ``(job, slot, scale)`` triples,
score each by marginal throughput per unit carbon ``p_j(k) / CI_t``, sort
descending (ties broken by earliest deadline), and allocate greedily subject
to the cluster capacity ``M``.  Optimal for monotonically decreasing
marginal-throughput profiles on homogeneous clusters (Theorem 4.1, via
Federgruen & Groenevelt's greedy resource-allocation result).

We interpret each list entry *incrementally*: the entry ``(j, t, k)`` raises
job j's allocation in slot t from ``k-1`` to ``k`` (the base entry
``k = k_min`` raises 0 -> k_min).  Because profiles are monotone decreasing,
the sorted order guarantees the ``k-1`` entry is considered before ``k`` for
the same slot, so the greedy pass visits allocations in a consistent order.

The greedy pass is sequential and stays on the host in float64 numpy: the
entry order comes from a stable lexsort on float64 scores, and any change
of precision or summation order would reorder near-ties.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .types import Job, Schedule

_EPS = 1e-9


@dataclasses.dataclass
class OracleResult:
    schedule: Schedule
    capacity_curve: np.ndarray       # m_t (decision output, Table 2)
    rho_curve: np.ndarray            # rho_t: lowest scheduled marginal throughput
    work_done: np.ndarray            # per-job completed work


def _marginal_table(jobs: list[Job]) -> np.ndarray:
    """(n, K+1) lookup: row j, column k = p_j(k) (0 outside [k_min, k_max])."""
    kmax_g = max((j.k_max for j in jobs), default=0)
    tab = np.zeros((len(jobs), kmax_g + 1))
    for i, job in enumerate(jobs):
        tab[i, job.k_min:job.k_max + 1] = job.profile
    return tab


def _build_entries(jobs: list[Job], ci: np.ndarray, horizon: int):
    """Flattened (job, slot, scale) entry arrays, sorted by the greedy key.

    Returns int64/float64 arrays: j_idx, t_idx, k_val, gain (marginal
    throughput), score, in greedy order (score desc, deadline asc, stable).

    The (job, scale) pair grid comes from the padded marginal table
    (masked to each job's [k_min, k_max] positive-marginal range), then
    each pair is expanded over its admissible slot window with a
    ragged-arange.  Pair order (job-major, k ascending) plus the stable
    lexsort fix the entry order.
    """
    n = len(jobs)
    z = np.zeros(0, dtype=np.int64)
    if n == 0:
        return z, z, z, np.zeros(0), np.zeros(0)
    marg = _marginal_table(jobs)                     # (n, K+1)
    kmin = np.array([j.k_min for j in jobs], dtype=np.int64)
    kmax = np.array([j.k_max for j in jobs], dtype=np.int64)
    dl = np.array([j.deadline for j in jobs], dtype=np.int64)
    t0 = np.maximum(np.array([j.arrival for j in jobs], dtype=np.int64), 0)
    t1 = np.minimum(horizon, dl + 1)
    ks = np.arange(marg.shape[1], dtype=np.int64)   # scale meshgrid axis
    pair_ok = (ks[None, :] >= kmin[:, None]) & (ks[None, :] <= kmax[:, None]) \
        & (marg > 0) & (t1 > t0)[:, None]
    pj, pk = np.nonzero(pair_ok)                    # job-major, k ascending
    if not len(pj):
        return z, z, z, np.zeros(0), np.zeros(0)
    pgain = marg[pj, pk]
    pt0, pt1, pdl = t0[pj], t1[pj], dl[pj]
    counts = pt1 - pt0                              # slots per (job, k) pair
    total = int(counts.sum())
    starts = np.cumsum(counts) - counts
    # ragged arange: for each pair, the slots [t0, t1)
    t_idx = np.arange(total, dtype=np.int64) - np.repeat(starts - pt0, counts)
    j_idx = np.repeat(pj.astype(np.int64), counts)
    k_val = np.repeat(pk, counts)
    gain = np.repeat(pgain, counts)
    deadline = np.repeat(pdl, counts)
    score = gain / ci[t_idx]
    # Sort: score desc, then deadline asc (earliest-deadline tie-break, line 6).
    order = np.lexsort((deadline, -score))
    return j_idx[order], t_idx[order], k_val[order], gain[order], score[order]


def _greedy_numpy(jobs, ci, capacity, horizon, lengths):
    """Greedy pass: plain-Python element access over the pre-sorted entry
    lists (numpy scalar indexing is ~5x slower per element) and an early
    exit once every job has finished — the sorted tail past that point is
    all skips."""
    j_idx, t_idx, k_val, gain, _ = _build_entries(jobs, ci, horizon)
    n = len(jobs)
    kmin = [j.k_min for j in jobs]
    lens = [float(v) - _EPS for v in lengths]
    work = [0.0] * n
    used = [0] * horizon
    alloc = [[0] * horizon for _ in range(n)]
    unfinished = sum(1 for i in range(n) if work[i] < lens[i])
    jl, tl = j_idx.tolist(), t_idx.tolist()
    kl, gl = k_val.tolist(), gain.tolist()
    for i in range(len(jl)):
        j = jl[i]
        if work[j] >= lens[j]:
            continue                         # line 11: job already done
        t, k = tl[i], kl[i]
        row = alloc[j]
        prev = row[t]
        km = kmin[j]
        if k == km:                          # base entry adds k_min servers
            if prev != 0:
                continue                     # incremental consistency
            add, g = km, 1.0                 # base throughput p(k_min)=1
        else:
            if prev != k - 1:
                continue
            add, g = 1, gl[i]
        if used[t] + add > capacity:
            continue                         # line 9: capacity exceeded
        row[t] = k
        used[t] += add
        w = work[j] + g
        work[j] = w
        if w >= lens[j]:
            unfinished -= 1
            if unfinished == 0:
                break                        # all jobs done: the rest skip
    return (np.array(alloc, dtype=np.int64).reshape(n, horizon),
            np.array(used, dtype=np.int64), np.array(work))


def solve(
    jobs: list[Job],
    ci: np.ndarray,
    capacity: int,
    horizon: int | None = None,
    max_extensions: int = 8,
    extension_slots: int = 24,
) -> OracleResult:
    """Run Algorithm 1; on infeasibility, extend deadlines of unfinished jobs
    and retry (the paper's fix, §4.2 'Retaining Oracle decisions').

    Retries stop early when no unfinished job's admissible window
    ``[arrival, min(horizon, deadline+1))`` can still grow — once every
    unfinished deadline has hit the horizon, further extensions cannot
    admit a single new (job, slot) entry or make any job newly feasible."""
    horizon = int(horizon or len(ci))
    jobs = [dataclasses.replace(j) for j in jobs]
    lengths = np.array([j.length for j in jobs])
    extended = np.zeros(len(jobs), dtype=np.int64)
    for attempt in range(max_extensions + 1):
        alloc, used, work = _greedy_numpy(jobs, ci, capacity, horizon, lengths)
        unfinished = work < lengths - 1e-6
        if not unfinished.any() or attempt == max_extensions:
            break
        if not any(jobs[idx].deadline + 1 < horizon
                   for idx in np.nonzero(unfinished)[0]):
            break
        for idx in np.nonzero(unfinished)[0]:
            jobs[idx] = dataclasses.replace(jobs[idx], delay=jobs[idx].delay + extension_slots)
            extended[idx] += extension_slots
    feasible = bool((work >= lengths - 1e-6).all())
    schedule = Schedule(alloc=alloc, jobs=jobs, feasible=feasible, extended=extended)
    rho = _rho_curve(jobs, alloc)
    return OracleResult(
        schedule=schedule,
        capacity_curve=used.astype(np.int64),
        rho_curve=rho,
        work_done=work,
    )


def _rho_curve(jobs: list[Job], alloc: np.ndarray) -> np.ndarray:
    """rho_t = lowest marginal throughput among scheduled jobs at t (Table 2).
    1.0 (= p(k_min), the most permissive threshold) when nothing runs.

    One gather from the per-job marginal lookup table and a masked
    column-min — no per-slot Python."""
    n, horizon = alloc.shape
    if n == 0:
        return np.ones(horizon)
    marg = _marginal_table(jobs)                     # (n, K+1)
    vals = np.take_along_axis(marg, np.minimum(alloc, marg.shape[1] - 1), axis=1)
    vals = np.where(alloc > 0, vals, np.inf)
    rho = vals.min(axis=0)
    return np.where(np.isfinite(rho), rho, 1.0)
