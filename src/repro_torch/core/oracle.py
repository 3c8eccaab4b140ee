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

The entries are built and sorted on the host in float64 (a stable lexsort:
any change of precision there would reorder near-ties).  The greedy pass
over them has three implementations, selected by ``solve(backend=...)``:

- ``"numpy"``     — the default: a tight host pass in float64 with an early
                    exit once every job is done;
- ``"numpy-ref"`` — the readable reference pass;
- ``"device"``    — the pass on ``device`` (the counterpart of the JAX
                    package's ``backend="jax"``): the sorted entries cast to
                    int32/float32, packed, and walked by a CUDA kernel of
                    ``kernels/oracle_greedy.py`` on a CUDA device, by its
                    plain version on the CPU.  ``work`` adds up in float32,
                    so it may differ from the float64 passes in the last
                    bits, and in rare cases a job's completion with it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import oracle_greedy
from .types import Job, Schedule

_EPS = 1e-9

BACKENDS = ("numpy", "numpy-ref", "device")

#: Device passes since the last ``reset_stats()``: passes run (``solve``
#: attempts with entries), entries handed over, entries walked before every
#: job was done, and passes that stopped early for that reason.
stats = {"device_passes": 0, "entries": 0, "walked": 0, "early_exits": 0}


def reset_stats() -> None:
    for name in stats:
        stats[name] = 0


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


def _windows(jobs: list[Job], horizon: int):
    """Each job's admissible window ``[t0, t1)``, empty where ``t1 <= t0``:
    ``t0 = max(arrival, 0)``, ``t1 = min(horizon, deadline + 1)``."""
    dl = np.array([j.deadline for j in jobs], dtype=np.int64)
    t0 = np.maximum(np.array([j.arrival for j in jobs], dtype=np.int64), 0)
    return t0, np.minimum(horizon, dl + 1), dl


def _pairs(jobs: list[Job], horizon: int):
    """The (job, scale) pairs with a positive marginal and a non-empty
    admissible window, job-major and k ascending: job index, scale,
    marginal throughput, window ``[t0, t1)`` and deadline of each (the
    rows of the score matrix, ``kernels/score.py``)."""
    z = np.zeros(0, dtype=np.int64)
    if not jobs:
        return z, z, np.zeros(0), z, z, z
    marg = _marginal_table(jobs)                     # (n, K+1)
    kmin = np.array([j.k_min for j in jobs], dtype=np.int64)
    kmax = np.array([j.k_max for j in jobs], dtype=np.int64)
    t0, t1, dl = _windows(jobs, horizon)
    ks = np.arange(marg.shape[1], dtype=np.int64)   # scale meshgrid axis
    pair_ok = (ks[None, :] >= kmin[:, None]) & (ks[None, :] <= kmax[:, None]) \
        & (marg > 0) & (t1 > t0)[:, None]
    pj, pk = np.nonzero(pair_ok)
    return pj, pk, marg[pj, pk], t0[pj], t1[pj], dl[pj]


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
    z = np.zeros(0, dtype=np.int64)
    pj, pk, pgain, pt0, pt1, pdl = _pairs(jobs, horizon)
    if not len(pj):
        return z, z, z, np.zeros(0), np.zeros(0)
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


def _greedy_numpy_ref(jobs, ci, capacity, horizon, lengths):
    """Readable reference pass."""
    j_idx, t_idx, k_val, gain, _ = _build_entries(jobs, ci, horizon)
    n = len(jobs)
    alloc = np.zeros((n, horizon), dtype=np.int64)
    used = np.zeros(horizon, dtype=np.int64)
    work = np.zeros(n)
    kmin = np.array([j.k_min for j in jobs], dtype=np.int64)
    for i in range(len(j_idx)):
        j, t, k, g = j_idx[i], t_idx[i], k_val[i], gain[i]
        if work[j] >= lengths[j] - _EPS:
            continue  # line 11: job already done
        prev = alloc[j, t]
        add = kmin[j] if k == kmin[j] else 1  # base entry adds k_min servers
        if (k == kmin[j] and prev != 0) or (k != kmin[j] and prev != k - 1):
            continue  # incremental consistency
        if used[t] + add > capacity:
            continue  # line 9: capacity exceeded
        alloc[j, t] = k
        used[t] += add
        work[j] += g if k != kmin[j] else 1.0  # base throughput p(k_min)=1
    return alloc, used, work


def _greedy_device(jobs, ci, capacity, horizon, lengths, device):
    """The pass on ``device`` over the host-sorted entries, cast to int32
    and float32 as the JAX package's ``backend="jax"`` casts them, packed
    with the jobs' windows and uploaded in one copy
    (``oracle_greedy.upload``); the windows let the walk lay ``alloc`` out
    by window."""
    j_idx, t_idx, k_val, gain, _ = _build_entries(jobs, ci, horizon)
    n = len(jobs)
    if len(j_idx) == 0:
        return (np.zeros((n, horizon), np.int64), np.zeros(horizon, np.int64),
                np.zeros(n))
    t0, t1, _ = _windows(jobs, horizon)
    windows = np.stack([t0, t1], axis=1)
    entries, kmin, lens, win = oracle_greedy.upload(
        j_idx, t_idx, k_val, gain, [j.k_min for j in jobs], lengths, device,
        windows=windows)
    alloc, used, work, walked = oracle_greedy.greedy_pass(
        entries, kmin, lens, int(capacity), int(horizon), int(k_val.max()),
        windows=win, cells=oracle_greedy.ragged_layout(windows, horizon)[3])
    walked = int(walked.item())
    if walked < 0:
        raise RuntimeError(f"greedy pass: entry {-1 - walked} holds an index "
                           f"outside {n} jobs x {horizon} slots, a slot outside "
                           "its job's window or a scale the route cannot hold")
    stats["device_passes"] += 1
    stats["entries"] += len(j_idx)
    stats["walked"] += walked
    stats["early_exits"] += walked < len(j_idx)
    return (alloc.cpu().numpy().astype(np.int64),
            used.cpu().numpy().astype(np.int64),
            work.cpu().numpy().astype(np.float64))


def _greedy(jobs, ci, capacity, horizon, lengths, backend, device):
    if backend == "numpy":
        return _greedy_numpy(jobs, ci, capacity, horizon, lengths)
    if backend == "numpy-ref":
        return _greedy_numpy_ref(jobs, ci, capacity, horizon, lengths)
    return _greedy_device(jobs, ci, capacity, horizon, lengths, device)


def solve(
    jobs: list[Job],
    ci: np.ndarray,
    capacity: int,
    horizon: int | None = None,
    backend: str = "numpy",
    max_extensions: int = 8,
    extension_slots: int = 24,
    device: str | torch.device = "cuda",
) -> OracleResult:
    """Run Algorithm 1; on infeasibility, extend deadlines of unfinished jobs
    and retry (the paper's fix, §4.2 'Retaining Oracle decisions').

    ``backend`` picks the greedy pass (see the module docstring);
    ``device`` matters only for ``backend="device"``, where it defaults to
    the card and raises without one.

    Retries stop early when no unfinished job's admissible window
    ``[arrival, min(horizon, deadline+1))`` can still grow — once every
    unfinished deadline has hit the horizon, further extensions cannot
    admit a single new (job, slot) entry or make any job newly feasible."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown oracle backend {backend!r}; use one of "
                         f"{', '.join(BACKENDS)}")
    if backend == "device":
        device = resolve_device(device)
    horizon = int(horizon or len(ci))
    jobs = [dataclasses.replace(j) for j in jobs]
    lengths = np.array([j.length for j in jobs])
    extended = np.zeros(len(jobs), dtype=np.int64)
    for attempt in range(max_extensions + 1):
        alloc, used, work = _greedy(jobs, ci, capacity, horizon, lengths,
                                    backend, device)
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
