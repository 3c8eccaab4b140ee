"""CarbonFlex runtime scheduling — Algorithm 3 (psi).

Given the provisioned capacity ``m_t`` and the learned marginal-throughput
threshold ``rho``, allocate servers to queued/running jobs:

- enumerate (job, scale) pairs with ``p_j(k) >= rho``;
- sort by marginal throughput desc, remaining slack asc (line 6);
- allocate incrementally until ``m_t`` is filled;
- jobs are not scaled past ``k_min`` until every eligible job holds
  ``k_min`` (starvation freedom) — this falls out of the sort because
  ``p_j(k_min) = 1`` dominates every scaling marginal;
- jobs whose slack is exhausted are *forced*: they are allocated ``k_min``
  first, bypassing ``rho`` (run-to-completion after the permitted delay,
  §6.1), mirroring how every baseline in the paper honours SLOs.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .types import Job

_EPS = 1e-9


@dataclasses.dataclass
class ActiveJob:
    """Runtime view of a job inside the cluster."""

    job: Job
    remaining: float            # work left, in k_min-slots
    slack_left: int             # waiting budget left (slots)
    waited: int = 0             # slots spent queued/paused so far
    started: bool = False

    @property
    def forced(self) -> bool:
        return self.slack_left <= 0

    @property
    def done(self) -> bool:
        return self.remaining <= _EPS


def schedule(
    active: list[ActiveJob],
    m_t: int,
    rho: float,
) -> dict[int, int]:
    """Algorithm 3.  Returns {job_id: k} for jobs to run this slot."""
    alloc: dict[int, int] = {}
    used = 0

    # Forced jobs first (slack exhausted): base allocation, ignore rho.
    forced = sorted((a for a in active if a.forced and not a.done),
                    key=lambda a: a.slack_left)
    for a in forced:
        k = a.job.k_min
        if used + k > m_t:
            break
        alloc[a.job.job_id] = k
        used += k

    # Candidate (job, scale) list (lines 2–5).
    entries: list[tuple[float, int, int, int]] = []   # (p, slack, job_id, k)
    by_id = {a.job.job_id: a for a in active}
    for a in active:
        if a.done:
            continue
        for k in range(a.job.k_min, a.job.k_max + 1):
            p = a.job.marginal(k)
            if p <= 0:
                continue
            if p >= rho - _EPS:
                entries.append((p, a.slack_left, a.job.job_id, k))
    # Sort: marginal throughput desc, then remaining slack asc (line 6).
    entries.sort(key=lambda e: (-e[0], e[1]))

    for p, _, jid, k in entries:                       # lines 7–9
        a = by_id[jid]
        cur = alloc.get(jid, 0)
        is_base = k == a.job.k_min
        add = a.job.k_min if is_base else 1
        if is_base and cur != 0:
            continue
        if not is_base and cur != k - 1:
            continue
        if used + add > m_t:
            continue
        alloc[jid] = k
        used += add
    return alloc


def apply_slot(active: list[ActiveJob], alloc: dict[int, int]) -> None:
    """Advance one slot: progress allocated jobs, charge waiting to others."""
    for a in active:
        if a.done:
            continue
        k = alloc.get(a.job.job_id, 0)
        if k > 0:
            a.remaining -= a.job.throughput(k)
            a.started = True
        else:
            a.slack_left -= 1
            a.waited += 1


# --- packed (struct-of-arrays) fast path -----------------------------------
#
# The vectorised simulator engine keeps per-job state in flat arrays; the
# helpers below run Algorithm 3 against those arrays without building
# ActiveJob lists or per-slot (job, scale) Python enumerations.  Candidate
# (p, k) pairs per job are static — they depend only on the profile — so
# they are concatenated once per packed-job build and gathered per slot.


@dataclasses.dataclass
class EntryBlocks:
    """Per-job candidate (marginal, scale) pairs, concatenated row-major.

    Row j's pairs (k ascending, positive marginals only) live at
    ``flat_p/flat_k[off[j]:off[j] + cnt[j]]``."""

    flat_p: np.ndarray           # float64 marginals
    flat_k: np.ndarray           # int64 scales
    off: np.ndarray              # int64 per-row offset
    cnt: np.ndarray              # int64 per-row pair count

    @classmethod
    def build(cls, jobs: list[Job]) -> "EntryBlocks":
        ps, ks, off, cnt = [], [], [], []
        pos = 0
        for job in jobs:
            pairs = [(job.marginal(k), k)
                     for k in range(job.k_min, job.k_max + 1)
                     if job.marginal(k) > 0]
            off.append(pos)
            cnt.append(len(pairs))
            pos += len(pairs)
            ps.extend(p for p, _ in pairs)
            ks.extend(k for _, k in pairs)
        return cls(np.array(ps, dtype=np.float64),
                   np.array(ks, dtype=np.int64),
                   np.array(off, dtype=np.int64),
                   np.array(cnt, dtype=np.int64))

    def gather(self, rows: np.ndarray):
        """(P, K, R) candidate arrays for ``rows``, preserving row order."""
        cnt = self.cnt[rows]
        total = int(cnt.sum())
        if total == 0:
            z = np.zeros(0, dtype=np.int64)
            return np.zeros(0), z, z
        starts = np.cumsum(cnt) - cnt
        pos = np.arange(total, dtype=np.int64) - np.repeat(starts, cnt) \
            + np.repeat(self.off[rows], cnt)
        return self.flat_p[pos], self.flat_k[pos], np.repeat(rows, cnt)


def schedule_packed(
    blocks: EntryBlocks,
    k_min: np.ndarray,
    slack_left: np.ndarray,
    rows: np.ndarray,
    m_t: int,
    rho: float,
) -> np.ndarray:
    """Algorithm 3 over packed arrays; returns a full-length ``k`` vector.

    Produces exactly the allocation of ``schedule`` (same candidate order,
    same stable sort keys, same fill semantics)."""
    kcur = [0] * len(k_min)
    kml = k_min.tolist()
    used = 0

    # Forced jobs first (slack exhausted): base allocation, ignore rho.
    forced = rows[slack_left[rows] <= 0]
    for r in forced[np.argsort(slack_left[forced], kind="stable")].tolist():
        k = kml[r]
        if used + k > m_t:
            break
        kcur[r] = k
        used += k

    # Candidate (job, scale) list (lines 2–5), rho-filtered.
    P, K, R = blocks.gather(rows)
    keep = P >= rho - _EPS
    K, R = K[keep], R[keep]
    # Sort: marginal throughput desc, then remaining slack asc (line 6);
    # lexsort is stable, so ties keep (row, k) order like list.sort did.
    order = np.lexsort((slack_left[R], -P[keep]))
    rl, kl = R[order].tolist(), K[order].tolist()
    for i in range(len(rl)):                           # lines 7–9
        r = rl[i]
        k = kl[i]
        cur = kcur[r]
        if k == kml[r]:
            if cur != 0:
                continue
            add = k
        else:
            if cur != k - 1:
                continue
            add = 1
        if used + add > m_t:
            continue
        kcur[r] = k
        used += add
    return np.array(kcur, dtype=np.int64)
