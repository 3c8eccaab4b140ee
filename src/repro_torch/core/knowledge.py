"""State featurisation + KNN knowledge base (paper §4.2, Table 2).

The learning phase replays recent traces through the offline oracle and
stores ``STATE -> (m_t, rho_t)`` mappings.  The execution phase queries the
top-k nearest historical states (Euclidean distance over z-scored features;
the paper uses a scikit-learn KD-tree with k=5 — we use a brute-force
top-k, which is both simpler and faster at the case-base sizes involved:
a few thousand slots per window).

Aging (paper: "older mappings ... are aged out over a rolling window"): the
base keeps the most recent ``max_windows`` learning windows and drops older
ones on insert.

The normalised, weighted case matrix is computed once per ``_rebuild`` and
kept on ``device``: float32 on a CUDA device, where ``query`` /
``query_batch`` launch the hand-written kernels of ``kernels/knn.py``, and
float64 on the CPU, where their plain versions reproduce the JAX package's
numpy backend.  Featurisation and normalisation stay float64 numpy on the
host.  A per-slot ``query`` goes through ``kernels.knn.knn_lookup``: on the
card one launch that takes the query as its parameter and one write of the
k neighbours back into pinned host memory, with no copy to the card.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import knn as knn_kernel
from .carbon import CarbonService
from .types import Job


def build_state(
    ci: CarbonService,
    t: int,
    queue_counts: np.ndarray,
    mean_elasticity: float,
    arrivals_24h: np.ndarray | None = None,
    rel_backlog: float = 1.0,
) -> np.ndarray:
    """Table-2 state vector: [CI, CI gradient, CI day-ahead rank,
    min/mean CI ratios, per-queue (running+paused) job counts ...,
    per-queue trailing-24h arrival counts ..., relative backlog, mean
    elasticity].

    The trailing-arrival block is an addition to Table 2: in-system queue
    counts are *policy-dependent* — at runtime they drift away from the
    oracle's trajectory and corrupt the match — whereas arrival pressure is
    a pure function of the trace, so its distribution is identical in the
    learning and execution phases.
    """
    if arrivals_24h is None:
        arrivals_24h = np.zeros_like(np.asarray(queue_counts, dtype=np.float64))
    fc = ci.forecast(t)
    cur = ci.ci(t)
    ratio_min = cur / max(float(np.min(fc)), 1e-9)
    ratio_mean = cur / max(float(np.mean(fc)), 1e-9)
    return np.concatenate(
        [
            np.array([cur, ci.gradient(t), ci.rank(t), ratio_min, ratio_mean]),
            np.asarray(queue_counts, dtype=np.float64),
            np.asarray(arrivals_24h, dtype=np.float64),
            np.array([rel_backlog, mean_elasticity]),
        ]
    )


def relative_backlog(counts_history: np.ndarray) -> np.ndarray:
    """Policy-scale-invariant backlog signal: per-slot total in-system count
    divided by its running mean over the trajectory so far.

    Raw queue counts are policy-dependent (the runtime's backlog equilibrium
    differs from the oracle's), but *relative* deviation from one's own
    typical backlog transfers between the two trajectories.
    """
    counts = np.asarray(counts_history, dtype=np.float64)
    csum = np.cumsum(counts)
    denom = np.maximum(csum / np.arange(1, len(counts) + 1), 1e-9)
    return counts / denom


def states_from_schedule(
    jobs: list[Job],
    alloc: np.ndarray,
    ci: CarbonService,
    num_queues: int,
    t0: int = 0,
) -> np.ndarray:
    """Recompute the Table-2 state at each slot of an oracle run.

    ``alloc`` is the oracle's (N, T) allocation; a job is "in the system" at
    slot t if it has arrived and still has unfinished work (queued, paused,
    or running) — matching the runtime definition used by the simulator.
    """
    n, horizon = alloc.shape
    lengths = np.array([j.length for j in jobs])
    arrivals = np.array([j.arrival for j in jobs])
    queues = np.array([j.queue for j in jobs])
    elast = np.array([j.elasticity() for j in jobs])
    # Cumulative work done by each job before slot t, via the per-job
    # cumulative-throughput lookup table (no per-slot Python).
    kmax = int(alloc.max()) if alloc.size else 0
    thr_tab = np.zeros((n, kmax + 1))
    for i, job in enumerate(jobs):
        for k in range(1, kmax + 1):
            thr_tab[i, k] = job.throughput(k)
    thr = thr_tab[np.arange(n)[:, None], alloc]
    done_after = np.cumsum(thr, axis=1)
    ts = np.arange(horizon)
    done_before = np.concatenate([np.zeros((n, 1)), done_after[:, :-1]], axis=1)
    in_system = (arrivals[:, None] <= ts[None, :]) & \
        (done_before < (lengths - 1e-9)[:, None])               # (n, T)
    recent = (arrivals[:, None] > ts[None, :] - 24) & \
        (arrivals[:, None] <= ts[None, :])                      # (n, T)
    onehot = np.zeros((n, num_queues))
    onehot[np.arange(n), queues] = 1.0
    counts = in_system.T.astype(np.float64) @ onehot            # (T, nq)
    arr24 = recent.T.astype(np.float64) @ onehot                # (T, nq)
    n_in = in_system.sum(axis=0)
    el_sum = in_system.T.astype(np.float64) @ elast
    mean_el = np.where(n_in > 0, el_sum / np.maximum(n_in, 1), 0.0)
    rel = relative_backlog(counts.sum(axis=1))
    states = [
        build_state(ci, t0 + t, counts[t], float(mean_el[t]), arr24[t], rel[t])
        for t in range(horizon)
    ]
    return np.stack(states)


@dataclasses.dataclass
class KnowledgeBase:
    """Rolling case base of ``STATE -> (m_t, rho_t)`` oracle decisions.

    Distance details (beyond the paper's plain KD-tree Euclidean, which is
    brittle under closed-loop state drift):

    - queue-count features are ``log1p``-compressed, since the runtime
      policy's backlog distribution differs from the oracle's and raw counts
      otherwise dominate the metric when out-of-distribution;
    - features carry weights (CI level / day-ahead rank are the
      policy-relevant signal; queue counts provide demand context);
    - neighbour decisions are combined inverse-distance weighted.
    """

    max_windows: int = 8
    k: int = 5
    device: str | torch.device = "cuda"
    # [CI, gradient, rank, ratios, queues..., arrivals..., backlog,
    # elasticity] — the queue and arrival weights broadcast over their blocks.
    ci_weight: float = 2.0
    rank_weight: float = 2.0
    gradient_weight: float = 1.0
    queue_weight: float = 0.0
    arrival_weight: float = 0.0
    backlog_weight: float = 1.0
    elasticity_weight: float = 0.0
    ratio_weight: float = 2.0
    log_queues: bool = True

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        self._windows: deque[tuple[np.ndarray, np.ndarray]] = deque(maxlen=self.max_windows)
        self._dirty = True
        self._X = None
        self._Y = None
        self._mu = None
        self._sigma = None
        self._Xn = None            # normalised, weighted case matrix on device
        self._w = None             # feature weights of the case matrix's dim

    @classmethod
    def from_windows(cls, windows, device: str | torch.device = "cuda",
                     **kb_kwargs) -> "KnowledgeBase":
        """A base holding ``windows``, a list of ``(states, y)`` numpy pairs
        with ``y[:, 0] = m_t`` and ``y[:, 1] = rho_t`` (the form the JAX
        package's ``KnowledgeBase._windows`` keeps), oldest first."""
        kb = cls(device=device, **kb_kwargs)
        for states, y in windows:
            kb._windows.append((np.asarray(states, np.float64),
                                np.asarray(y, np.float64)))
        return kb

    def _weights(self, dim: int) -> np.ndarray:
        nq = (dim - 7) // 2
        return np.array(
            [self.ci_weight, self.gradient_weight, self.rank_weight,
             self.ratio_weight, self.ratio_weight]
            + [self.queue_weight] * nq
            + [self.arrival_weight] * nq
            + [self.backlog_weight, self.elasticity_weight]
        )

    def _transform(self, x: np.ndarray) -> np.ndarray:
        x = np.array(x, dtype=np.float64, copy=True)
        if self.log_queues:
            x[..., 5:-2] = np.log1p(np.maximum(x[..., 5:-2], 0.0))
        return x

    # --- learning-phase API -------------------------------------------------

    def add_window(self, states: np.ndarray, m_curve: np.ndarray, rho_curve: np.ndarray) -> None:
        y = np.stack([np.asarray(m_curve, np.float64), np.asarray(rho_curve, np.float64)], axis=1)
        self._windows.append((np.asarray(states, np.float64), y))
        self._dirty = True

    def _rebuild(self) -> None:
        xs = [w[0] for w in self._windows]
        ys = [w[1] for w in self._windows]
        self._X = self._transform(np.concatenate(xs)) if xs else np.zeros((0, 1))
        self._Y = np.concatenate(ys) if ys else np.zeros((0, 2))
        self._Xn = None
        if len(self._X):
            self._mu = self._X.mean(axis=0)
            self._sigma = np.maximum(self._X.std(axis=0), 1e-9)
            w = self._w = self._weights(self._X.shape[1])
            xn = np.clip((self._X - self._mu) / self._sigma, -3.0, 3.0) * w[None, :]
            # one host->device transfer per rebuild, not per query
            self._Xn = torch.as_tensor(xn, dtype=self._dtype, device=self.device)
        self._dirty = False

    @property
    def _dtype(self) -> torch.dtype:
        return torch.float64 if self.device.type == "cpu" else torch.float32

    def _normalize_query(self, state: np.ndarray) -> np.ndarray:
        """Z-score + clip + weight one state (or a (Q, D) batch of states)
        on the host, in float64.

        Clip z-scores: a low-variance feature (e.g. mean elasticity under a
        stable mix) must not dominate the metric when the runtime drifts
        slightly out of the training distribution.  (``np.minimum`` of
        ``np.maximum`` is ``np.clip``, NaN included, without its per-call
        overhead, which a per-slot query pays.)"""
        q = self._transform(np.asarray(state, np.float64))
        return np.minimum(np.maximum((q - self._mu) / self._sigma, -3.0), 3.0) * self._w

    def case_matrix(self) -> torch.Tensor:
        """The normalised, weighted (N, D) case matrix on ``device``."""
        if self._dirty:
            self._rebuild()
        return self._Xn

    def __len__(self) -> int:
        if self._dirty:
            self._rebuild()
        return len(self._X)

    def rho_values(self) -> np.ndarray:
        """All stored oracle rho decisions (the learned marginal-capacity
        curve's samples)."""
        if self._dirty:
            self._rebuild()
        return self._Y[:, 1] if len(self._X) else np.zeros(0)

    # --- execution-phase API ------------------------------------------------

    def _prepare(self, state: np.ndarray, k: int | None):
        if self._dirty:
            self._rebuild()
        if not len(self._X):
            raise RuntimeError("empty knowledge base — run a learning window first")
        return min(k or self.k, len(self._X)), self._normalize_query(state)

    def query(self, state: np.ndarray, k: int | None = None):
        """Top-k nearest cases.  Returns (m_values, rho_values, distances),
        the distances in float64 whatever the device computed in: see
        ``_decisions``."""
        k, q = self._prepare(state, k)
        dist, idx = knn_kernel.knn_lookup(self._Xn, q, k)
        return self._Y[idx, 0], self._Y[idx, 1], dist

    def query_batch(self, states: np.ndarray, k: int | None = None):
        """Top-k nearest cases for a (Q, D) batch of states in one dispatch.

        Returns ((Q, k) m_values, (Q, k) rho_values, (Q, k) distances).
        On the CPU the distances use the dot-product expansion, as the JAX
        package's numpy backend does, and can differ from ``query`` in the
        final ulps (ties may reorder)."""
        states = np.atleast_2d(np.asarray(states, np.float64))
        k, qs = self._prepare(states, k)
        qs = torch.as_tensor(qs, dtype=self._dtype).to(self.device)
        dist, idx = knn_kernel.knn_topk_batch(self._Xn, qs, k)
        return self._decisions(dist, idx)

    def _decisions(self, dist: torch.Tensor, idx: torch.Tensor):
        """Neighbour decisions and distances as float64 host arrays.
        Provisioning weighs the neighbours by inverse distance in float64
        whatever the device computed in: normalising float32 weights
        leaves their sum ~1e-8 off 1, which moves a rho shared by every
        neighbour past the scheduler's 1e-9 tolerance."""
        idx = idx.cpu().numpy()
        return self._Y[idx, 0], self._Y[idx, 1], dist.double().cpu().numpy()
