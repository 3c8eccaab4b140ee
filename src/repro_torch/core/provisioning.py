"""CarbonFlex runtime provisioning — Algorithm 2 (phi).

Given the current Table-2 state, query the knowledge base for the top-k
closest historical states and mimic the oracle's capacity choice:

- normal case: provision the mean matched capacity;
- recent delay violations above the tolerance ``epsilon``: be conservative,
  provision the max of the matches and the current capacity;
- violations *and* poor match quality (distance above ``delta``): fall back
  to carbon-agnostic provisioning (the full capacity ``M``).

The same query also yields the scheduling threshold ``rho`` consumed by
Algorithm 3, so ``provision`` returns both.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .knowledge import KnowledgeBase


@dataclasses.dataclass
class ProvisioningConfig:
    delta: float = 2.0        # max acceptable match distance (z-scored units)
    epsilon: float = 0.05     # tolerated recent delay-violation rate
    k: int = 5


def provision(
    state: np.ndarray,
    kb: KnowledgeBase,
    capacity: int,
    current_m: int,
    violation_rate: float,
    cfg: ProvisioningConfig = ProvisioningConfig(),
    min_required: int = 0,
) -> tuple[int, float]:
    """Returns (m_t, rho).  ``min_required`` lower-bounds the capacity with
    the servers needed by jobs whose slack is exhausted (run-to-completion
    guarantee, §6.1) — the provisioning never starves forced jobs."""
    m_vals, rho_vals, dist = kb.query(state, k=cfg.k)
    w = 1.0 / np.maximum(dist, 1e-6)
    w = w / w.sum()
    if float(np.min(dist)) > cfg.delta and violation_rate > cfg.epsilon:
        m = capacity                                  # line 3: fall back to M
        rho = 1.0
    elif violation_rate > cfg.epsilon:
        m = int(max(np.max(m_vals), current_m))       # line 5
        rho = float(np.min(rho_vals))
    else:
        m = int(round(float(np.sum(w * m_vals))))     # line 6 (dist-weighted)
        rho = float(np.sum(w * rho_vals))
    m = int(np.clip(max(m, min_required), 0, capacity))
    return m, rho
