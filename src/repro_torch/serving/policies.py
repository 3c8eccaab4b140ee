"""Serving policies: per-slot precision-tier splits under a quality ledger.

The serve family is the interactive-traffic counterpart of the batch
policy registry: a policy sees the slot's demand, the (possibly degraded)
carbon view, the demand-rate forecast, and the current ledger balance, and
returns the fraction of the slot's requests routed to each precision tier.

- ``serve-static`` — everything on the full-precision tier, always: the
  status-quo baseline every savings number is measured against.
- ``serve-greedy`` — current-CI threshold (Wait-Awhile in quality space):
  degrade toward the cheap tier when CI sits above the 70th percentile of
  the day-ahead forecast, repay with full quality below the 30th,
  ledger-bounded both ways.
- ``serve-flex`` — the forecast-aware-global policy: a multi-factor
  weighted adjustment combining the short-term CI trend, the demand
  forecast, an extended look-ahead read through
  :class:`~repro_torch.core.forecast.QuantileCIView`, and a
  cumulative-emissions budget, scaled by the ledger headroom.

Policies are deterministic functions of their inputs — the engine's
vector/scalar parity rests on calling the *same* policy code from both
paths, so nothing here may read a clock or an unseeded RNG.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.forecast import QuantileCIView

from .tiers import PrecisionTier, ServingConfig, SloModel, mix_for_quality


@dataclasses.dataclass
class ServeWindow:
    """Everything a serving policy may read during one simulated window,
    handed to ``on_window_start`` by the engine.

    ``ci`` is the *policy-visible* carbon view (``CarbonService.degraded()``
    — forward-filled during feed outages); the engine keeps accounting on
    the true trace.  ``rate`` is the full-span expected request-rate curve
    (``traces.requests.expected_request_rate``) — the demand *forecast*,
    not the realized demand, so policies face genuine error at bursts."""

    config: ServingConfig
    tiers: tuple[PrecisionTier, ...]
    q_vec: np.ndarray                # per-tier quality, descending
    e_vec: np.ndarray                # per-tier kWh per 1000 requests
    inv_cap: np.ndarray              # per-tier 1 / (requests per server-slot)
    slo: SloModel
    ci: object                       # CarbonService / DegradedCIView
    rate: np.ndarray                 # expected requests/slot, absolute index
    t0: int                          # first slot of the window
    servers: int


def relieve_capacity(frac: np.ndarray, demand: float,
                     w: ServeWindow) -> np.ndarray:
    """Shift routed mass toward the highest-capacity (cheapest) tier until
    projected utilization drops to the SLO knee, or everything movable has
    moved.  Deterministic greedy from the most expensive tier down — the
    overload response of the adaptive policies (``serve-static``
    deliberately does not call this: eating the violations is what the
    status quo does)."""
    scale = demand / w.servers
    util = float(np.sum(frac * w.inv_cap)) * scale
    knee = w.slo.knee
    if util <= knee or scale <= 0.0:
        return frac
    frac = frac.copy()
    last = len(frac) - 1
    for i in range(last):
        if util <= knee:
            break
        gain = (w.inv_cap[i] - w.inv_cap[last]) * scale
        if gain <= 0.0 or frac[i] <= 0.0:
            continue
        move = min(frac[i], (util - knee) / gain)
        frac[i] -= move
        frac[last] += move
        util -= move * gain
    return frac


class ServeStaticPolicy:
    """All requests on the full-precision tier, every slot."""

    name = "serve-static"

    def on_window_start(self, w: ServeWindow) -> None:
        self._frac = np.zeros(len(w.tiers))
        self._frac[0] = 1.0

    def decide(self, t: int, demand: float, balance: float,
               cum_carbon_g: float, cum_requests: float) -> np.ndarray:
        return self._frac


class ServeGreedyPolicy:
    """Current-CI percentile threshold, ledger-bounded.

    Above the 70th percentile of the day-ahead forecast the target quality
    drops toward the cheapest tier's, scaled by the ledger's remaining
    spend headroom (deep in debt -> barely degrade); below the 30th it
    repays at full quality; in between it holds ``quality_target``."""

    name = "serve-greedy"

    def on_window_start(self, w: ServeWindow) -> None:
        self.w = w

    def decide(self, t: int, demand: float, balance: float,
               cum_carbon_g: float, cum_requests: float) -> np.ndarray:
        w = self.w
        ci_now = w.ci.ci(t)
        target = w.config.quality_target
        if ci_now >= w.ci.percentile_threshold(t, 70.0):
            spend = (balance + 1.0) / 2.0
            q = target - spend * (target - float(w.q_vec[-1]))
        elif ci_now <= w.ci.percentile_threshold(t, 30.0):
            q = 1.0
        else:
            q = target
        return relieve_capacity(mix_for_quality(w.q_vec, q), demand, w)


class ServeFlexPolicy:
    """Forecast-aware-global routing.

    Four factors, each in [-1, +1] with positive = *degrade now* (now is
    carbon-expensive relative to the future) and negative = *repay now*:

    - ``trend`` (0.35): the CI gradient — falling CI means the near future
      is cleaner, so spend quality debt now and repay in the clean slots;
    - ``demand`` (0.25): the rate forecast over the next ``horizon`` slots
      vs now — a spike ahead means capacity relief will soon *force*
      cheap-tier debt, so repay now to conserve ledger headroom for it;
    - ``look`` (0.20): current CI vs the mean of the extended look-ahead,
      read at the conservative ``quantile`` through
      :class:`QuantileCIView` (<60% -> strong repay, >140% -> strong
      degrade, linear between);
    - ``budget`` (0.20): realized grams/request so far vs the window's
      budget (serving at ``quality_target`` under the day-ahead mean CI)
      — over budget pushes toward cheap tiers regardless of the moment.

    The weighted sum is scaled by ledger headroom on the chosen side, so a
    maxed-out ledger mutes further movement in that direction."""

    name = "serve-flex"

    def __init__(self, quantile: float = 0.7, horizon: int = 6) -> None:
        self.quantile = float(quantile)
        self.horizon = int(horizon)

    def on_window_start(self, w: ServeWindow) -> None:
        self.w = w
        self.view = QuantileCIView(w.ci, self.quantile)
        frac0 = mix_for_quality(w.q_vec, w.config.quality_target)
        ci_ref = float(np.mean(w.ci.forecast(w.t0, 24)))
        self.budget_g_per_req = \
            float(np.sum(frac0 * w.e_vec)) * ci_ref / 1000.0

    def decide(self, t: int, demand: float, balance: float,
               cum_carbon_g: float, cum_requests: float) -> np.ndarray:
        w = self.w
        ci_now = w.ci.ci(t)
        f_trend = float(np.clip(-w.ci.gradient(t) / 0.05, -1.0, 1.0))
        ahead = w.rate[t + 1: t + 1 + self.horizon]
        if len(ahead):
            rate_now = max(float(w.rate[min(t, len(w.rate) - 1)]), 1.0)
            ratio_d = float(np.mean(ahead)) / rate_now
        else:
            ratio_d = 1.0
        f_demand = float(np.clip(-(ratio_d - 1.0) / 0.5, -1.0, 1.0))
        look = self.view.forecast_extended(t, self.horizon)
        ratio_c = ci_now / max(float(np.mean(look)), 1e-9)
        f_look = float(np.clip((ratio_c - 1.0) / 0.4, -1.0, 1.0))
        if cum_requests > 0.0:
            rate_g = cum_carbon_g / cum_requests
            f_budget = float(np.clip(
                (rate_g / max(self.budget_g_per_req, 1e-12) - 1.0) / 0.2,
                -1.0, 1.0))
        else:
            f_budget = 0.0
        adj = (0.35 * f_trend + 0.25 * f_demand
               + 0.20 * f_look + 0.20 * f_budget)
        target = w.config.quality_target
        if adj >= 0.0:
            spend = (balance + 1.0) / 2.0
            q = target - adj * spend * (target - float(w.q_vec[-1]))
        else:
            repay = (1.0 - balance) / 2.0
            q = target + (-adj) * repay * (1.0 - target)
        return relieve_capacity(mix_for_quality(w.q_vec, q), demand, w)
