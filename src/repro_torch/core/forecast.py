"""Carbon-forecast model and the forecast-derived Table-2 features.

The paper assumes accurate day-ahead CI forecasts (citing CarbonCast).
This slice carries the perfect forecast only: :class:`PerfectForecast`
exposes the true trace.  :class:`ForecastFeatureMixin` defines the
forecast-derived Table-2 features once, for :class:`CarbonService` and
:class:`QuantileCIView` alike; the view serves the ``*-robust`` policy
variants, and under a perfect forecast it collapses onto the truth.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import numpy as np


def _truth_slice(trace: np.ndarray, t: int, horizon: int) -> np.ndarray:
    """Slice ``[t, t+horizon)``, padded past the trace end by repeating the
    last known value (all zeros when ``t`` is entirely past the end)."""
    end = min(t + horizon, len(trace))
    out = trace[t:end]
    if len(out) < horizon:
        out = np.concatenate(
            [out, np.full(horizon - len(out), out[-1] if len(out) else 0.0)])
    return out


@dataclasses.dataclass(frozen=True)
class PerfectForecast:
    """The paper's accurate-day-ahead assumption: the forecast IS the
    trace."""

    kind: ClassVar[str] = "perfect"

    def predict(self, trace: np.ndarray, t: int, horizon: int) -> np.ndarray:
        return _truth_slice(trace, t, horizon)

    def quantile(self, trace: np.ndarray, t: int, horizon: int,
                 q: float) -> np.ndarray:
        # a perfect forecaster's uncertainty band collapses onto the truth
        return _truth_slice(trace, t, horizon)


class ForecastFeatureMixin:
    """The forecast-derived Table-2 features, written once against
    ``self.forecast`` / ``self.horizon`` / ``self.trace``.

    ``CarbonService`` and :class:`QuantileCIView` both inherit these, so
    a view that overrides only ``forecast`` gets feature definitions that
    can never silently diverge from the service's."""

    def forecast_extended(self, t: int, horizon: int) -> np.ndarray:
        """Forecast beyond the day-ahead horizon by tiling the day-ahead
        diurnal pattern (the standard persistence assumption)."""
        day = self.forecast(t, self.horizon)
        if horizon <= len(day):
            return day[:horizon]
        reps = int(np.ceil(horizon / len(day)))
        return np.tile(day, reps)[:horizon]

    def rank(self, t: int) -> float:
        """Day-ahead rank of slot t: fraction of the next-24h forecast
        that is *more* carbon-intense than now (1.0 = best slot)."""
        fc = self.forecast(t)
        return float(np.mean(fc > self.trace[t]))

    def percentile_threshold(self, t: int, pct: float) -> float:
        """The pct-th percentile of the next-24h forecast (Wait-Awhile)."""
        return float(np.percentile(self.forecast(t), pct))


class QuantileCIView(ForecastFeatureMixin):
    """A read-only view of a carbon service whose ``forecast`` is the
    ``q``-quantile band of the underlying forecast model.

    Robust policies (``carbonflex-robust``, ``wait-awhile-robust``) build
    their forecast-derived features through this view.  Observed
    quantities (``ci``, ``gradient``) delegate to the truth unchanged."""

    def __init__(self, base, q: float) -> None:
        self.base = base
        self.q = float(q)

    @property
    def trace(self) -> np.ndarray:
        return self.base.trace

    @property
    def horizon(self) -> int:
        return self.base.horizon

    def __len__(self) -> int:
        return len(self.base)

    def ci(self, t: int) -> float:
        return self.base.ci(t)

    def gradient(self, t: int) -> float:
        return self.base.gradient(t)

    def forecast(self, t: int, horizon: int | None = None) -> np.ndarray:
        return self.base.forecast_quantile(t, horizon, q=self.q)
