"""Pluggable carbon-forecast models and the forecast-derived Table-2
features.

The paper assumes accurate day-ahead CI forecasts (citing CarbonCast);
CarbonScaler and the PCAPS line evaluate against forecasts whose error
grows with horizon.  The forecast is a swappable model, so every policy
can be stressed along that axis:

- :class:`PerfectForecast`      — the true trace (the default);
- :class:`PersistenceForecast`  — yesterday-as-tomorrow: the prediction
  for slot ``t+h`` is the observation from 24 h earlier (no peeking at the
  future);
- :class:`NoisyForecast`        — seeded AR(1) multiplicative error whose
  std grows with lead time: the realized error of a future slot depends
  on *when it is queried* (re-querying closer in time shrinks the error);
- :class:`QuantileForecast`     — a seeded ensemble of AR(1) error paths
  exposing per-horizon quantiles (``quantile(trace, t, h, q)``); its
  point forecast is the ensemble median;
- :class:`StaticNoiseForecast`  — the JAX package's deprecated
  ``forecast_noise`` behaviour (one noise realization drawn over the
  whole trace at construction seed, identical at every lead time).

Models are frozen config dataclasses: stateless, shareable across
scenarios, deterministic per ``(seed, trace, query slot)``.  Every RNG
stream is numpy, seeded as the JAX package seeds it, so one seed gives the
same error stream in both packages.  The stream is salted with a trace
fingerprint so aligned multi-region traces see independent forecast
errors.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class ForecastModel(Protocol):
    """A forecast model maps (true trace, query slot, horizon) to the
    forecast a scheduler would have seen at that slot.

    ``predict`` returns the point forecast for slots ``t .. t+horizon-1``
    (index 0 is the current slot, observed, hence error-free).  Models
    may additionally implement ``quantile(trace, t, horizon, q)`` for
    per-horizon uncertainty bands; callers fall back to ``predict`` when
    it is absent (see ``CarbonService.forecast_quantile``)."""

    kind: str

    def predict(self, trace: np.ndarray, t: int,
                horizon: int) -> np.ndarray: ...


def _truth_slice(trace: np.ndarray, t: int, horizon: int) -> np.ndarray:
    """Slice ``[t, t+horizon)``, pad past the trace end by repeating the last
    known value (all zeros when ``t`` is entirely past the end)."""
    end = min(t + horizon, len(trace))
    out = trace[t:end]
    if len(out) < horizon:
        out = np.concatenate(
            [out, np.full(horizon - len(out), out[-1] if len(out) else 0.0)])
    return out


def _trace_salt(trace: np.ndarray) -> int:
    """Cheap per-trace RNG salt (first value's bit pattern + length) so
    aligned per-region traces draw independent error streams."""
    if len(trace) == 0:
        return 0
    bits = int(np.float64(trace[0]).view(np.uint64))
    return (bits ^ (len(trace) << 1)) & 0xFFFFFFFFFFFFFFFF


def _ar1_errors(rng: np.random.Generator, horizon: int, sigma: float,
                phi: float) -> np.ndarray:
    """One AR(1) multiplicative-error path with zero error at lead 0.

    ``e_0 = 0`` (the current slot is observed) and
    ``e_h = phi * e_{h-1} + sigma * sqrt(1 - phi^2) * z_h`` so
    ``std(e_h) = sigma * sqrt(1 - phi^(2h))`` — the error *grows with the
    lead time* from 0 toward the stationary ``sigma``."""
    z = rng.normal(0.0, 1.0, horizon)
    c = sigma * np.sqrt(max(1.0 - phi * phi, 0.0))
    err = np.zeros(horizon)
    acc = 0.0
    for i in range(1, horizon):
        acc = phi * acc + c * z[i]
        err[i] = acc
    return err


def _apply_error(truth: np.ndarray, err: np.ndarray,
                 floor: float) -> np.ndarray:
    """Multiplicative error with a positivity floor; zero truth (past the
    trace end) stays zero, matching the perfect-forecast padding."""
    return np.where(truth > 0.0,
                    np.clip(truth * (1.0 + err), floor, None), truth)


def _memo1(model, trace: np.ndarray, t: int, horizon: int, compute):
    """Per-trace single-slot memo for (trace, t, horizon) -> array.

    The engines read the same query slot several times per decision
    (point forecast, rank, percentile threshold, ratio features), so the
    last result *per trace* is the one that matters — one slot per trace
    (not one global slot) because a geo scenario shares one model
    instance across all region services and interleaves their reads
    every slot.  Entries hold the trace reference and re-check identity
    with ``is``, so recycled ids cannot alias; stored via
    ``object.__setattr__`` because the models are frozen dataclasses
    (the memo is not a field, so equality/serialization are unaffected)."""
    memo = model.__dict__.get("_memo")
    if memo is None:
        memo = {}
        object.__setattr__(model, "_memo", memo)
    hit = memo.get(id(trace))
    if hit is not None and hit[0] is trace and hit[1] == (t, horizon):
        return hit[2]
    val = compute()
    if len(memo) >= 16 and id(trace) not in memo:
        memo.clear()            # bound pathological many-trace churn
    memo[id(trace)] = (trace, (t, horizon), val)
    return val


def _norm_ppf(q: float) -> float:
    """Acklam's rational approximation of the standard-normal inverse CDF
    (|rel err| < 1.2e-9; scipy is not a dependency of this package)."""
    if not 0.0 < q < 1.0:
        raise ValueError(f"quantile must be in (0, 1), got {q}")
    a = (-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00)
    p_low = 0.02425
    if q < p_low:
        r = np.sqrt(-2.0 * np.log(q))
        return (((((c[0] * r + c[1]) * r + c[2]) * r + c[3]) * r + c[4]) * r
                + c[5]) / ((((d[0] * r + d[1]) * r + d[2]) * r + d[3]) * r
                           + 1.0)
    if q > 1.0 - p_low:
        r = np.sqrt(-2.0 * np.log(1.0 - q))
        return -(((((c[0] * r + c[1]) * r + c[2]) * r + c[3]) * r + c[4]) * r
                 + c[5]) / ((((d[0] * r + d[1]) * r + d[2]) * r + d[3]) * r
                            + 1.0)
    r = q - 0.5
    s = r * r
    return (((((a[0] * s + a[1]) * s + a[2]) * s + a[3]) * s + a[4]) * s
            + a[5]) * r / (((((b[0] * s + b[1]) * s + b[2]) * s + b[3]) * s
                            + b[4]) * s + 1.0)


# --- the four models + the legacy shim ---------------------------------------


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


@dataclasses.dataclass(frozen=True)
class PersistenceForecast:
    """Yesterday-as-tomorrow: the prediction for slot ``t+h`` is the
    observation from ``period`` slots earlier (tiled for horizons past one
    period).  Index 0 is the observed current slot.  Only past values are
    read (clamped into the trace at its edges), so this is a *realizable*
    day-ahead baseline — the standard no-model reference in the
    CarbonCast/CarbonScaler evaluations."""

    period: int = 24
    kind: ClassVar[str] = "persistence"

    def predict(self, trace: np.ndarray, t: int, horizon: int) -> np.ndarray:
        if len(trace) == 0:
            return np.zeros(horizon)
        last = len(trace) - 1
        out = np.empty(horizon)
        out[0] = trace[min(max(t, 0), last)]
        for h in range(1, horizon):
            # map lead h >= 1 onto yesterday's matching offset: 1..period
            eff = (h - 1) % self.period + 1
            idx = t + eff - self.period
            out[h] = trace[min(max(idx, 0), last)]
        return out


@dataclasses.dataclass(frozen=True)
class NoisyForecast:
    """Seeded AR(1) multiplicative forecast error, std growing with lead.

    Every query slot ``t`` draws its own error path from a stream keyed by
    ``(seed, t, trace)``: re-querying the same future slot closer in time
    yields a *fresh, smaller* error — the lead-time semantics the old
    static ``forecast_noise`` knob got wrong (it drew one realization over
    the whole trace at construction, so the error of a future slot never
    shrank as it approached).  ``std(err at lead h) = sigma *
    sqrt(1 - phi^(2h))``.

    ``quantile`` exposes the model's *self-knowledge*: per-horizon normal
    bands around its own point forecast (no additional truth access)."""

    sigma: float = 0.1
    phi: float = 0.9
    seed: int = 0
    floor: float = 1.0
    kind: ClassVar[str] = "noisy"

    def _rng(self, trace: np.ndarray, t: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence(
            [1, self.seed, max(int(t), 0), _trace_salt(trace)]))

    def predict(self, trace: np.ndarray, t: int, horizon: int) -> np.ndarray:
        def compute():
            truth = _truth_slice(trace, t, horizon)
            err = _ar1_errors(self._rng(trace, t), horizon, self.sigma,
                              self.phi)
            return _apply_error(truth, err, self.floor)

        return _memo1(self, trace, t, horizon, compute)

    def lead_std(self, horizon: int) -> np.ndarray:
        """Analytic per-lead error std: sigma * sqrt(1 - phi^(2h))."""
        h = np.arange(horizon, dtype=np.float64)
        return self.sigma * np.sqrt(1.0 - self.phi ** (2.0 * h))

    def quantile(self, trace: np.ndarray, t: int, horizon: int,
                 q: float) -> np.ndarray:
        pred = self.predict(trace, t, horizon)
        band = 1.0 + _norm_ppf(q) * self.lead_std(horizon)
        return np.where(pred > 0.0,
                        np.clip(pred * band, self.floor, None), pred)


@dataclasses.dataclass(frozen=True)
class QuantileForecast:
    """Seeded ensemble forecast: ``members`` independent AR(1) error paths
    per query slot.  ``predict`` is the per-horizon ensemble median;
    ``quantile(trace, t, h, q)`` the empirical per-horizon ``q``-quantile
    (monotone in ``q`` by construction).  Robust policy variants threshold
    on a configurable quantile of this band instead of a point value."""

    sigma: float = 0.1
    phi: float = 0.9
    members: int = 15
    seed: int = 0
    floor: float = 1.0
    kind: ClassVar[str] = "quantile"

    def __post_init__(self) -> None:
        if self.members < 2:
            raise ValueError("a quantile ensemble needs >= 2 members")

    def _ensemble(self, trace: np.ndarray, t: int,
                  horizon: int) -> np.ndarray:
        def compute():
            truth = _truth_slice(trace, t, horizon)
            salt = _trace_salt(trace)
            ens = np.empty((self.members, horizon))
            for m in range(self.members):
                rng = np.random.default_rng(np.random.SeedSequence(
                    [2, self.seed, max(int(t), 0), m, salt]))
                err = _ar1_errors(rng, horizon, self.sigma, self.phi)
                ens[m] = _apply_error(truth, err, self.floor)
            return ens

        return _memo1(self, trace, t, horizon, compute)

    def predict(self, trace: np.ndarray, t: int, horizon: int) -> np.ndarray:
        return np.quantile(self._ensemble(trace, t, horizon), 0.5, axis=0)

    def quantile(self, trace: np.ndarray, t: int, horizon: int,
                 q: float) -> np.ndarray:
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        return np.quantile(self._ensemble(trace, t, horizon), q, axis=0)


@dataclasses.dataclass(frozen=True)
class StaticNoiseForecast:
    """The semantics of the JAX package's deprecated
    ``CarbonService(forecast_noise=...)``, kept bit-for-bit: one gaussian
    multiplicative realization drawn over the whole trace at construction
    (``default_rng(seed)``), identical at every query slot and lead time.
    Prefer :class:`NoisyForecast`."""

    sigma: float
    seed: int = 0
    kind: ClassVar[str] = "static-noise"

    def _noisy_trace(self, trace: np.ndarray) -> np.ndarray:
        cached = self.__dict__.get("_cache")
        if cached is not None and cached[0] is trace:
            return cached[1]
        noise = np.random.default_rng(self.seed).normal(
            1.0, self.sigma, len(trace))
        noisy = np.clip(trace * noise, 1.0, None)
        object.__setattr__(self, "_cache", (trace, noisy))
        return noisy

    def predict(self, trace: np.ndarray, t: int, horizon: int) -> np.ndarray:
        return _truth_slice(self._noisy_trace(trace), t, horizon)


# --- forecast-derived Table-2 features ---------------------------------------


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
    their forecast-derived features (rank, percentile thresholds, ratio
    features) through this view, so a single quantile knob turns any
    forecast-consuming policy conservative.  Observed quantities
    (``ci``, ``gradient``) delegate to the truth unchanged; the derived
    features come from :class:`ForecastFeatureMixin` over the band."""

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


# --- serialization / labels --------------------------------------------------


FORECAST_KINDS: dict[str, type] = {
    PerfectForecast.kind: PerfectForecast,
    PersistenceForecast.kind: PersistenceForecast,
    NoisyForecast.kind: NoisyForecast,
    QuantileForecast.kind: QuantileForecast,
    StaticNoiseForecast.kind: StaticNoiseForecast,
}


def forecast_to_dict(model: "ForecastModel | None") -> dict | None:
    """JSON-safe payload round-tripped by :func:`forecast_from_dict`."""
    if model is None:
        return None
    if model.kind not in FORECAST_KINDS:
        raise ValueError(f"unregistered forecast kind {model.kind!r}; "
                         f"known kinds: {', '.join(sorted(FORECAST_KINDS))}")
    return {"kind": model.kind,
            **{f.name: getattr(model, f.name)
               for f in dataclasses.fields(model)}}


def forecast_from_dict(d: dict | None) -> "ForecastModel | None":
    if d is None:
        return None
    d = dict(d)
    kind = d.pop("kind", None)
    try:
        cls = FORECAST_KINDS[kind]
    except KeyError:
        raise ValueError(f"unknown forecast kind {kind!r}; known kinds: "
                         f"{', '.join(sorted(FORECAST_KINDS))}") from None
    return cls(**d)


def forecast_label(model: "ForecastModel | None") -> str:
    """Short sweep-row label: ``perfect``, ``noisy(s=0.2)``, ...

    NOT injective over models (seed/phi are omitted for readability) —
    axis code that keys cells on labels must use :func:`forecast_labels`,
    which disambiguates colliding entries."""
    if model is None or model.kind == "perfect":
        return "perfect"
    if model.kind == "persistence":
        return "persistence"
    if model.kind in ("noisy", "static-noise"):
        return f"{model.kind}(s={model.sigma:g})"
    if model.kind == "quantile":
        return f"quantile(s={model.sigma:g},m={model.members})"
    return model.kind


def forecast_labels(models) -> list[str]:
    """Per-axis-entry labels, made unique: when two *different* models
    share a :func:`forecast_label` (e.g. same sigma, different seed or
    phi), later ones gain a ``#k`` suffix so savings/gap cells keyed on
    the label cannot silently merge.  Equal models keep equal labels."""
    labels = []
    by_label: dict[str, list] = {}
    for m in models:
        base = forecast_label(m)
        group = by_label.setdefault(base, [])
        idx = next((i for i, prev in enumerate(group) if prev == m), None)
        if idx is None:
            idx = len(group)
            group.append(m)
        labels.append(base if idx == 0 else f"{base}#{idx + 1}")
    return labels
