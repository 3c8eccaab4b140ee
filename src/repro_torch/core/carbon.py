"""Carbon-intensity service (paper §2.1, §5, Fig. 1/5).

Provides hourly carbon-intensity traces per region plus the day-ahead
forecast features used in the Table-2 state: the raw CI, the CI gradient,
and the rank of the current slot against the next-24h forecast.

ElectricityMaps traces are not bundled, so ``synthesize_trace`` generates
seeded synthetic traces calibrated to the published per-region (mean, CoV)
of Fig. 5 — daily + half-daily harmonics, a weekly component, and AR(1)
noise.  The forecast model is pluggable (``core/forecast.py``): the
default :class:`~repro_torch.core.forecast.PerfectForecast` exposes the true
trace, while persistence / noisy / quantile-ensemble models stress policies
with realistic forecast error; ``model=StaticNoiseForecast(...)`` gives the
old static-noise semantics.  ``MultiRegionCarbonService`` aligns one
service per region for the geo-distributed policies (``core/geo.py``).
"""
from __future__ import annotations

import dataclasses
import warnings
import zlib

import numpy as np

from .faults import CarbonDataOutage, DegradedCIView, DegradedMultiRegionView
from .forecast import (ForecastFeatureMixin, ForecastModel, PerfectForecast,
                       StaticNoiseForecast)

# (mean g CO2/kWh, daily CoV) per region, calibrated to Fig. 5's spread:
# high-CoV renewable-heavy grids (South Australia) down to flat
# nuclear/gas grids (Virginia, Poland) and low-carbon hydro (Ontario, Sweden).
REGIONS: dict[str, tuple[float, float]] = {
    "south-australia": (250.0, 0.45),
    "california": (230.0, 0.28),
    "texas": (400.0, 0.20),
    "germany": (380.0, 0.30),
    "netherlands": (350.0, 0.22),
    "washington": (100.0, 0.20),
    "ontario": (60.0, 0.12),
    "sweden": (30.0, 0.10),
    "virginia": (350.0, 0.05),
    "poland": (650.0, 0.07),
}


def synthesize_trace(
    region: str,
    hours: int,
    seed: int = 0,
    start_hour: int = 0,
) -> np.ndarray:
    """Seeded synthetic hourly CI trace for ``region`` (g CO2eq/kWh)."""
    try:
        mean, cov = REGIONS[region]
    except KeyError:
        raise ValueError(
            f"unknown region {region!r}; available regions: "
            f"{', '.join(sorted(REGIONS))}") from None

    rng = np.random.default_rng(
        np.random.SeedSequence([seed, zlib.crc32(region.encode()) & 0x7FFFFFFF])
    )
    t = np.arange(start_hour, start_hour + hours, dtype=np.float64)
    # Daily solar/wind-driven swing (trough mid-day for solar-heavy grids),
    # a smaller half-day harmonic, and a weekly demand component.
    phase = rng.uniform(0, 2 * np.pi)
    daily = np.sin(2 * np.pi * (t - 14.0) / 24.0 + 0.0)
    half = 0.35 * np.sin(4 * np.pi * t / 24.0 + phase)
    weekly = 0.15 * np.sin(2 * np.pi * t / (24.0 * 7.0) + phase / 2)
    # AR(1) noise.
    eps = rng.normal(0.0, 1.0, hours)
    ar = np.empty(hours)
    acc = 0.0
    for i in range(hours):
        acc = 0.85 * acc + eps[i]
        ar[i] = acc
    ar *= 0.25 / max(ar.std(), 1e-9)
    shape = daily + half + weekly + ar
    shape /= max(shape.std(), 1e-9)
    ci = mean * (1.0 + cov * shape)
    return np.clip(ci, 10.0, None)


@dataclasses.dataclass
class CarbonService(ForecastFeatureMixin):
    """Day-ahead-capable CI service over a fixed hourly trace.

    The fields are the JAX package's, in its order, with its defaults, so a
    positional call means the same in both.  ``model`` is the pluggable
    forecast model (``core/forecast.py``); ``None`` resolves to
    :class:`PerfectForecast`.  ``forecast_noise`` is the deprecated static
    noise knob: it still works (as a :class:`StaticNoiseForecast` shim of
    ``sigma=forecast_noise, seed=seed``, the reference's outputs bit for
    bit) but warns; pass ``model=NoisyForecast(...)`` for lead-time-aware
    error.  ``outage`` injects stale/gap windows into the feed the policy
    stack reads (``degraded()``); accounting keeps reading the true
    trace."""

    trace: np.ndarray
    forecast_noise: float = 0.0
    horizon: int = 24
    seed: int = 0
    model: ForecastModel | None = None
    # Feed-outage injection (core/faults.py): stale/gap windows the policy
    # stack sees through ``degraded()``.  None = the feed is always fresh
    # and ``degraded()`` returns the service itself.
    outage: CarbonDataOutage | None = None

    def __post_init__(self) -> None:
        if self.forecast_noise > 0:
            if self.model is not None:
                raise ValueError("pass either model= or the deprecated "
                                 "forecast_noise=, not both")
            warnings.warn(
                "CarbonService(forecast_noise=...) is deprecated: it draws "
                "one static noise realization over the whole trace, so the "
                "realized error of a future slot never shrinks as it "
                "approaches; pass model=NoisyForecast(sigma=...) for "
                "lead-time-aware error (or model=StaticNoiseForecast(...) "
                "to keep the old semantics explicitly)",
                DeprecationWarning, stacklevel=2)
            self.model = StaticNoiseForecast(sigma=self.forecast_noise, seed=self.seed)
            # the knob is consumed into the model; zeroed, so that
            # dataclasses.replace(svc, ...) on a shim-built service does not
            # trip the model-xor-knob check above
            self.forecast_noise = 0.0
        elif self.model is None:
            self.model = PerfectForecast()

    @classmethod
    def synthetic(cls, region: str, hours: int, seed: int = 0, **kw) -> "CarbonService":
        return cls(trace=synthesize_trace(region, hours, seed=seed), seed=seed, **kw)

    def __len__(self) -> int:
        return len(self.trace)

    def ci(self, t: int) -> float:
        return float(self.trace[min(t, len(self.trace) - 1)])

    def degraded(self) -> "CarbonService | DegradedCIView":
        """The view the *policy stack* reads: the service itself when the
        feed has no outages, else a cached :class:`DegradedCIView`
        (forward-filled observations, staged forecast fallback).  The
        engines keep reading the true service for carbon accounting."""
        if self.outage is None:
            return self
        cached = self.__dict__.get("_degraded")
        if cached is None:
            cached = DegradedCIView(self, self.outage)
            self._degraded = cached
        return cached

    def forecast(self, t: int, horizon: int | None = None) -> np.ndarray:
        """Day-ahead forecast starting at slot t (paper footnote 3),
        delegated to the configured forecast model."""
        return self.model.predict(self.trace, t, horizon or self.horizon)

    def forecast_quantile(self, t: int, horizon: int | None = None,
                          q: float = 0.5) -> np.ndarray:
        """Per-horizon ``q``-quantile band of the forecast; models without
        uncertainty bands fall back to their point forecast."""
        h = horizon or self.horizon
        quantile = getattr(self.model, "quantile", None)
        if quantile is None:
            return self.model.predict(self.trace, t, h)
        return quantile(self.trace, t, h, q)

    # --- Table-2 features --------------------------------------------------
    # (forecast_extended / rank / percentile_threshold come from
    # ForecastFeatureMixin, shared with the robust policies' QuantileCIView)

    def gradient(self, t: int) -> float:
        """CI gradient: normalised slope at slot t."""
        if t == 0:
            return 0.0
        prev, cur = self.trace[t - 1], self.trace[t]
        return float((cur - prev) / max(prev, 1e-9))


@dataclasses.dataclass
class MultiRegionCarbonService:
    """Aligned per-region CI traces + forecasts for geo-distributed runs.

    Wraps one :class:`CarbonService` per region over traces of identical
    length and slot alignment (slot ``t`` is the same wall-clock hour in
    every region), so a geo policy can compare regions at a glance:
    ``ci_vec(t)`` is the current CI across regions, ``rank_vec(t)`` the
    Table-2 day-ahead rank feature per region, ``cleanest(t)`` the index
    of the currently lowest-CI region.
    """

    regions: tuple[str, ...]
    services: tuple[CarbonService, ...]

    def __post_init__(self) -> None:
        self.regions = tuple(self.regions)
        self.services = tuple(self.services)
        if not self.regions:
            raise ValueError("MultiRegionCarbonService needs >= 1 region")
        if len(self.regions) != len(self.services):
            raise ValueError("regions and services must align")
        if len(set(self.regions)) != len(self.regions):
            raise ValueError(f"duplicate regions: {self.regions}")
        lengths = {len(s) for s in self.services}
        if len(lengths) != 1:
            raise ValueError(f"per-region traces must have equal length, "
                             f"got {sorted(lengths)}")

    @classmethod
    def synthetic(cls, regions, hours: int, seed: int = 0,
                  **kw) -> "MultiRegionCarbonService":
        """Seeded aligned synthetic traces (one ``synthesize_trace`` per
        region; the shared ``seed`` keeps the worlds reproducible while the
        per-region CRC stream keeps the traces distinct)."""
        return cls(tuple(regions),
                   tuple(CarbonService.synthetic(r, hours, seed=seed, **kw)
                         for r in regions))

    @property
    def n_regions(self) -> int:
        return len(self.regions)

    def __len__(self) -> int:
        return len(self.services[0])

    def index(self, region: str) -> int:
        try:
            return self.regions.index(region)
        except ValueError:
            raise ValueError(f"unknown region {region!r}; this service "
                             f"covers: {', '.join(self.regions)}") from None

    def service(self, region: int | str) -> CarbonService:
        if isinstance(region, str):
            region = self.index(region)
        return self.services[region]

    def ci(self, t: int, region: int | str = 0) -> float:
        """Single-region CI accessor (defaults to region 0 so existing
        single-region code paths can read a geo service unambiguously)."""
        return self.service(region).ci(t)

    def degraded(self) -> "MultiRegionCarbonService | DegradedMultiRegionView":
        """Multi-region analogue of :meth:`CarbonService.degraded`: the
        service itself when every regional feed is outage-free, else a
        cached view stitching the per-region degraded views."""
        if all(s.outage is None for s in self.services):
            return self
        cached = self.__dict__.get("_degraded")
        if cached is None:
            cached = DegradedMultiRegionView(self)
            self._degraded = cached
        return cached

    def ci_vec(self, t: int) -> np.ndarray:
        return np.array([s.ci(t) for s in self.services])

    def forecast_matrix(self, t: int, horizon: int | None = None) -> np.ndarray:
        """(n_regions, horizon) day-ahead forecast block at slot t."""
        return np.stack([s.forecast(t, horizon) for s in self.services])

    def rank_vec(self, t: int) -> np.ndarray:
        """Per-region day-ahead rank of slot t (1.0 = region's best slot)."""
        return np.array([s.rank(t) for s in self.services])

    def cleanest(self, t: int) -> int:
        """Index of the currently lowest-CI region (ties -> lowest index)."""
        return int(np.argmin(self.ci_vec(t)))

