"""Precision tiers, the SLO/latency model, and the quality credit ledger.

The serving tier trades **quality for carbon**: when carbon intensity is
high, traffic is routed to cheaper reduced-precision model flavours;
the quality shortfall is tracked as *debt* in a :class:`CreditLedger`
and repaid with above-target quality when carbon is low (the
demand-shaping idea of Radovanović et al.'s carbon-aware datacenter work,
tier-granular like the k8s-carbonrouter ``precision_tier`` stack).

The tier table is **derived from the repo's own cost models** rather than
invented:

- ``serve/decode.py``'s decode step is memory-bandwidth-bound (the KV
  cache sharding analysis there), so per-request energy and latency scale
  with *bytes moved* — halving the precision halves the energy per
  request and doubles the per-server throughput.  Tier energy/capacity
  therefore scale by ``bytes / 4`` relative to the fp32 reference.
- ``elastic/compression.py``'s int8 path quantises with per-tensor
  max-abs scaling to 127 levels; :func:`_int8_rms_rel_error` replicates
  that exact scheme in numpy on a seeded gaussian tensor to *measure* the
  RMS relative error it introduces, and bf16 rounding error is measured
  the same way by truncating fp32 mantissas.  Tier quality is then
  ``1 - quality_kappa * rms_error`` — a linear response-quality proxy.
"""
from __future__ import annotations

import dataclasses

import numpy as np


# --- measured quantisation error (the quality model's input) -----------------


def _int8_rms_rel_error(n: int = 1 << 14, seed: int = 0) -> float:
    """RMS relative error of the ``elastic/compression.py`` int8 scheme
    (per-tensor max-abs scaling to [-127, 127]) on a seeded standard
    gaussian tensor — a pure-numpy replica of ``_int8_roundtrip``, so the
    serving layer derives tier quality from numpy alone."""
    g = np.random.default_rng(seed).normal(0.0, 1.0, n)
    scale = max(np.max(np.abs(g)), 1e-12) / 127.0
    q = np.clip(np.round(g / scale), -127, 127)
    rt = q * scale
    return float(np.sqrt(np.mean((rt - g) ** 2) / np.mean(g ** 2)))


def _bf16_rms_rel_error(n: int = 1 << 14, seed: int = 0) -> float:
    """RMS relative error of bf16 rounding (truncate fp32 to the top 16
    bits, round-to-nearest) on the same seeded gaussian tensor."""
    g = np.random.default_rng(seed).normal(0.0, 1.0, n).astype(np.float32)
    bits = g.view(np.uint32)
    rt = ((bits + 0x8000) & 0xFFFF0000).view(np.float32).astype(np.float64)
    g64 = g.astype(np.float64)
    return float(np.sqrt(np.mean((rt - g64) ** 2) / np.mean(g64 ** 2)))


# --- the tier table ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PrecisionTier:
    """One model flavour requests can be routed to.

    ``energy_kwh_per_kreq`` is the energy of serving 1000 requests on this
    tier; ``capacity_per_server`` the requests one server sustains per
    slot; ``quality`` the response-quality score in [0, 1] (fp32 = 1)."""

    name: str
    bytes_per_value: float
    energy_kwh_per_kreq: float
    quality: float
    capacity_per_server: float

    def __post_init__(self) -> None:
        if not 0.0 < self.quality <= 1.0:
            raise ValueError(f"tier {self.name!r}: quality must be in "
                             f"(0, 1], got {self.quality}")
        if self.energy_kwh_per_kreq <= 0 or self.capacity_per_server <= 0:
            raise ValueError(f"tier {self.name!r}: energy and capacity "
                             f"must be positive")


def derive_tiers(base_energy_kwh_per_kreq: float = 1.0,
                 base_capacity_per_server: float = 2500.0,
                 quality_kappa: float = 5.0) -> tuple[PrecisionTier, ...]:
    """The default fp32/bf16/int8 tier table, quality descending.

    Energy and capacity scale with bytes moved (the memory-bound decode
    argument of ``serve/decode.py``); quality is ``1 - kappa * rms_err``
    with the rms errors *measured* from the compression schemes above."""
    e_bf16, e_int8 = _bf16_rms_rel_error(), _int8_rms_rel_error()
    tiers = []
    for name, nbytes, err in (("fp32", 4.0, 0.0), ("bf16", 2.0, e_bf16),
                              ("int8", 1.0, e_int8)):
        ratio = nbytes / 4.0
        tiers.append(PrecisionTier(
            name=name, bytes_per_value=nbytes,
            energy_kwh_per_kreq=base_energy_kwh_per_kreq * ratio,
            quality=max(1.0 - quality_kappa * err, 1e-3),
            capacity_per_server=base_capacity_per_server / ratio))
    return tuple(tiers)


def mix_for_quality(qualities: np.ndarray, target: float) -> np.ndarray:
    """Fractional split over tiers (quality-descending order) whose
    fraction-weighted quality equals ``target``: the convex combination of
    the two *adjacent* tiers bracketing the target.  Adjacent pairs are
    the marginal-efficiency choice — under the byte-scaling cost model the
    cheapest grams-per-quality-point trade is always between neighbours
    (CarbonScaler-style marginal reasoning).  Targets outside the table's
    range clamp to the nearest pure tier."""
    n = len(qualities)
    frac = np.zeros(n)
    if target >= qualities[0]:
        frac[0] = 1.0
        return frac
    if target <= qualities[n - 1]:
        frac[n - 1] = 1.0
        return frac
    for i in range(n - 1):
        q_hi, q_lo = qualities[i], qualities[i + 1]
        if q_hi >= target >= q_lo:
            f = (target - q_lo) / (q_hi - q_lo)
            frac[i] = f
            frac[i + 1] = 1.0 - f
            return frac
    raise AssertionError("unreachable: qualities not sorted descending")


# --- SLO / latency model -----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SloModel:
    """Utilization -> SLO-violation-fraction map.

    A knee curve standing in for the queueing-latency tail: below
    ``knee`` utilization the fleet meets its latency SLO for every
    request; above it the violating fraction rises as
    ``((u - knee) / (1 - knee)) ** gamma`` and saturates at 1 (at u >= 1
    the fleet is overrun and every request blows the latency budget).
    Works elementwise on scalars and arrays — the engine calls it once
    per window over the whole utilization vector."""

    knee: float = 0.75
    gamma: float = 2.0

    def __post_init__(self) -> None:
        if not 0.0 < self.knee < 1.0:
            raise ValueError(f"knee must be in (0, 1), got {self.knee}")
        if self.gamma <= 0:
            raise ValueError(f"gamma must be positive, got {self.gamma}")

    def violation_frac(self, util):
        x = np.maximum((util - self.knee) / (1.0 - self.knee), 0.0)
        return np.minimum(x ** self.gamma, 1.0)


# --- quality credit ledger ---------------------------------------------------


@dataclasses.dataclass
class CreditLedger:
    """Cumulative quality credit/debt, bounded in [-1, +1] at every slot.

    Positive balance: quality served above target (credit available to
    spend on cheap tiers when carbon is high).  Negative: quality debt
    accumulated by reduced-precision serving, to be repaid when carbon is
    low.  ``gain`` converts a one-slot quality surplus/deficit into
    balance movement; the hard clip makes unbounded debt unrepresentable
    (the k8s-carbonrouter ``CreditLedger`` contract)."""

    gain: float = 0.1
    balance: float = 0.0

    def update(self, quality: float, target: float) -> float:
        b = self.balance + self.gain * (quality - target)
        self.balance = float(min(1.0, max(-1.0, b)))
        return self.balance

    def spend_headroom(self) -> float:
        """How much of the debt range is still available, in [0, 1]."""
        return (self.balance + 1.0) / 2.0

    def repay_headroom(self) -> float:
        """How much of the credit range is still available, in [0, 1]."""
        return (1.0 - self.balance) / 2.0


# --- the serving scenario config ---------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Everything a serving scenario adds to a :class:`Scenario` — trace
    shape, fleet size, tier-table knobs, SLO curve, and ledger gain.  All
    fields are JSON scalars so ``Scenario.to_dict`` round-trips it."""

    # request-trace shape (traces/requests.py)
    requests_per_day: float = 1.5e6
    diurnal: float = 0.45
    weekly: float = 0.15
    peak_hour: int = 14
    burst_rate: float = 0.01
    burst_mult: float = 3.0
    burst_mean_slots: float = 2.0
    # serving fleet + tier table (derive_tiers)
    servers: int = 48
    base_energy_kwh_per_kreq: float = 1.0
    base_capacity_per_server: float = 2500.0
    quality_kappa: float = 5.0
    # SLO + ledger
    knee: float = 0.75
    gamma: float = 2.0
    quality_target: float = 0.98
    ledger_gain: float = 0.1

    def __post_init__(self) -> None:
        if self.requests_per_day <= 0:
            raise ValueError("requests_per_day must be positive")
        if self.servers < 1:
            raise ValueError("servers must be >= 1")
        if not 0.0 < self.quality_target <= 1.0:
            raise ValueError(f"quality_target must be in (0, 1], "
                             f"got {self.quality_target}")
        if self.ledger_gain <= 0:
            raise ValueError("ledger_gain must be positive")

    def tiers(self) -> tuple[PrecisionTier, ...]:
        """The derived tier table (cached — the rms-error measurement runs
        once per config instance)."""
        cached = self.__dict__.get("_tiers")
        if cached is None:
            cached = derive_tiers(self.base_energy_kwh_per_kreq,
                                  self.base_capacity_per_server,
                                  self.quality_kappa)
            object.__setattr__(self, "_tiers", cached)
        return cached

    def slo(self) -> SloModel:
        return SloModel(knee=self.knee, gamma=self.gamma)
