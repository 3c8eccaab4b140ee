"""Seeded diurnal request-trace generator for the serving tier.

Interactive traffic differs from the batch workloads in ``workloads.py`` in
one structural way: requests are far too numerous to simulate individually
(millions per day), and far too short to suspend.  The generator therefore
never materialises a request — it produces a **per-slot demand vector**
(requests arriving in each hourly slot), which is the unit the serving
engine's hot loop is vectorized over.

Shape model (web-traffic stylised facts):

- a sinusoidal daily curve peaking at ``peak_hour`` local time
  (``diurnal`` amplitude — the day/night swing of consumer traffic);
- a weekly modulation (``weekly`` fractional weekend dip);
- Poisson arrivals around the shaped rate (one vectorized draw per trace,
  never per-request Python);
- burst spikes: seeded slot-level events (rate ``burst_rate`` per slot)
  that multiply demand by ``burst_mult`` for a geometric-length window —
  the flash-crowd tail the SLO model has to absorb.
"""
from __future__ import annotations

import numpy as np


def expected_request_rate(
    hours: int,
    requests_per_day: float,
    *,
    diurnal: float = 0.45,
    weekly: float = 0.15,
    peak_hour: int = 14,
) -> np.ndarray:
    """Deterministic expected requests-per-slot curve (no noise, no
    bursts): the daily sinusoid x weekly modulation around the base rate.

    This doubles as the *demand forecast* the serving policies read — the
    realized trace (:func:`generate_request_demand`) adds Poisson noise
    and burst spikes on top, so a policy planning on this curve faces
    genuine demand-forecast error at the spikes."""
    if hours < 1:
        raise ValueError(f"hours must be >= 1, got {hours}")
    if requests_per_day <= 0:
        raise ValueError(f"requests_per_day must be positive, "
                         f"got {requests_per_day}")
    t = np.arange(hours, dtype=np.float64)
    hod = t % 24
    dow = (t // 24) % 7
    base = requests_per_day / 24.0
    rate = base * (1.0 + diurnal * np.cos(2 * np.pi * (hod - peak_hour) / 24.0))
    rate = rate * np.where(dow >= 5, 1.0 - weekly, 1.0)
    return np.maximum(rate, 0.0)


def generate_request_demand(
    hours: int,
    requests_per_day: float,
    seed: int = 0,
    *,
    diurnal: float = 0.45,
    weekly: float = 0.15,
    peak_hour: int = 14,
    burst_rate: float = 0.01,
    burst_mult: float = 3.0,
    burst_mean_slots: float = 2.0,
) -> np.ndarray:
    """Seeded realized demand vector: ``(hours,)`` float64 request counts.

    Poisson arrivals around :func:`expected_request_rate`, with burst
    windows (start probability ``burst_rate`` per slot, geometric duration
    of mean ``burst_mean_slots``) multiplying the rate by ``burst_mult``.
    Overlapping bursts take the max multiplier, not the product — a flash
    crowd during a flash crowd is still one flash crowd.

    Everything is vectorized over slots (one rng.poisson over the whole
    lambda vector); the only Python loop is over burst *starts* (a handful
    per trace), never over requests or slots."""
    rate = expected_request_rate(hours, requests_per_day, diurnal=diurnal,
                                 weekly=weekly, peak_hour=peak_hour)
    rng = np.random.default_rng(np.random.SeedSequence([seed, hours]))
    mult = np.ones(hours)
    if burst_rate > 0 and burst_mult > 1.0:
        starts = np.nonzero(rng.random(hours) < burst_rate)[0]
        if len(starts):
            durations = rng.geometric(1.0 / max(burst_mean_slots, 1.0),
                                      len(starts))
            for s, d in zip(starts, durations):
                end = min(int(s) + int(d), hours)
                mult[s:end] = np.maximum(mult[s:end], burst_mult)
    return rng.poisson(rate * mult).astype(np.float64)
