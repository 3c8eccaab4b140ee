"""The serving engine: vectorized slot loop over per-slot demand vectors.

Interactive requests cannot be suspended, so unlike the batch engine there
is no queue state — each slot the policy splits the slot's demand across
precision tiers, the engine charges carbon as energy x true CI, maps fleet
utilization through the SLO model to a violated-request fraction, and
updates the quality :class:`~repro_torch.serving.tiers.CreditLedger`.

Parity discipline: ``simulate_serving`` runs either the ``"vector"`` or the
``"scalar"`` path.  Both drive the *same* policy code and the same
sequential in-loop signals (ledger balance, cumulative policy-visible
carbon/requests — inherently serial, since each decision feeds the next);
they differ in the accounting.  The scalar reference computes every
per-slot quantity as a Python scalar inside the loop; the vector path
records only the decisions and does all accounting as bulk numpy
afterwards, with expressions chosen operation-for-operation identical
(elementwise multiply + sum, never ``dot``), so results are bit-identical,
and bit-identical to the JAX package's serving engine.

Demand is *always* per-slot binned (``traces/requests.py``): a two-week,
1.5M-requests/day trace is 336 float64 slots, so a sweep cell runs in
milliseconds on the host with zero per-request Python; nothing here runs
on the device.  ``telemetry=`` records ``forecast-read`` and
``tier-switch`` events and the ``decide``/``execute`` phases, as the JAX
package's engine does.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core.carbon import CarbonService
from repro_torch.core.types import ServingMetrics, SimResult
from repro_torch.telemetry import Telemetry

from .policies import ServeWindow
from .tiers import CreditLedger, ServingConfig


@dataclasses.dataclass
class MaterializedServing:
    """Concrete serving world resolved from ``Scenario(serving=...)``:
    the config plus the full-span realized demand and the expected-rate
    curve policies read as their demand forecast (``rate`` extends past
    the nominal span so look-ahead near the window end stays on real
    data)."""

    config: ServingConfig
    demand: np.ndarray               # realized requests per slot, full span
    rate: np.ndarray                 # expected requests per slot (forecast)


@dataclasses.dataclass
class ServeCase:
    """One serving simulation: a demand window under one policy.

    ``demand`` is the evaluation window's slice (slot ``i`` is absolute
    slot ``t0 + i``); ``rate`` stays full-span and absolute-indexed so
    policies can look ahead across the window boundary."""

    demand: np.ndarray
    rate: np.ndarray
    ci: CarbonService
    config: ServingConfig
    policy: object                   # ServeStaticPolicy / ... (duck-typed)
    t0: int = 0
    label: str = ""
    telemetry: Telemetry | None = None

    def __post_init__(self) -> None:
        self.demand = np.asarray(self.demand, dtype=np.float64)
        if self.demand.ndim != 1 or len(self.demand) < 1:
            raise ValueError("demand must be a non-empty 1-D per-slot vector")
        if self.t0 + len(self.demand) > len(self.ci.trace):
            raise ValueError(
                f"CI trace too short: window [{self.t0}, "
                f"{self.t0 + len(self.demand)}) needs "
                f"{self.t0 + len(self.demand)} slots, trace has "
                f"{len(self.ci.trace)}")


def _window(case: ServeCase, ci_pol) -> ServeWindow:
    cfg = case.config
    tiers = cfg.tiers()
    return ServeWindow(
        config=cfg, tiers=tiers,
        q_vec=np.array([t.quality for t in tiers]),
        e_vec=np.array([t.energy_kwh_per_kreq for t in tiers]),
        inv_cap=np.array([1.0 / t.capacity_per_server for t in tiers]),
        slo=cfg.slo(), ci=ci_pol, rate=case.rate, t0=case.t0,
        servers=cfg.servers)


def _serve_hooks(case: ServeCase):
    """Split the case's telemetry into (event-emitter, profiler); both
    None when telemetry is off so the hot loop pays a single branch."""
    telemetry = case.telemetry
    if telemetry is None:
        return None, None
    tele = telemetry if telemetry.recorder is not None else None
    return tele, telemetry.profiler


def _check_frac(frac: np.ndarray, policy_name: str) -> np.ndarray:
    frac = np.asarray(frac, dtype=np.float64)
    if np.any(frac < -1e-9) or abs(float(np.sum(frac)) - 1.0) > 1e-6:
        raise ValueError(f"policy {policy_name!r} returned an invalid tier "
                         f"split {frac} (must be >= 0 and sum to 1)")
    return frac


def _finalize(case: ServeCase, w: ServeWindow, fracs: np.ndarray,
              energy: np.ndarray, carbon: np.ndarray, util: np.ndarray,
              viol: np.ndarray, quality: np.ndarray,
              balance: np.ndarray) -> SimResult:
    """Reduce identical per-slot arrays to one SimResult — shared by both
    engine paths, so any parity break must come from the arrays."""
    demand = case.demand
    violated = demand * viol
    splits = fracs * demand[:, None]
    requests = float(np.sum(demand))
    q_mean = float(np.sum(quality * demand) / requests) if requests > 0 \
        else 1.0
    metrics = ServingMetrics(
        requests=requests,
        violated_requests=float(np.sum(violated)),
        quality_mean=q_mean,
        ledger_final=float(balance[-1]),
        ledger_min=float(np.min(balance)),
        ledger_max=float(np.max(balance)),
        tier_names=tuple(t.name for t in w.tiers),
        tier_requests=tuple(float(x) for x in np.sum(splits, axis=0)),
        balance=balance, utilization=util, quality=quality,
        violation_frac=viol, energy=energy, carbon=carbon)
    name = getattr(case.policy, "name", "serve")
    return SimResult(
        policy=name, carbon_g=float(np.sum(carbon)),
        energy_kwh=float(np.sum(energy)), slots=[],
        wait_slots=np.zeros(0), violations=np.zeros(0, dtype=bool),
        completion=np.zeros(0, dtype=np.int64), num_jobs=0,
        serving=metrics)


def _run_scalar(case: ServeCase) -> SimResult:
    """Reference path: every per-slot quantity a Python scalar in-loop."""
    cfg = case.config
    ci_pol = case.ci.degraded()
    w = _window(case, ci_pol)
    case.policy.on_window_start(w)
    tele, prof = _serve_hooks(case)
    prev_tier = -1
    ledger = CreditLedger(gain=cfg.ledger_gain)
    T = len(case.demand)
    n = len(w.tiers)
    fracs = np.zeros((T, n))
    energy, carbon, util, viol, quality, balance = \
        (np.zeros(T) for _ in range(6))
    cum_carbon = 0.0
    cum_requests = 0.0
    for i in range(T):
        t = case.t0 + i
        d = float(case.demand[i])
        if tele is not None and ci_pol is not case.ci:
            tele.emit(t, "forecast-read", value=float(ci_pol.staleness(t)))
        if prof is not None:
            _pt = time.perf_counter()
        frac = _check_frac(
            case.policy.decide(t, d, ledger.balance, cum_carbon,
                               cum_requests),
            getattr(case.policy, "name", "serve"))
        if prof is not None:
            _now = time.perf_counter()
            prof.add("decide", _now - _pt)
            _pt = _now
        if tele is not None:
            tier = int(np.argmax(frac))
            if tier != prev_tier and prev_tier >= 0:
                tele.emit(t, "tier-switch", value=float(tier),
                          detail=f"from={prev_tier}")
            prev_tier = tier
        q_t = float(np.sum(frac * w.q_vec))
        e_t = float(np.sum(frac * w.e_vec)) * (d / 1000.0)
        u_t = float(np.sum(frac * w.inv_cap)) * (d / w.servers)
        fracs[i] = frac
        energy[i] = e_t
        carbon[i] = e_t * case.ci.ci(t)
        util[i] = u_t
        viol[i] = float(w.slo.violation_frac(u_t))
        quality[i] = q_t
        balance[i] = ledger.update(q_t, cfg.quality_target)
        # the policy-visible running totals read the *degraded* CI view —
        # a policy must not learn the true CI through its budget signal
        cum_carbon = cum_carbon + e_t * ci_pol.ci(t)
        cum_requests = cum_requests + d
        if prof is not None:
            prof.add("execute", time.perf_counter() - _pt)
    return _finalize(case, w, fracs, energy, carbon, util, viol, quality,
                     balance)


def _run_vector(case: ServeCase) -> SimResult:
    """Fast path: the loop records only the sequential state (decisions,
    ledger, policy-visible totals); all accounting is bulk numpy."""
    cfg = case.config
    ci_pol = case.ci.degraded()
    w = _window(case, ci_pol)
    case.policy.on_window_start(w)
    tele, prof = _serve_hooks(case)
    prev_tier = -1
    ledger = CreditLedger(gain=cfg.ledger_gain)
    T = len(case.demand)
    fracs = np.zeros((T, len(w.tiers)))
    quality = np.zeros(T)
    balance = np.zeros(T)
    cum_carbon = 0.0
    cum_requests = 0.0
    for i in range(T):
        t = case.t0 + i
        d = float(case.demand[i])
        if tele is not None and ci_pol is not case.ci:
            tele.emit(t, "forecast-read", value=float(ci_pol.staleness(t)))
        if prof is not None:
            _pt = time.perf_counter()
        frac = _check_frac(
            case.policy.decide(t, d, ledger.balance, cum_carbon,
                               cum_requests),
            getattr(case.policy, "name", "serve"))
        if prof is not None:
            _now = time.perf_counter()
            prof.add("decide", _now - _pt)
            _pt = _now
        if tele is not None:
            tier = int(np.argmax(frac))
            if tier != prev_tier and prev_tier >= 0:
                tele.emit(t, "tier-switch", value=float(tier),
                          detail=f"from={prev_tier}")
            prev_tier = tier
        fracs[i] = frac
        q_t = float(np.sum(frac * w.q_vec))
        quality[i] = q_t
        balance[i] = ledger.update(q_t, cfg.quality_target)
        cum_carbon = cum_carbon + \
            float(np.sum(frac * w.e_vec)) * (d / 1000.0) * ci_pol.ci(t)
        cum_requests = cum_requests + d
        if prof is not None:
            prof.add("execute", time.perf_counter() - _pt)
    demand = case.demand
    if prof is not None:
        _pt = time.perf_counter()
    energy = (fracs * w.e_vec).sum(axis=1) * (demand / 1000.0)
    ci_true = np.array([case.ci.ci(case.t0 + i) for i in range(T)])
    carbon = energy * ci_true
    util = (fracs * w.inv_cap).sum(axis=1) * (demand / w.servers)
    viol = w.slo.violation_frac(util)
    if prof is not None:
        prof.add("execute", time.perf_counter() - _pt)
    return _finalize(case, w, fracs, energy, carbon, util, viol, quality,
                     balance)


def simulate_serving(case: ServeCase, engine: str = "vector",
                     telemetry: Telemetry | None = None) -> SimResult:
    """Run one serving case; ``engine`` picks the vector path (default) or
    the scalar reference (bit-identical, for parity tests).  ``telemetry``
    attaches a recorder/profiler without rebuilding the case."""
    if telemetry is not None:
        case = dataclasses.replace(case, telemetry=telemetry)
    if engine == "vector":
        return _run_vector(case)
    if engine == "scalar":
        return _run_scalar(case)
    raise ValueError(f"unknown serving engine {engine!r}; "
                     f"use 'vector' or 'scalar'")


def simulate_serving_many(cases, engine: str = "vector") -> list[SimResult]:
    """Batch dispatch, mirroring ``simulate_many`` for the sweep layer."""
    return [simulate_serving(c, engine=engine) for c in cases]
