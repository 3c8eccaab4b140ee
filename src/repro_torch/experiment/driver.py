"""The experiment driver: one call from ``Scenario`` to per-policy results.

``run()`` owns the continuous-learning loop of §4.2: replay the historical
weeks through the offline oracle into a rolling :class:`KnowledgeBase`
(one replay offset per week), construct every requested policy through the
registry, evaluate each week through ``simulate_many`` (jobs packed once
per week), then re-learn on the week just evaluated and warm-start
history-driven policies before the next — the violation-feedback loop of
Algorithm 2 running inside the policies across the whole span.

The knowledge base lives on ``device`` (``"cuda"`` by default), where the
execution phase's lookups run as CUDA kernels, and so does the slot loop of
``engine="scan"`` scenarios and, with ``backend="device"``, the oracle's
greedy pass; everything else is host numpy.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import oracle
from repro_torch.core.knowledge import KnowledgeBase
from repro_torch.core.policy import learn_window
from repro_torch.core.simulator import SimCase, simulate_many
from repro_torch.core.types import SimResult
from repro_torch.device import resolve_device
from repro_torch.serving import ServeCase, simulate_serving_many
from repro_torch.telemetry import Telemetry

from .registry import (PolicyContext, check_scenario_policies, get_spec,
                       make_policy, needs_kb)
from .scenario import WEEK, MaterializedScenario, Scenario

#: The §6.1 comparison set (VCC joins only in the Fig. 14 interop study).
DEFAULT_POLICIES: tuple[str, ...] = (
    "carbon-agnostic", "gaia", "wait-awhile", "carbonscaler",
    "carbonflex", "carbonflex-mpc", "oracle",
)

#: The geo-distributed comparison set (scenarios with a ``regions`` axis).
DEFAULT_GEO_POLICIES: tuple[str, ...] = (
    "geo-static", "geo-greedy", "geo-flex",
)

#: The precedence-aware comparison set (scenarios with a DAG workload).
DEFAULT_DAG_POLICIES: tuple[str, ...] = (
    "dag-fcfs", "dag-carbon", "dag-cap",
)

#: The request-serving comparison set (scenarios with a serving workload).
DEFAULT_SERVE_POLICIES: tuple[str, ...] = (
    "serve-static", "serve-greedy", "serve-flex",
)


def prepare_context(
    mat: MaterializedScenario,
    policies: Sequence[str],
    kb_kwargs: dict | None = None,
    forecast_quantile: float = 0.7,
    device: str | torch.device = "cuda",
    backend: str = "numpy",
) -> PolicyContext:
    """Build the :class:`PolicyContext` for a materialized scenario,
    running the initial learning phase when any requested policy needs the
    knowledge base (held on ``device``).  ``forecast_quantile`` is the band
    the ``*-robust`` policy variants threshold on; ``backend`` is the
    oracle's greedy pass, for the learning phase and the oracle policy."""
    kb = None
    if needs_kb(policies):
        kb = KnowledgeBase(device=device, **(kb_kwargs or {}))
        learn_window(kb, mat.hist, mat.ci, 0, WEEK, mat.cluster,
                     offsets=mat.scenario.learn_offsets(), backend=backend)
    return PolicyContext(
        cluster=mat.cluster, ci=mat.ci, history=list(mat.hist),
        mean_length=mat.mean_length, utilization=mat.scenario.utilization,
        kb=kb, backend=backend, device=device, mci=mat.mci, geo=mat.geo,
        forecast_quantile=forecast_quantile, mpc=mat.scenario.mpc)


def _fresh_faults(scenario: Scenario):
    """Fault injection is stateful (seeded RNG stream) — every simulation
    case gets its own instance reset to the configured seed."""
    if scenario.faults is None:
        return None
    return dataclasses.replace(scenario.faults)


@dataclasses.dataclass
class ExperimentResult:
    """Per-policy results of one scenario run (one ``SimResult`` per
    evaluated week, aggregates over the whole span).  ``learn_s`` and
    ``execute_s`` split ``runtime_s`` into the learning phase (oracle
    replays into the knowledge base) and the execution phase (the engines'
    slot loops, knowledge-base lookups included)."""

    scenario: Scenario
    policies: tuple[str, ...]
    weekly: dict[str, list[SimResult]]
    kb_size: int
    runtime_s: float
    learn_s: float = 0.0
    execute_s: float = 0.0

    # --- aggregates ---------------------------------------------------------

    def carbon_g(self, policy: str) -> float:
        return float(sum(r.carbon_g for r in self.weekly[policy]))

    def energy_kwh(self, policy: str) -> float:
        return float(sum(r.energy_kwh for r in self.weekly[policy]))

    def _pooled(self, policy: str) -> SimResult:
        """The evaluated weeks of ``policy`` as one result: totals summed,
        per-job arrays concatenated in week order (no slot log), so the
        aggregates below are ``SimResult``'s own accounting."""
        rs = self.weekly[policy]

        def cat(name, dtype):
            return (np.concatenate([getattr(r, name) for r in rs]) if rs
                    else np.zeros(0, dtype=dtype))

        return SimResult(
            policy=policy, carbon_g=self.carbon_g(policy),
            energy_kwh=self.energy_kwh(policy), slots=[],
            wait_slots=cat("wait_slots", np.float64),
            violations=cat("violations", bool),
            completion=cat("completion", np.int64),
            num_jobs=sum(r.num_jobs for r in rs))

    def mean_wait(self, policy: str) -> float:
        return self._pooled(policy).mean_wait

    def violation_rate(self, policy: str) -> float:
        rs = self.weekly[policy]
        if rs and rs[0].serving is not None:
            # serving runs: request-weighted SLO-violation rate
            req = sum(r.serving.requests for r in rs)
            if req <= 0:
                return 0.0
            return float(sum(r.serving.violated_requests for r in rs) / req)
        return self._pooled(policy).violation_rate

    def quality_mean(self, policy: str) -> float:
        """Request-weighted served quality (serving runs; 1.0 otherwise)."""
        rs = self.weekly[policy]
        if not rs or rs[0].serving is None:
            return 1.0
        req = sum(r.serving.requests for r in rs)
        if req <= 0:
            return 1.0
        return float(sum(r.serving.quality_mean * r.serving.requests
                         for r in rs) / req)

    def savings(self, policy: str, baseline: str | None = None) -> float:
        """Carbon savings (%) of ``policy`` vs ``baseline`` in this run
        (default: carbon-agnostic, or geo-static on geo runs)."""
        baseline = self._baseline(baseline)
        if baseline is None:
            return 0.0
        base = self.carbon_g(baseline)
        if base <= 0:
            return 0.0
        return 100.0 * (1.0 - self.carbon_g(policy) / base)

    # --- presentation -------------------------------------------------------

    def _baseline(self, baseline: str | None) -> str | None:
        """Resolve the comparison baseline: an explicit name must be part
        of the run (typos raise); the default is the status-quo policy of
        the run's kind (carbon-agnostic, geo-static, dag-fcfs,
        serve-static), or None when none of them ran."""
        if baseline is not None:
            if baseline not in self.weekly:
                raise KeyError(
                    f"baseline {baseline!r} was not part of this run; "
                    f"policies: {', '.join(self.weekly)}")
            return baseline
        for cand in ("carbon-agnostic", "geo-static", "dag-fcfs",
                     "serve-static"):
            if cand in self.weekly:
                return cand
        return None

    def metrics(self, baseline: str | None = None) -> dict[str, dict]:
        """Per-policy metric dicts."""
        base = self._baseline(baseline)
        out = {}
        for name in self.policies:
            m = {
                "carbon_g": self.carbon_g(name),
                "energy_kwh": self.energy_kwh(name),
                "mean_wait_h": self.mean_wait(name),
                "violation_rate": self.violation_rate(name),
            }
            rs = self.weekly[name]
            if rs and rs[0].serving is not None:
                m["quality_mean"] = round(self.quality_mean(name), 5)
                m["ledger_final"] = round(rs[-1].serving.ledger_final, 4)
            if base:
                m["savings_pct"] = round(self.savings(name, base), 2)
            out[name] = m
        return out

    def table(self, baseline: str | None = None) -> str:
        """Human-readable comparison table (the quickstart report)."""
        base = self._baseline(baseline)
        lines = [f"{'policy':18s} {'carbon kg':>10s} {'savings':>8s} "
                 f"{'wait h':>7s} {'viol':>6s}"]
        for name in self.policies:
            sv = f"{self.savings(name, base):7.1f}%" if base else " " * 8
            lines.append(
                f"{name:18s} {self.carbon_g(name) / 1e3:10.1f} {sv} "
                f"{self.mean_wait(name):7.1f} {self.violation_rate(name):6.3f}")
        return "\n".join(lines)

    def to_dict(self, baseline: str | None = None) -> dict:
        return {
            "scenario": self.scenario.to_dict(),
            "kb_size": self.kb_size,
            "runtime_s": round(self.runtime_s, 3),
            "policies": self.metrics(baseline),
        }


def run(
    scenario: Scenario,
    policies: Sequence[str] | None = None,
    *,
    kb_kwargs: dict | None = None,
    forecast_quantile: float = 0.7,
    device: str | torch.device = "cuda",
    backend: str = "numpy",
    progress: Callable[[str], None] | None = None,
    telemetry: Telemetry | None = None,
) -> ExperimentResult:
    """Run ``scenario`` under the named policies (registry names).

    Evaluation week by week: simulate all policies on the week's arrivals
    (one ``simulate_many`` dispatch — the week's jobs are packed once and
    shared across policies), then fold the week back into the rolling
    knowledge base for the next.  ``kb_kwargs`` forwards to
    :class:`KnowledgeBase` (e.g. ``max_windows`` for the aging window,
    feature weights for tuning studies).  ``device`` holds the knowledge
    base and runs the slot loop of ``engine="scan"``; without a CUDA device
    the default raises.  ``backend`` is the oracle's greedy pass for the
    learning phase, the weekly re-learning and the oracle policy
    (``oracle.BACKENDS``; ``"device"`` runs it on ``device``, the port's
    name for the JAX package's ``backend="jax"``).  ``policies`` defaults
    to the geo family on geo scenarios, the DAG family on DAG scenarios and
    the serve family on serving scenarios.  A scenario's fault process runs
    as a fresh copy in every case (its RNG stream re-seeded per case).
    ``progress`` gets one line per evaluated week.  ``telemetry`` attaches
    a decision-trace recorder and/or phase profiler: every engine dispatch
    records under a ``"{policy}/w{week}"`` run label, and the learning and
    materialisation here bracket the profiler's ``learn``/``provision``
    phases.  The default ``None`` leaves every engine on its untouched
    path.
    """
    device = resolve_device(device)
    if backend not in oracle.BACKENDS:
        raise ValueError(f"unknown oracle backend {backend!r}; use one of "
                         f"{', '.join(oracle.BACKENDS)}")
    if policies is None:
        policies = (DEFAULT_GEO_POLICIES if scenario.is_geo
                    else DEFAULT_DAG_POLICIES if scenario.is_dag
                    else DEFAULT_SERVE_POLICIES if scenario.is_serving
                    else DEFAULT_POLICIES)
    names = tuple(policies)
    # unknown names raise too
    check_scenario_policies(names, scenario.is_geo, scenario.is_dag,
                            scenario.is_serving)
    prof = telemetry.profiler if telemetry is not None else None

    def phase(name: str):
        return prof.phase(name) if prof is not None else contextlib.nullcontext()

    def label(name: str, week: int) -> Telemetry | None:
        return (telemetry.for_run(f"{name}/w{week}") if telemetry is not None
                else None)

    t_start = time.perf_counter()
    with phase("provision"):
        mat = scenario.materialize()
    t_learn = time.perf_counter()
    with phase("learn"):
        ctx = prepare_context(mat, names, kb_kwargs=kb_kwargs,
                              forecast_quantile=forecast_quantile,
                              device=device, backend=backend)
    learn_s = time.perf_counter() - t_learn
    execute_s = 0.0
    instances = {n: make_policy(n, ctx) for n in names}
    weekly: dict[str, list[SimResult]] = {n: [] for n in names}

    if scenario.is_serving:
        # Serving evaluation: week-sliced demand through the serving
        # engine (no learning loop — there is no knowledge base to roll;
        # each week starts a fresh ledger, the debt/credit carry being a
        # per-window contract).
        t_exec = time.perf_counter()
        for w in range(scenario.eval_weeks):
            t0 = mat.t0 + w * WEEK
            cases = [ServeCase(demand=mat.serving.demand[t0: t0 + WEEK],
                               rate=mat.serving.rate, ci=mat.ci,
                               config=mat.serving.config,
                               policy=instances[n], t0=t0, label=n,
                               telemetry=label(n, w))
                     for n in names]
            for n, res in zip(names, simulate_serving_many(cases)):
                weekly[n].append(res)
            if progress is not None:
                agg = {n: sum(r.carbon_g for r in weekly[n]) for n in names}
                base = agg.get("serve-static")
                parts = [f"week {w + 1}/{scenario.eval_weeks}"]
                if base:
                    parts += [f"{n}={100 * (1 - c / base):.1f}%"
                              for n, c in agg.items() if n != "serve-static"]
                progress("  ".join(parts))
        return ExperimentResult(
            scenario=scenario, policies=names, weekly=weekly, kb_size=0,
            runtime_s=time.perf_counter() - t_start, learn_s=learn_s,
            execute_s=time.perf_counter() - t_exec)

    for w in range(scenario.eval_weeks):
        t0 = mat.t0 + w * WEEK
        if w > 0:
            # continuous learning: replay the week just evaluated
            prev = [j for j in mat.jobs if t0 - WEEK <= j.arrival < t0]
            t_learn = time.perf_counter()
            if ctx.kb is not None:
                with phase("learn"):
                    learn_window(ctx.kb, mat.jobs, mat.ci, 0, WEEK,
                                 mat.cluster, offsets=(t0 - WEEK,),
                                 backend=backend)
            for n in names:
                if get_spec(n).needs_history and prev:
                    instances[n].warm_start(prev)
            learn_s += time.perf_counter() - t_learn
        ev = mat.eval_week(w)
        if not ev:
            continue
        ci_w = mat.mci if mat.is_geo else mat.ci
        cluster_w = mat.geo if mat.is_geo else mat.cluster
        cases = [SimCase(jobs=ev, ci=ci_w, cluster=cluster_w,
                         policy=instances[n], t0=t0, horizon=WEEK,
                         faults=_fresh_faults(scenario), label=n,
                         engine=scenario.engine, telemetry=label(n, w),
                         device=device)
                 for n in names]
        t_exec = time.perf_counter()
        for n, res in zip(names, simulate_many(cases)):
            weekly[n].append(res)
        execute_s += time.perf_counter() - t_exec
        if progress is not None:
            agg = {n: sum(r.carbon_g for r in weekly[n]) for n in names}
            base = agg.get("carbon-agnostic")
            parts = [f"week {w + 1}/{scenario.eval_weeks}"]
            if ctx.kb is not None:
                parts.append(f"kb={len(ctx.kb)} cases")
            if base:
                parts += [f"{n}={100 * (1 - c / base):.1f}%"
                          for n, c in agg.items() if n != "carbon-agnostic"]
            progress("  ".join(parts))

    return ExperimentResult(
        scenario=scenario, policies=names, weekly=weekly,
        kb_size=len(ctx.kb) if ctx.kb is not None else 0,
        runtime_s=time.perf_counter() - t_start,
        learn_s=learn_s, execute_s=execute_s)
