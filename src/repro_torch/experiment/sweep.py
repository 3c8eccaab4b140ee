"""Cartesian experiment sweeps over ``simulate_many`` (Fig. 6-14 style).

A :class:`Sweep` expands a grid — (regions x seeds x faults x forecasts x
policies) around a base :class:`Scenario` — into :class:`SimCase` s and
dispatches them through ``simulate_many`` in a single batch: each
scenario's jobs are materialized and packed exactly once, and each
scenario's knowledge base is learned exactly once (on ``device``) and shared
read-only across its policies and fault settings.  Every cell gets a fresh
copy of its fault process, so its RNG stream is its own.  On
``engine="scan"`` the native cells of the whole grid run as batched
programs on the device slot loop; faulted cells run on the vector engine.

:class:`SweepResult` aggregates the batch: per-case rows with carbon
savings against a named baseline policy, per-policy summaries with
cross-(region, seed) dispersion, and a JSON round-trip (``to_json`` /
``from_json``) whose bytes equal the JAX package's for the same grid.

A geo base scenario (``regions``) makes the whole grid geo-distributed, a
serving base scenario (``serving``) a grid of serving cells through
``simulate_serving_many``.  ``telemetry`` records every cell's events under
its case label and brackets the profiler's phases.
"""
from __future__ import annotations

import contextlib
import csv
import dataclasses
import io
import json
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.faults import FaultProcess, fault_label  # noqa: F401  (re-export)
from repro_torch.core.forecast import ForecastModel, forecast_labels
from repro_torch.core.simulator import SimCase, simulate_many
from repro_torch.core.types import SimResult
from repro_torch.device import resolve_device
from repro_torch.serving import ServeCase, simulate_serving_many
from repro_torch.telemetry import Attribution, Telemetry, attribute

from .driver import DEFAULT_POLICIES, _fresh_faults, prepare_context
from .registry import check_scenario_policies, make_policy
from .scenario import WEEK, Scenario


@dataclasses.dataclass
class Sweep:
    """A cartesian grid of scenarios x policies, run as one batch.

    ``regions`` / ``seeds`` default to the base scenario's single values;
    ``faults`` is an explicit fault axis (``None`` entry = fault-free) —
    when omitted it defaults to the base scenario's own fault process.
    ``forecasts`` is a forecast-model axis (``None`` entry = perfect
    forecast); rows then carry a ``"forecast"`` label and savings compare
    within the same forecast model.  ``baseline`` names the policy savings
    are measured against — it is added to the run automatically if
    missing.  The base scenario's ``engine`` selects the simulation engine
    for every cell; ``backend`` is the oracle's greedy pass (learning and
    the oracle policies) and ``device`` holds the knowledge bases, the
    scan engine's slot loop and ``backend="device"``'s pass (``"cuda"`` by
    default; without a card it raises, so host callers pass ``"cpu"``).

    Geo sweeps: when the base scenario carries a ``regions`` tuple the
    whole grid is geo-distributed — the sweep's own single-region
    ``regions`` axis must stay empty (vary geo worlds via ``seeds`` or
    several sweeps), the policies must be geo policies, and the default
    baseline becomes ``geo-static``.  Row metadata joins the region tuple
    as ``"a+b"``.

    A sweep evaluates each scenario as a *single* window of ``eval_weeks``
    weeks against the initially learned knowledge base — the weekly §4.2
    re-learning loop is the driver's job (``run()``).
    """

    base: Scenario = dataclasses.field(default_factory=Scenario)
    regions: Sequence[str] = ()
    seeds: Sequence[int] = ()
    policies: Sequence[str] = DEFAULT_POLICIES
    faults: Sequence[FaultProcess | None] | None = None
    # Forecast-model grid axis: each entry replaces the base scenario's
    # `forecast` (None = PerfectForecast).  Rows gain a "forecast" label
    # column only when the axis is in play.
    forecasts: Sequence[ForecastModel | None] | None = None
    # quantile the *-robust policy variants threshold on
    forecast_quantile: float = 0.7
    baseline: str = "carbon-agnostic"
    backend: str = "numpy"
    kb_kwargs: dict | None = None
    # Observability: when set, every cell runs with this telemetry's
    # recorder/profiler attached, each under its own run label (the case
    # label), so one sweep yields one decision trace per cell plus
    # learn/provision/decide/execute phase totals.  ``None`` (the default)
    # keeps every engine on its untouched path.
    telemetry: Telemetry | None = None
    device: str | torch.device = "cuda"

    def _phase(self, name: str):
        prof = self.telemetry.profiler if self.telemetry is not None else None
        return prof.phase(name) if prof is not None else contextlib.nullcontext()

    def _labelled(self, label: str) -> Telemetry | None:
        return (self.telemetry.for_run(label) if self.telemetry is not None
                else None)

    def fault_axis(self) -> tuple[FaultProcess | None, ...]:
        if self.faults is None:
            return (self.base.faults,)
        return tuple(self.faults)

    def forecast_axis(self) -> tuple[ForecastModel | None, ...]:
        if self.forecasts is None:
            return (self.base.forecast,)
        return tuple(self.forecasts)

    def has_forecast_axis(self) -> bool:
        return self.forecasts is not None or self.base.forecast is not None

    def effective_baseline(self) -> str:
        """The status-quo policy of the grid's kind replaces the
        single-region default on geo / DAG / serving grids."""
        if self.base.is_geo and self.baseline == "carbon-agnostic":
            return "geo-static"
        if self.base.is_dag and self.baseline == "carbon-agnostic":
            return "dag-fcfs"
        if self.base.is_serving and self.baseline == "carbon-agnostic":
            return "serve-static"
        return self.baseline

    def scenarios(self) -> list[Scenario]:
        seeds = tuple(self.seeds) or (self.base.seed,)
        if self.base.is_geo:
            if tuple(self.regions):
                raise ValueError(
                    "a geo base scenario fixes the region tuple; sweep the "
                    "seeds axis (or run one sweep per region tuple) instead "
                    "of the single-region regions axis")
            bases = [dataclasses.replace(self.base, seed=s) for s in seeds]
        else:
            regions = tuple(self.regions) or (self.base.region,)
            bases = [dataclasses.replace(self.base, region=r, seed=s)
                     for r in regions for s in seeds]
        return [dataclasses.replace(b, forecast=f)
                for b in bases for f in self.forecast_axis()]

    def _policy_names(self) -> tuple[str, ...]:
        names = tuple(self.policies)
        baseline = self.effective_baseline()
        if baseline not in names:
            names = (baseline,) + names
        check_scenario_policies(names, self.base.is_geo, self.base.is_dag,
                                self.base.is_serving)
        return names

    def run(self, progress: Callable[[str], None] | None = None) -> "SweepResult":
        device = resolve_device(self.device)
        names = self._policy_names()
        baseline = self.effective_baseline()
        with_forecast = self.has_forecast_axis()
        if self.base.is_serving:
            return self._run_serving(names, baseline, with_forecast, device,
                                     progress)
        # Disambiguated per-axis-entry labels, so the per-cell savings
        # grouping below cannot merge distinct models; scenarios() expands
        # bases x forecast axis with the forecast innermost, so the labels
        # tile in order.
        axis_labels = forecast_labels(self.forecast_axis())
        scenarios = self.scenarios()
        assert not axis_labels or len(scenarios) % len(axis_labels) == 0
        cases: list[SimCase] = []
        meta: list[dict] = []
        for i, sc in enumerate(scenarios):
            with self._phase("provision"):
                mat = sc.materialize()
            region_label = "+".join(sc.regions) if sc.is_geo else sc.region
            fc_label = axis_labels[i % len(axis_labels)]
            with self._phase("learn"):
                ctx = prepare_context(mat, names, kb_kwargs=self.kb_kwargs,
                                      forecast_quantile=self.forecast_quantile,
                                      device=device, backend=self.backend)
            if progress is not None:
                progress(f"prepared {region_label}/seed{sc.seed}"
                         + (f"/{fc_label}" if with_forecast else "")
                         + f": {len(mat.eval_jobs)} eval jobs"
                         + (f", kb={len(ctx.kb)}" if ctx.kb is not None else ""))
            horizon = sc.eval_weeks * WEEK
            ci_c = mat.mci if mat.is_geo else mat.ci
            cluster_c = mat.geo if mat.is_geo else mat.cluster
            for fm in self.fault_axis():
                scf = dataclasses.replace(sc, faults=fm)
                for name in names:
                    label = (f"{region_label}/s{sc.seed}/{fault_label(fm)}"
                             f"/{name}"
                             + (f"/{fc_label}" if with_forecast else ""))
                    cases.append(SimCase(
                        jobs=mat.eval_jobs, ci=ci_c, cluster=cluster_c,
                        policy=make_policy(name, ctx), t0=mat.t0,
                        horizon=horizon, faults=_fresh_faults(scf),
                        label=label, engine=sc.engine,
                        telemetry=self._labelled(label), device=device))
                    row = {"region": region_label, "seed": sc.seed,
                           "fault": fault_label(fm), "policy": name}
                    if with_forecast:
                        row["forecast"] = fc_label
                    meta.append(row)
        results = simulate_many(cases)       # one batched dispatch
        rows = []
        for m, r in zip(meta, results):
            rows.append({**m, **r.to_dict()})
        _attach_savings(rows, baseline)
        return SweepResult(baseline=baseline, rows_=rows, results=results)

    def _run_serving(self, names, baseline: str, with_forecast: bool, device,
                     progress) -> "SweepResult":
        """Serving grids: same (regions x seeds x forecasts x policies)
        expansion, dispatched through ``simulate_serving_many`` instead of
        the batch engines.  The fault axis stays batch-only (requests are
        never suspended); Scenario validation already rejects base faults,
        so only an explicit sweep axis needs rejecting here."""
        if self.faults is not None and any(f is not None
                                           for f in self.faults):
            raise ValueError(
                "serving sweeps take no fault axis (requests are never "
                "suspended or evicted); use `forecasts` or a base "
                "`ci_outage` to stress serving policies")
        axis_labels = forecast_labels(self.forecast_axis())
        scenarios = self.scenarios()
        assert not axis_labels or len(scenarios) % len(axis_labels) == 0
        cases: list[ServeCase] = []
        meta: list[dict] = []
        for i, sc in enumerate(scenarios):
            with self._phase("provision"):
                mat = sc.materialize()
            fc_label = axis_labels[i % len(axis_labels)]
            with self._phase("learn"):
                ctx = prepare_context(mat, names, kb_kwargs=self.kb_kwargs,
                                      forecast_quantile=self.forecast_quantile,
                                      device=device, backend=self.backend)
            horizon = sc.eval_weeks * WEEK
            demand = mat.serving.demand[mat.t0: mat.t0 + horizon]
            if progress is not None:
                progress(f"prepared {sc.region}/seed{sc.seed}"
                         + (f"/{fc_label}" if with_forecast else "")
                         + f": {len(demand)} slots, "
                         f"{demand.sum() / 1e6:.2f}M requests")
            for name in names:
                label = (f"{sc.region}/s{sc.seed}/{name}"
                         + (f"/{fc_label}" if with_forecast else ""))
                cases.append(ServeCase(
                    demand=demand, rate=mat.serving.rate, ci=mat.ci,
                    config=mat.serving.config,
                    policy=make_policy(name, ctx), t0=mat.t0, label=label,
                    telemetry=self._labelled(label)))
                row = {"region": sc.region, "seed": sc.seed,
                       "fault": "none", "policy": name}
                if with_forecast:
                    row["forecast"] = fc_label
                meta.append(row)
        results = simulate_serving_many(cases)
        rows = []
        for m, r in zip(meta, results):
            rows.append({**m, **r.to_dict()})
        _attach_savings(rows, baseline)
        return SweepResult(baseline=baseline, rows_=rows, results=results)

    def to_csv(self) -> str:
        """Run the sweep and export the rows as CSV
        (:meth:`SweepResult.to_csv`)."""
        return self.run().to_csv()


def _attach_savings(rows: list[dict], baseline: str) -> None:
    def key(r: dict):
        # the "forecast" column exists only on forecast-axis sweeps;
        # savings always compare within the same forecast model
        return (r["region"], r["seed"], r["fault"], r.get("forecast", ""))

    base_carbon = {key(r): r["carbon_g"]
                   for r in rows if r["policy"] == baseline}
    for r in rows:
        base = base_carbon.get(key(r), 0.0)
        r["savings_pct"] = round(100.0 * (1.0 - r["carbon_g"] / base), 3) \
            if base > 0 else 0.0


@dataclasses.dataclass
class SweepResult:
    """Flat per-case rows + per-policy aggregates of one sweep batch.

    ``results`` holds the in-memory ``SimResult`` objects for the run that
    produced this (dropped by the JSON round-trip — rows carry everything
    the figures need)."""

    baseline: str
    rows_: list[dict]
    results: list[SimResult] | None = None

    def rows(self) -> list[dict]:
        return self.rows_

    def summary(self) -> dict[str, dict]:
        """Per-policy aggregates with cross-(region, seed, fault)
        dispersion of the savings."""
        out: dict[str, dict] = {}
        for name in dict.fromkeys(r["policy"] for r in self.rows_):
            rs = [r for r in self.rows_ if r["policy"] == name]
            sv = np.array([r["savings_pct"] for r in rs])
            out[name] = {
                "n_cases": len(rs),
                "savings_mean_pct": round(float(sv.mean()), 3),
                "savings_std_pct": round(float(sv.std()), 3),
                "savings_min_pct": round(float(sv.min()), 3),
                "savings_max_pct": round(float(sv.max()), 3),
                "mean_wait_h": round(float(np.mean([r["mean_wait"] for r in rs])), 3),
                "violation_rate": round(float(np.mean([r["violation_rate"] for r in rs])), 4),
            }
        return out

    def table(self) -> str:
        lines = [f"{'policy':18s} {'savings%':>9s} {'±std':>6s} "
                 f"{'wait h':>7s} {'viol':>6s} {'cases':>6s}"]
        for name, s in self.summary().items():
            lines.append(f"{name:18s} {s['savings_mean_pct']:9.2f} "
                         f"{s['savings_std_pct']:6.2f} {s['mean_wait_h']:7.1f} "
                         f"{s['violation_rate']:6.3f} {s['n_cases']:6d}")
        return "\n".join(lines)

    def attributions(self) -> list[Attribution]:
        """Carbon-attribution of every non-baseline cell against its
        cell's baseline run (same region/seed/fault/forecast), each
        additive to the last bit (``Attribution.check`` passes by
        construction).  Needs the in-memory ``results`` — a same-process
        run, not a JSON round-trip."""
        if self.results is None:
            raise ValueError(
                "attributions need the in-memory results; run the sweep "
                "in-process (SweepResult.from_json drops them)")

        def key(r: dict):
            return (r["region"], r["seed"], r["fault"],
                    r.get("forecast", ""))

        base = {key(r): res for r, res in zip(self.rows_, self.results)
                if r["policy"] == self.baseline}
        out = []
        for r, res in zip(self.rows_, self.results):
            if r["policy"] == self.baseline:
                continue
            b = base.get(key(r))
            if b is None:
                continue
            att = attribute(res, b)
            att.check()
            out.append(att)
        return out

    def to_json(self, indent: int | None = 1) -> str:
        return json.dumps({"baseline": self.baseline, "rows": self.rows_,
                           "summary": self.summary()}, indent=indent)

    def to_csv(self) -> str:
        """Per-case rows as CSV text, one column per row key.

        Nested dicts (``resilience``, ``serving``) flatten to dotted
        columns (``serving.violation_rate``); list values (a geo row's
        regions and per-region totals, tier names and counts) join with
        ``|`` so the payload stays one value per cell.  Columns appear in
        first-seen order across rows; rows missing a column leave the cell
        empty — so heterogeneous sweeps (a fault axis where only some rows
        carry resilience metrics) still export as one rectangular table."""

        def flat(row: dict) -> dict:
            out: dict = {}
            for k, v in row.items():
                if isinstance(v, dict):
                    for kk, vv in v.items():
                        out[f"{k}.{kk}"] = vv
                else:
                    out[k] = v
            return {k: "|".join(str(x) for x in v)
                    if isinstance(v, (list, tuple)) else v
                    for k, v in out.items()}

        flats = [flat(r) for r in self.rows_]
        cols: dict[str, None] = {}
        for f in flats:
            for k in f:
                cols.setdefault(k)
        buf = io.StringIO()
        writer = csv.DictWriter(buf, fieldnames=list(cols),
                                restval="", lineterminator="\n")
        writer.writeheader()
        writer.writerows(flats)
        return buf.getvalue()

    @classmethod
    def from_json(cls, payload: str) -> "SweepResult":
        d = json.loads(payload)
        return cls(baseline=d["baseline"], rows_=d["rows"])
