"""Oracle-gap harness: how far is each policy from the oracle, and how
fast does it degrade as forecast error grows?

The paper's headline robustness claim is that continuous learning keeps
CarbonFlex "within ~2% of an oracle scheduler with perfect knowledge of
future carbon intensity and job length" (§6).  This harness measures that
gap directly and extends it along the forecast-error axis the paper does
not evaluate:

- for every grid cell (region x seed x fault x forecast model) it runs
  the requested policies *plus the oracle* (which reads the true trace,
  so it is forecast-independent by construction) against the same
  baseline;
- the **oracle gap** of a policy in a cell is
  ``oracle_savings_pct - policy_savings_pct`` (percentage points of
  baseline carbon left on the table);
- the **degradation curve** is the mean gap per forecast model, in the
  order the forecast axis was given (typically a sigma ladder: perfect,
  then AR(1) noise of growing sigma).

Usage::

    from repro_torch.experiment.oracle_gap import OracleGap, sigma_ladder

    res = OracleGap(base=Scenario(capacity=40), seeds=(1, 2, 3),
                    forecasts=sigma_ladder((0.0, 0.1, 0.2, 0.4))).run()
    print(res.table())
    res.degradation_curve("carbonflex")   # [(label, mean_gap_pp), ...]

The grid runs on ``device`` (``"cuda"`` by default: the knowledge bases,
the scan engine's slot loop); host callers pass ``device="cpu"``.  Its
rows and JSON equal the JAX package's harness on the same grid.

CLI: ``PYTHONPATH=src python -m repro_torch.experiment.oracle_gap
[--tiny | --smoke] [--device cpu]``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.forecast import (ForecastModel, NoisyForecast,
                                       QuantileForecast, forecast_labels)
from repro_torch.telemetry import attribute

from .scenario import Scenario
from .sweep import Sweep

#: Policies whose oracle gap the §Forecast study tracks: the learned
#: CarbonFlex pipeline (greedy, MPC, and marginal-capacity scale-up
#: variants) and the threshold baseline, each side with its
#: quantile-robust variant.
DEFAULT_GAP_POLICIES: tuple[str, ...] = (
    "carbonflex", "carbonflex-mpc", "carbonflex-scale",
    "carbonflex-robust", "wait-awhile", "wait-awhile-robust",
)


def sigma_ladder(sigmas: Sequence[float] = (0.0, 0.1, 0.2, 0.4),
                 kind: str = "noisy", seed: int = 0,
                 **kw) -> tuple[ForecastModel | None, ...]:
    """A forecast-error ladder for the degradation curve: ``sigma == 0``
    is the perfect forecast (``None``), the rest AR(1) ``noisy`` or
    ensemble ``quantile`` models of growing sigma."""
    if kind not in ("noisy", "quantile"):
        raise ValueError(f"kind must be 'noisy' or 'quantile', got {kind!r}")
    cls = NoisyForecast if kind == "noisy" else QuantileForecast
    return tuple(None if s == 0 else cls(sigma=s, seed=seed, **kw)
                 for s in sigmas)


@dataclasses.dataclass
class OracleGap:
    """Declarative oracle-gap study: a :class:`Sweep` over a forecast
    ladder with the oracle added, reduced to per-cell gaps."""

    base: Scenario = dataclasses.field(default_factory=Scenario)
    policies: Sequence[str] = DEFAULT_GAP_POLICIES
    forecasts: Sequence[ForecastModel | None] = \
        dataclasses.field(default_factory=sigma_ladder)
    regions: Sequence[str] = ()
    seeds: Sequence[int] = ()
    baseline: str = "carbon-agnostic"
    backend: str = "numpy"
    # quantile the *-robust policy variants threshold on
    forecast_quantile: float = 0.7
    # Simulation engine for the grid.  The study defaults to "scan" so the
    # scan-native policies (carbonflex-mpc / carbonflex-scale / the
    # threshold baselines) run as batched programs on the device slot
    # loop; cells that are not scan-native (the oracles, carbonflex
    # itself) delegate to the vector engine, which the scan batch logs
    # once per dispatch.
    engine: str = "scan"
    # Also run the oracle on the *learned* length estimates
    # ("oracle-estimated") and report both gaps — the gap to the true
    # oracle (perfect lengths) and the gap to the estimated oracle.  The
    # spread between the two is the price of length-estimation error,
    # separated from scheduling-decision error.
    include_estimated: bool = True
    # where the grid runs (knowledge bases, the scan engine's slot loop)
    device: str | torch.device = "cuda"

    def sweep(self) -> Sweep:
        names = tuple(self.policies)
        if "oracle" not in names:
            names = names + ("oracle",)
        if self.include_estimated and "oracle-estimated" not in names:
            names = names + ("oracle-estimated",)
        base = self.base
        if base.engine != self.engine:
            base = dataclasses.replace(base, engine=self.engine)
        return Sweep(base=base, regions=self.regions, seeds=self.seeds,
                     policies=names, forecasts=tuple(self.forecasts),
                     forecast_quantile=self.forecast_quantile,
                     baseline=self.baseline, backend=self.backend,
                     device=self.device)

    def run(self, progress: Callable[[str], None] | None = None
            ) -> "OracleGapResult":
        sweep = self.sweep()
        res = sweep.run(progress=progress)
        rows = res.rows()
        cell = lambda r: (r["region"], r["seed"], r["fault"], r["forecast"])  # noqa: E731
        oracle_sv = {cell(r): r["savings_pct"]
                     for r in rows if r["policy"] == "oracle"}
        est_sv = {cell(r): r["savings_pct"]
                  for r in rows if r["policy"] == "oracle-estimated"}
        # per-cell SimResults, for attributing each gap by cause
        sims = {(cell(r), r["policy"]): s
                for r, s in zip(res.rows_, res.results or ())}
        base_c = {cell(r): s.carbon_g
                  for r, s in zip(res.rows_, res.results or ())
                  if r["policy"] == res.baseline}
        gap_rows = []
        for r in rows:
            if r["policy"] == "oracle":
                continue
            row = {
                "region": r["region"], "seed": r["seed"], "fault": r["fault"],
                "forecast": r["forecast"], "policy": r["policy"],
                "savings_pct": r["savings_pct"],
                "oracle_savings_pct": oracle_sv[cell(r)],
                "gap_pp": round(oracle_sv[cell(r)] - r["savings_pct"], 3),
            }
            # the second gap of the S1 "both gaps" report: distance to the
            # oracle that only knows the learned length estimates — what a
            # policy could still gain from better *decisions* alone
            if r["policy"] != "oracle-estimated" and cell(r) in est_sv:
                row["est_oracle_savings_pct"] = est_sv[cell(r)]
                row["est_gap_pp"] = round(
                    est_sv[cell(r)] - r["savings_pct"], 3)
            # Attribute the gap itself: the oracle "vs the policy as
            # baseline" decomposes the grams the oracle saves on top into
            # named causes — capacity_scaling is provisioning-phase loss,
            # temporal_shifting execution-phase loss.  In pp of the sweep
            # baseline's carbon, the same unit as gap_pp.
            orc = sims.get((cell(r), "oracle"))
            pol = sims.get((cell(r), r["policy"]))
            bc = base_c.get(cell(r), 0.0)
            if orc is not None and pol is not None and bc > 0:
                att = attribute(orc, pol)
                att.check()
                row["gap_attribution_pp"] = {
                    c: round(100.0 * v / bc, 3)
                    for c, v in att.causes.items() if v != 0.0}
            gap_rows.append(row)
        # the same disambiguated labels Sweep stamps on the rows;
        # dict.fromkeys dedupes (equal models only) while keeping order
        order = forecast_labels(self.forecasts)
        return OracleGapResult(baseline=sweep.effective_baseline(),
                               forecast_order=list(dict.fromkeys(order)),
                               rows_=gap_rows)


@dataclasses.dataclass
class OracleGapResult:
    """Per-cell gap rows + their aggregates per forecast and policy."""

    baseline: str
    forecast_order: list[str]
    rows_: list[dict]

    def rows(self) -> list[dict]:
        return self.rows_

    def policies(self) -> list[str]:
        return list(dict.fromkeys(r["policy"] for r in self.rows_))

    def summary(self) -> dict[str, dict[str, dict]]:
        """``{forecast_label: {policy: {savings/gap mean +- std}}}`` in
        ladder order.  Cached: the rows are immutable after ``run()``,
        and table()/curves/to_json all reduce over the same aggregates."""
        cached = self.__dict__.get("_summary")
        if cached is not None:
            return cached
        out: dict[str, dict[str, dict]] = {}
        for fc in self.forecast_order:
            out[fc] = {}
            for pol in self.policies():
                rs = [r for r in self.rows_
                      if r["forecast"] == fc and r["policy"] == pol]
                if not rs:
                    continue
                sv = np.array([r["savings_pct"] for r in rs])
                gap = np.array([r["gap_pp"] for r in rs])
                out[fc][pol] = {
                    "n_cases": len(rs),
                    "savings_mean_pct": round(float(sv.mean()), 3),
                    "savings_std_pct": round(float(sv.std()), 3),
                    "gap_mean_pp": round(float(gap.mean()), 3),
                    "gap_std_pp": round(float(gap.std()), 3),
                }
                est = [r["est_gap_pp"] for r in rs if "est_gap_pp" in r]
                if est:
                    out[fc][pol]["est_gap_mean_pp"] = round(
                        float(np.mean(est)), 3)
                atts = [r["gap_attribution_pp"] for r in rs
                        if "gap_attribution_pp" in r]
                if atts:
                    causes = sorted({c for a in atts for c in a})
                    out[fc][pol]["gap_attribution_mean_pp"] = {
                        c: round(float(np.mean([a.get(c, 0.0)
                                                for a in atts])), 3)
                        for c in causes}
        self._summary = out
        return out

    def perfect_gap(self, policy: str) -> float:
        """Mean gap-to-oracle (pp) under the perfect forecast — the
        paper's ~2% claim, measured."""
        return self.summary()["perfect"][policy]["gap_mean_pp"]

    def degradation_curve(self, policy: str) -> list[tuple[str, float]]:
        """``[(forecast_label, mean_gap_pp), ...]`` in ladder order."""
        s = self.summary()
        return [(fc, s[fc][policy]["gap_mean_pp"])
                for fc in self.forecast_order if policy in s[fc]]

    def table(self) -> str:
        lines = [f"{'forecast':22s} {'policy':20s} {'savings%':>9s} "
                 f"{'gap pp':>7s} {'±std':>6s} {'est pp':>7s} {'cases':>6s}"]
        for fc, pols in self.summary().items():
            for pol, s in pols.items():
                est = (f"{s['est_gap_mean_pp']:7.2f}"
                       if "est_gap_mean_pp" in s else " " * 7)
                lines.append(
                    f"{fc:22s} {pol:20s} {s['savings_mean_pct']:9.2f} "
                    f"{s['gap_mean_pp']:7.2f} {s['gap_std_pp']:6.2f} "
                    f"{est} {s['n_cases']:6d}")
        return "\n".join(lines)

    def to_json(self, indent: int | None = 1) -> str:
        return json.dumps({"baseline": self.baseline,
                           "forecast_order": self.forecast_order,
                           "rows": self.rows_,
                           "summary": self.summary()}, indent=indent)

    @classmethod
    def from_json(cls, payload: str) -> "OracleGapResult":
        d = json.loads(payload)
        return cls(baseline=d["baseline"],
                   forecast_order=d["forecast_order"], rows_=d["rows"])


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tiny", action="store_true",
                    help="CI-scale smoke (small capacity, 1 seed, 2-point "
                         "ladder)")
    ap.add_argument("--smoke", action="store_true",
                    help="fastest end-to-end check (perfect forecast only, "
                         "1 seed, MPC + greedy vs both oracles)")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--capacity", type=int, default=40)
    ap.add_argument("--region", default="south-australia")
    ap.add_argument("--engine", default="scan",
                    choices=("scan", "vector", "scalar"))
    ap.add_argument("--kind", default="noisy",
                    choices=("noisy", "quantile"))
    ap.add_argument("--out", default=None, help="write result JSON here")
    ap.add_argument("--device", default="cuda",
                    help="where the grid runs ('cuda' or 'cpu')")
    args = ap.parse_args()

    if args.smoke:
        base = Scenario(region=args.region, capacity=6, learn_weeks=1,
                        family="alibaba", seed=101)
        gap = OracleGap(base=base, seeds=(11,),
                        policies=("carbonflex", "carbonflex-mpc",
                                  "carbonflex-scale"),
                        forecasts=sigma_ladder((0.0,)), engine=args.engine,
                        device=args.device)
    elif args.tiny:
        base = Scenario(region=args.region, capacity=8, learn_weeks=1,
                        family="alibaba", seed=101)
        gap = OracleGap(base=base, seeds=(11,),
                        forecasts=sigma_ladder((0.0, 0.2), kind=args.kind),
                        engine=args.engine, device=args.device)
    else:
        base = Scenario(region=args.region, capacity=args.capacity,
                        learn_weeks=2, seed=7)
        gap = OracleGap(base=base,
                        seeds=tuple(range(1, args.seeds + 1)),
                        forecasts=sigma_ladder(kind=args.kind),
                        engine=args.engine, device=args.device)
    res = gap.run(progress=print)
    print(res.table())
    for pol in res.policies():
        curve = ", ".join(f"{fc}={g:+.2f}pp"
                          for fc, g in res.degradation_curve(pol))
        print(f"degradation[{pol}]: {curve}")
    perfect = res.summary().get("perfect", {})
    for pol, s in perfect.items():
        att = s.get("gap_attribution_mean_pp")
        if att:
            split = ", ".join(f"{c}={v:+.2f}pp" for c, v in att.items())
            print(f"gap attribution[{pol}] (perfect forecast): {split}")
    if args.out:
        with open(args.out, "w") as f:
            f.write(res.to_json())
            f.write("\n")
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
