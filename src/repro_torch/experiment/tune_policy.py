"""MPC knob-grid tuner for the receding-horizon policies (the counterpart of
``scripts/tune_policy.py``).

Grids :class:`MPCConfig` knobs (horizon, replan cadence, length
percentile, clean-window fraction) through one shared world: the
scenario is materialized and its knowledge base learned exactly once,
then every knob combination becomes one scan-engine ``SimCase`` in a
single ``simulate_many`` batch, so structurally identical cells share
tiles of the device slot loop.

The printed gap is measured against the oracle run in the same batch;
the reference rows (carbon-agnostic / greedy carbonflex / oracle) anchor
the numbers.  The grid runs on ``device`` (``"cuda"`` by default: the
knowledge base and the scan engine's slot loop); host callers pass
``device="cpu"``.

    python -m repro_torch.experiment.tune_policy [--quick] [--scale] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools

from repro_torch.core.mpc import MPCConfig
from repro_torch.core.simulator import SimCase, simulate_many
from repro_torch.device import resolve_device

from .driver import prepare_context
from .registry import make_policy
from .scenario import WEEK, Scenario

REFS = ("carbon-agnostic", "carbonflex", "oracle")


def default_grid(scale: bool):
    """The knob grid: horizon x replan cadence x length percentile, plus
    the clean-window fraction axis when tuning ``carbonflex-scale``."""
    horizons = (24, 48, 72)
    replans = (1, 6)
    percentiles = (75.0, 85.0, 95.0)
    cleans = (0.15, 0.25, 0.4) if scale else (0.25,)
    return [MPCConfig(horizon=h, replan_every=r, percentile=p, clean_frac=c)
            for h, r, p, c in itertools.product(horizons, replans,
                                                percentiles, cleans)]


def tune(policy="carbonflex-mpc", grid=None, region="south-australia",
         seed=1, capacity=40, learn_weeks=2, scale=False, device="cuda"):
    """Run the reference rows and ``policy`` at every knob setting of
    ``grid`` in one ``simulate_many`` batch; print the savings and gaps and
    return ``{label: gap to the oracle in pp}``."""
    device = resolve_device(device)
    if grid is None:
        grid = default_grid(scale)
    sc = Scenario(region=region, capacity=capacity, learn_weeks=learn_weeks,
                  seed=seed, engine="scan")
    mat = sc.materialize()
    names = REFS + (policy,)
    ctx = prepare_context(mat, names, device=device)
    horizon = sc.eval_weeks * WEEK

    def case(name, pctx, label):
        return SimCase(jobs=mat.eval_jobs, ci=mat.ci, cluster=mat.cluster,
                       policy=make_policy(name, pctx), t0=mat.t0,
                       horizon=horizon, engine="scan", label=label,
                       device=device)

    cases = [case(n, ctx, n) for n in REFS]
    labels = list(REFS)
    for cfg in grid:
        lab = (f"H={cfg.horizon:<3d} R={cfg.replan_every} "
               f"p{cfg.percentile:g}"
               + (f" cf={cfg.clean_frac:g}" if scale else ""))
        cases.append(case(policy, dataclasses.replace(ctx, mpc=cfg), lab))
        labels.append(lab)
    results = simulate_many(cases)      # one batched scan dispatch

    by = dict(zip(labels, results))
    base = by["carbon-agnostic"].carbon_g
    orc_sv = 100.0 * (1.0 - by["oracle"].carbon_g / base)
    print(f"[{policy} | {region} seed={seed} cap={capacity}] "
          f"oracle {orc_sv:6.2f}%")
    out = {}
    for lab in labels:
        r = by[lab]
        sv = 100.0 * (1.0 - r.carbon_g / base)
        out[lab] = orc_sv - sv
        print(f"  {lab:24s} savings {sv:6.2f}%  gap {orc_sv - sv:6.2f}pp"
              f"  wait {r.mean_wait:5.1f}  viol {r.violation_rate:.3f}")
    best = min((lab for lab in labels if lab not in REFS), key=out.get)
    print(f"  -> best: {best}  (gap {out[best]:.2f}pp)")
    return out


def quick_grid():
    """``--quick``'s grid: horizon x length percentile at the default
    cadence and clean fraction."""
    return [MPCConfig(horizon=h, percentile=p)
            for h in (24, 48) for p in (75.0, 85.0)]


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.experiment.tune_policy")
    ap.add_argument("--quick", action="store_true",
                    help="a 4-cell grid, seed 1, capacity 20, 1 learning week")
    ap.add_argument("--scale", action="store_true",
                    help="tune carbonflex-scale (adds the clean-fraction axis)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    policy = "carbonflex-scale" if args.scale else "carbonflex-mpc"
    grid = quick_grid() if args.quick else None
    return [tune(policy=policy, grid=grid, seed=seed, scale=args.scale,
                 capacity=20 if args.quick else 40,
                 learn_weeks=1 if args.quick else 2, device=args.device)
            for seed in ([1] if args.quick else [1, 3])]


if __name__ == "__main__":
    main()
