"""Resilience quickstart: how gracefully does each policy degrade when
the world breaks?

Three disturbance families (``core/faults.py``) hit the same scenario:

- ``correlated`` — Markov burst outages over failure domains (rack /
  zone slices): capacity disappears for a duration and the jobs placed
  there are evicted;
- ``preemption`` — per-job kills with checkpoint/restore: work since the
  last checkpoint is lost and the restore transfer is billed at the
  current CI;
- ``ci-outage``  — the carbon feed goes stale: policies forward-fill
  last-known-good values and fall back to persistence forecasts past the
  staleness threshold, while carbon accounting stays on the true trace.

The sweep prints per-policy savings under each regime plus the recovery
metrics (evictions, lost work, MTTR, degraded time) from
``SimResult.resilience``.

  python -m repro_torch.examples.resilience_quickstart
  python -m repro_torch.examples.resilience_quickstart --tiny  # CI smoke
"""
import argparse
import dataclasses

from repro_torch.core import CarbonDataOutage, CorrelatedFaults, PreemptionFaults
from repro_torch.device import resolve_device
from repro_torch.experiment import Scenario, Sweep


def main(argv=None):
    """Prints the savings and recovery metrics by fault regime and under a
    flaky carbon feed; returns both ``SweepResult``s as a dict: ``faults``
    and ``outage``."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--capacity", type=int, default=40)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--outage-rate", type=float, default=0.05,
                    help="per-slot failure probability of each domain")
    ap.add_argument("--preempt-rate", type=float, default=0.05,
                    help="per-slot kill probability of each running job")
    ap.add_argument("--tiny", action="store_true",
                    help="minutes-not-hours smoke configuration for CI")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    if args.tiny:
        args.capacity, args.seed = 8, 11

    base = Scenario(capacity=args.capacity, learn_weeks=1,
                    family="alibaba" if args.tiny else "azure",
                    seed=args.seed)
    policies = ("carbon-agnostic", "wait-awhile", "carbonflex")

    # 1) structured fault processes: clean vs correlated vs preemption
    faults = [None,
              CorrelatedFaults(n_domains=4, rate=args.outage_rate,
                               mean_duration=8.0, seed=args.seed),
              PreemptionFaults(rate=args.preempt_rate, checkpoint_every=4,
                               seed=args.seed)]
    res = Sweep(base=base, policies=policies, faults=faults, device=args.device).run(
        progress=None if args.tiny else print)
    print("\nsavings by fault regime (baseline: carbon-agnostic):")
    print(f"  {'policy':16s} {'fault':28s} {'savings%':>9s} "
          f"{'evict':>6s} {'preempt':>8s} {'lost-work':>10s} {'mttr':>5s}")
    for row in res.rows():
        r = row.get("resilience") or {}
        print(f"  {row['policy']:16s} {row['fault']:28s} "
              f"{row['savings_pct']:9.2f} {r.get('evictions', 0):6d} "
              f"{r.get('preemptions', 0):8d} "
              f"{r.get('lost_work_slots', 0.0):10.1f} "
              f"{r.get('mttr_slots', 0.0):5.1f}")

    # 2) carbon-feed outage: the policies go (partially) blind
    blind = dataclasses.replace(
        base, ci_outage=CarbonDataOutage(rate=0.05, mean_duration=6.0,
                                         stale_after=3, seed=args.seed))
    res2 = Sweep(base=blind, policies=policies, device=args.device).run()
    print("\nsavings with a flaky carbon feed (stale -> last-known-good + "
          "persistence):")
    for row in res2.rows():
        r = row.get("resilience") or {}
        print(f"  {row['policy']:16s} savings {row['savings_pct']:+7.2f}%  "
              f"degraded {r.get('degraded_slots', 0)} slots")
    print("\n(accounting always reads the true CI trace — only the "
          "policies' view goes stale)")
    return dict(faults=res, outage=res2)


if __name__ == "__main__":
    main()
