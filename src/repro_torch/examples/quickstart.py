"""Quickstart: CarbonFlex end-to-end on a synthetic cluster.

Declares the experiment as a ``Scenario`` (3 weeks of history feeding the
continuous-learning loop, 1 evaluation week) and lets the driver do the
rest: oracle replay into the knowledge base, policy construction through
the registry, batched evaluation against the carbon-agnostic status quo
and the offline-optimal oracle.

  python -m repro_torch.examples.quickstart
  python -m repro_torch.examples.quickstart --tiny     # CI smoke run
  python -m repro_torch.examples.quickstart --tiny --device cpu
"""
import argparse

from repro_torch.device import resolve_device
from repro_torch.experiment import Scenario, run

POLICIES = ["carbon-agnostic", "wait-awhile", "carbonflex", "carbonflex-mpc", "oracle"]


def main(argv=None):
    """Prints the knowledge base's size and the savings table; returns the
    ``RunResult``."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--region", default="south-australia")
    ap.add_argument("--capacity", type=int, default=40)
    ap.add_argument("--learn-weeks", type=int, default=3)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--tiny", action="store_true",
                    help="minutes-not-hours smoke configuration for CI")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    if args.tiny:
        args.capacity, args.learn_weeks = 10, 1

    scenario = Scenario(region=args.region, capacity=args.capacity,
                        learn_weeks=args.learn_weeks, seed=args.seed)
    world = scenario.materialize()
    print(f"{len(world.hist)} historical jobs, {len(world.eval_jobs)} "
          f"evaluation jobs, M={world.cluster.capacity}")

    result = run(scenario, POLICIES, device=args.device)
    print(f"knowledge base: {result.kb_size} (STATE -> m, rho) cases\n")
    print(result.table())
    return result


if __name__ == "__main__":
    main()
