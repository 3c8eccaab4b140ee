"""Year-long CarbonFlex-Simulator run (paper §5 'Simulation Environment').

Simulates many weeks of cluster operation with weekly continuous
re-learning (the rolling knowledge-base window of §4.2): the experiment
driver replays each evaluated week through the offline oracle before the
next, ages old windows out of the knowledge base (``max_windows``), and
keeps the MPC policy's length histories warm.  Scale knobs keep the
default run to a few minutes; raise --weeks / --capacity for the paper's
full scale.

  python -m repro_torch.examples.cluster_sim_year --weeks 8
  python -m repro_torch.examples.cluster_sim_year --weeks 1 --capacity 10 --device cpu
"""
import argparse

from repro_torch.device import resolve_device
from repro_torch.experiment import Scenario, run

POLICIES = ["carbon-agnostic", "wait-awhile", "carbonflex", "carbonflex-mpc"]


def main(argv=None):
    """Prints each week's progress line and the savings table; returns the
    ``RunResult``."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--weeks", type=int, default=6)
    ap.add_argument("--capacity", type=int, default=30)
    ap.add_argument("--region", default="california")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    scenario = Scenario(region=args.region, capacity=args.capacity,
                        seed=args.seed, learn_weeks=1, eval_weeks=args.weeks)
    result = run(scenario, POLICIES,
                 kb_kwargs=dict(max_windows=4),      # rolling aging window
                 progress=print, device=args.device)
    print()
    print(result.table())
    return result


if __name__ == "__main__":
    main()
