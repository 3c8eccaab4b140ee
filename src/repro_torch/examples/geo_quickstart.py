"""Geo-distributed quickstart: shifting cluster load in space AND time.

Declares a 2-region geo scenario (capacity split across regions with
aligned CI traces) and sweeps the three geo policies over several seeds:

- ``geo-static``  — jobs pinned to their arrival region (status quo);
- ``geo-greedy``  — admission into the currently cleanest region;
- ``geo-flex``    — per-region CI-rank suspend/resume plus
  suspend-migrate-resume when the forecast gap between regions exceeds
  the migration carbon cost (checkpoint/restore slots + transfer energy).

  python -m repro_torch.examples.geo_quickstart
  python -m repro_torch.examples.geo_quickstart --tiny    # CI smoke run
"""
import argparse

from repro_torch.device import resolve_device
from repro_torch.experiment import DEFAULT_GEO_POLICIES, Scenario, Sweep


def main(argv=None):
    """Prints the world, the sweep's table and geo-flex's migrations;
    returns the ``SweepResult``."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--regions", nargs="+",
                    default=["south-australia", "california"])
    ap.add_argument("--capacity", type=int, default=40,
                    help="total capacity, split evenly across regions")
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--tiny", action="store_true",
                    help="minutes-not-hours smoke configuration for CI")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    if args.tiny:
        args.capacity, args.seeds = 10, [1]

    base = Scenario(regions=tuple(args.regions), capacity=args.capacity,
                    learn_weeks=1, family="azure", seed=args.seeds[0])
    mat = base.materialize()
    print(f"{len(mat.eval_jobs)} evaluation jobs over "
          f"{'+'.join(base.regions)} "
          f"(per-region capacity {mat.geo.capacities}), "
          f"migration cost: {mat.geo.migration.base_slots}+ slots, "
          f"{mat.geo.migration.energy_kwh_per_gb} kWh/GB\n")

    sweep = Sweep(base=base, seeds=args.seeds,
                  policies=list(DEFAULT_GEO_POLICIES), device=args.device)
    sr = sweep.run(progress=print)
    print()
    print(sr.table())

    flex = [r for r in sr.rows() if r["policy"] == "geo-flex"]
    migs = sum(r["migrations"] for r in flex)
    print(f"\ngeo-flex migrated {migs} jobs across "
          f"{len(flex)} runs; migration carbon "
          f"{sum(r['migration_carbon_g'] for r in flex) / 1e3:.2f} kg "
          f"is charged inside its savings above")
    return sr


if __name__ == "__main__":
    main()
