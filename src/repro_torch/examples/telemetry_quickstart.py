"""Telemetry quickstart: trace every per-slot decision, attribute the
carbon savings to named causes, and profile where the wall-clock goes.

Attach a ``Telemetry`` bundle to any sweep and three observability
surfaces light up, none of which changes a single result float:

- **decision traces** — every engine emits the same per-slot event
  stream (admit / suspend / resume / scale / migrate / evict / preempt /
  checkpoint / restore / tier-switch / forecast-read) through the
  recorder, identical across scalar, vector and scan paths;
- **carbon attribution** — each policy's savings against its cell
  baseline decomposes into named causes (temporal shifting, capacity
  scaling, geo placement, migration overhead, precision tiering, fault
  restore) that sum float-exact to the measured delta;
- **phase profiling** — learn / provision / decide / execute wall-clock,
  synchronised with the card so device work is charged to the phase that
  launched it.

  python -m repro_torch.examples.telemetry_quickstart
  python -m repro_torch.examples.telemetry_quickstart --tiny  # CI smoke
"""
import argparse

from repro_torch.device import resolve_device
from repro_torch.experiment import Scenario, Sweep
from repro_torch.telemetry import MemoryRecorder, PhaseProfiler, Telemetry, explain


def main(argv=None):
    """Prints the sweep's table, each attribution, carbonflex's event
    counts and its ``explain`` report; returns the ``SweepResult`` and the
    ``Telemetry`` as a dict: ``sweep``, ``telemetry`` and ``label`` (the
    carbonflex run's label)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--capacity", type=int, default=24)
    ap.add_argument("--weeks", type=int, default=2)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--tiny", action="store_true",
                    help="seconds-not-minutes smoke configuration for CI")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    if args.tiny:
        args.capacity, args.weeks = 8, 1

    tel = Telemetry(recorder=MemoryRecorder(), profiler=PhaseProfiler())
    sweep = Sweep(
        base=Scenario(capacity=args.capacity, learn_weeks=args.weeks,
                      family="alibaba" if args.tiny else "google",
                      seed=args.seed),
        policies=["carbon-agnostic", "wait-awhile", "carbonflex"],
        telemetry=tel, device=args.device)
    res = sweep.run(progress=print)
    print()
    print(res.table())

    # -- carbon attribution: why did each policy save what it saved? ------
    print()
    for att in res.attributions():       # additivity checked inside
        print(att.table())
        print()

    # -- decision traces: what did carbonflex actually *do*? --------------
    row = next(r for r in res.rows() if r["policy"] == "carbonflex")
    label = f"{row['region']}/s{row['seed']}/{row['fault']}/carbonflex"
    counts = tel.recorder.counts(run=label)
    print(f"events[{label}]: "
          + ", ".join(f"{k}={n}" for k, n in counts.items()))

    # -- the whole story for one run, in one report -----------------------
    sims = dict(zip((r["policy"] for r in res.rows()), res.results))
    print()
    print(explain(sims["carbonflex"], baseline=sims["carbon-agnostic"],
                  recorder=tel.recorder, profiler=tel.profiler, run=label))
    return dict(sweep=res, telemetry=tel, label=label)


if __name__ == "__main__":
    main()
