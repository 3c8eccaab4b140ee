"""DAG quickstart: carbon-aware scheduling of precedence-constrained jobs.

Declares a DAG scenario (every job is a pipeline of tasks — chains,
map-reduce stages, random layered DAGs — with per-task elasticity
profiles; the engines gate each task until its predecessors complete) and
sweeps the three precedence-aware policies:

- ``dag-fcfs``   — precedence-only baseline: FCFS over ready tasks;
- ``dag-carbon`` — CarbonFlex-style CI-rank suspend/resume applied per
  ready task (the per-job carbon scheduler on DAG structure);
- ``dag-cap``    — PCAPS-style criticality: critical-path tasks exempt
  from suspension, slack tasks deferred into clean windows.

It then runs the *independent-task twin* (same tasks, edges stripped) to
show what a per-job scheduler would report without precedence, and
compares per-pipeline completion stretch.

  python -m repro_torch.examples.dag_quickstart
  python -m repro_torch.examples.dag_quickstart --tiny    # CI smoke run
"""
import argparse

import numpy as np

from repro_torch.core import simulate
from repro_torch.device import resolve_device
from repro_torch.experiment import (DEFAULT_DAG_POLICIES, Scenario, Sweep, make_policy,
                                    prepare_context)
from repro_torch.traces import DagConfig


def pipeline_stretch(result, jobs) -> float:
    """Mean per-DAG completion stretch: (last task completion - arrival) /
    critical-path work, over the DAGs whose tasks all finished.  The
    critical path is recomputed from ``Job.deps`` (longest work chain),
    so a back-to-back pipeline scores ~1.0x and anything above it is
    queueing/suspension delay."""
    rows = sorted(jobs, key=lambda j: (j.arrival, j.job_id))
    by_dag: dict[str, list[int]] = {}
    for i, j in enumerate(rows):
        by_dag.setdefault(j.arch.split("/")[0], []).append(i)
    stretches = []
    for members in by_dag.values():
        comp = result.completion[members]
        if (comp < 0).any():
            continue
        arrival = min(rows[i].arrival for i in members)
        span = max(1.0, float(comp.max() - arrival + 1))
        head: dict[int, float] = {}
        for i in members:                # members are job_id-ordered: topo
            j = rows[i]
            head[j.job_id] = j.length + max(
                (head[d] for d in j.deps if d in head), default=0.0)
        stretches.append(span / max(1.0, max(head.values())))
    return float(np.mean(stretches)) if stretches else 0.0


def main(argv=None):
    """Prints the sweep's table, the twin's comparison and each policy's
    pipeline stretch; returns them as a dict: ``sweep`` and ``twin`` (the
    two ``SweepResult``s) and ``stretch`` (policy -> mean stretch)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--capacity", type=int, default=40)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--width", type=int, default=4)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--tiny", action="store_true",
                    help="minutes-not-hours smoke configuration for CI")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    if args.tiny:
        args.capacity, args.seeds = 12, [1]

    dag = DagConfig(width=args.width, depth=args.depth)
    base = Scenario(dag=dag, capacity=args.capacity, learn_weeks=1,
                    seed=args.seeds[0])
    mat = base.materialize()
    n_dags = len({j.arch.split("/")[0] for j in mat.eval_jobs})
    print(f"{len(mat.eval_jobs)} evaluation tasks in {n_dags} DAGs "
          f"(shapes {'/'.join(dag.shapes)}, width<={dag.width}, "
          f"depth<={dag.depth}), capacity {args.capacity}\n")

    sweep = Sweep(base=base, seeds=args.seeds,
                  policies=list(DEFAULT_DAG_POLICIES), device=args.device)
    sr = sweep.run(progress=print)
    print()
    print(sr.table())

    # The independent-task twin: identical tasks, precedence stripped —
    # what a per-job carbon scheduler would report on this workload.
    indep = Sweep(base=Scenario(dag=DagConfig(
                      width=args.width, depth=args.depth, independent=True),
                      capacity=args.capacity, learn_weeks=1,
                      seed=args.seeds[0]),
                  seeds=args.seeds, policies=["dag-fcfs", "dag-carbon"],
                  device=args.device)
    si = indep.run()
    pick = lambda rows: next(r for r in rows if r["policy"] == "dag-carbon"  # noqa: E731
                             and r["seed"] == args.seeds[0])
    print(f"\ndag-carbon savings, seed {args.seeds[0]}: "
          f"{pick(sr.rows())['savings_pct']:.1f}% with precedence gating vs "
          f"{pick(si.rows())['savings_pct']:.1f}% on the independent-task "
          f"twin")

    # Per-pipeline stretch: what the savings cost in end-to-end latency.
    ctx = prepare_context(mat, DEFAULT_DAG_POLICIES, device=args.device)
    print("\nper-pipeline completion stretch (makespan / critical work):")
    stretch = {}
    for name in DEFAULT_DAG_POLICIES:
        res = simulate(mat.eval_jobs, mat.ci, mat.cluster,
                       make_policy(name, ctx), t0=mat.t0, horizon=24 * 7,
                       device=args.device)
        stretch[name] = pipeline_stretch(res, mat.eval_jobs)
        print(f"  {name:12s} {stretch[name]:5.2f}x")
    return dict(sweep=sr, twin=si, stretch=stretch)


if __name__ == "__main__":
    main()
