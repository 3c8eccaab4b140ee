"""Serving-tier quickstart: trade a bounded slice of answer quality for
carbon by routing requests across precision tiers.

A ``Scenario(serving=ServingConfig())`` carries an interactive request
stream (diurnal x weekly seasonality, Poisson arrivals, burst spikes)
instead of batch jobs.  Every slot, a serve policy splits the request
mix across precision tiers (fp32 / bf16 / int8 — energy and quality
derived from the decode cost model and measured quantization error), a
credit ledger keeps time-averaged quality on target, and an SLO model
charges latency violations when utilization passes the knee:

- ``serve-static`` — everything on fp32 (the status quo; eats the SLO
  violations that the cheaper tiers' capacity headroom would absorb);
- ``serve-greedy`` — degrade above the p70 carbon intensity of the
  day-ahead forecast, repay below p30, ledger-bounded;
- ``serve-flex``   — forecast-aware: CI trend + demand look-ahead +
  quantile forecast + an emissions budget, weighted and ledger-scaled.

  python -m repro_torch.examples.serving_quickstart
  python -m repro_torch.examples.serving_quickstart --tiny  # CI smoke
"""
import argparse

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.experiment import Scenario, ServingConfig, run
from repro_torch.serving import derive_tiers


def main(argv=None):
    """Prints the tier table, the savings table and each policy's quality
    and ledger; returns the ``RunResult``."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--requests-per-day", type=float, default=1.5e6)
    ap.add_argument("--servers", type=int, default=48)
    ap.add_argument("--weeks", type=int, default=2)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--quality-target", type=float, default=0.98)
    ap.add_argument("--tiny", action="store_true",
                    help="seconds-not-minutes smoke configuration for CI")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    if args.tiny:
        args.requests_per_day, args.servers, args.weeks = 2e5, 12, 1

    cfg = ServingConfig(requests_per_day=args.requests_per_day,
                        servers=args.servers,
                        quality_target=args.quality_target)

    # The tier table is derived, not asserted: energy scales with bytes
    # moved (decode is memory-bandwidth-bound), quality with measured
    # quantization RMS error (elastic/compression.py).
    print("tier        bytes  kWh/kreq  quality   req/server-slot")
    for t in derive_tiers(quality_kappa=cfg.quality_kappa):
        print(f"{t.name:10s} {t.bytes_per_value:5.0f} {t.energy_kwh_per_kreq:9.2f} "
              f"{t.quality:8.4f} {t.capacity_per_server:15.0f}")
    print()

    sc = Scenario(serving=cfg, learn_weeks=1, eval_weeks=args.weeks,
                  seed=args.seed)
    res = run(sc, progress=print, device=args.device)
    print()
    print(res.table())
    print()
    for pol in res.policies:
        w = res.weekly[pol]
        bal = np.concatenate([r.serving.balance for r in w])
        print(f"{pol:14s} quality={res.quality_mean(pol):.4f}  "
              f"ledger [{bal.min():+.3f}, {bal.max():+.3f}] "
              f"final {w[-1].serving.ledger_final:+.3f}")
    print("\n(a negative ledger = quality debt being spent in dirty hours; "
          "the bound [-1, +1] caps how far any policy can drift from the "
          "quality target)")
    return res


if __name__ == "__main__":
    main()
