"""Forecast-uncertainty quickstart: how robust is each policy to
realistic carbon-forecast error?

The paper assumes accurate day-ahead CI forecasts; this example swaps the
forecast model (``core/forecast.py``) under every policy and measures the
savings-gap-to-oracle (the oracle reads the true trace, so it is
forecast-independent):

- ``perfect``      — the paper's assumption (the default everywhere);
- ``noisy(s)``     — seeded AR(1) multiplicative error whose std grows
  with lead time; re-querying a slot closer in time shrinks its error;
- ``quantile``     — a seeded ensemble exposing per-horizon quantile
  bands, which the ``*-robust`` policy variants threshold on.

The study runs on ``OracleGap``'s default ``engine="scan"``: its slot loop
on ``--device``.

  python -m repro_torch.examples.forecast_quickstart
  python -m repro_torch.examples.forecast_quickstart --tiny  # CI smoke
"""
import argparse

import numpy as np

from repro_torch.core import NoisyForecast, QuantileForecast
from repro_torch.device import resolve_device
from repro_torch.experiment import OracleGap, Scenario, sigma_ladder


def main(argv=None):
    """Prints the forecast models' error bands, the gap table and the
    degradation curves; returns the ``OracleGapResult``."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--capacity", type=int, default=40)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--sigmas", type=float, nargs="+",
                    default=[0.0, 0.1, 0.2, 0.4])
    ap.add_argument("--tiny", action="store_true",
                    help="minutes-not-hours smoke configuration for CI")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    if args.tiny:
        args.capacity, args.seeds, args.sigmas = 8, [11], [0.0, 0.2]

    # the EXPERIMENTS.md §Forecast configuration (tiny shrinks it for CI)
    base = Scenario(capacity=args.capacity,
                    learn_weeks=1 if args.tiny else 2,
                    family="alibaba" if args.tiny else "azure",
                    seed=args.seeds[0] if args.tiny else 7)

    # Peek at the forecast models themselves before the policy study.
    mat = base.materialize()
    noisy = NoisyForecast(sigma=0.2)
    t = mat.t0
    truth = mat.ci.forecast(t, 24)
    seen = noisy.predict(mat.ci.trace, t, 24)
    rel = np.abs(seen / np.clip(truth, 1e-9, None) - 1.0)
    print(f"noisy(s=0.2) at t0: |rel err| lead-1h {rel[1]:.1%}, "
          f"lead-23h {rel[23]:.1%} "
          f"(analytic band: {noisy.lead_std(24)[1]:.1%} -> "
          f"{noisy.lead_std(24)[23]:.1%})")
    qf = QuantileForecast(sigma=0.2)
    q10 = qf.quantile(mat.ci.trace, t, 24, 0.1)
    q90 = qf.quantile(mat.ci.trace, t, 24, 0.9)
    print(f"quantile(s=0.2) at t0: q10-q90 band width grows "
          f"{q90[1] - q10[1]:.0f} -> {q90[23] - q10[23]:.0f} g/kWh "
          f"over the day\n")

    gap = OracleGap(base=base, seeds=args.seeds,
                    forecasts=sigma_ladder(args.sigmas), device=args.device)
    res = gap.run(progress=print)
    print()
    print(res.table())
    print()
    for pol in ("carbonflex", "carbonflex-robust"):
        curve = ", ".join(f"{fc}={g:+.2f}pp"
                          for fc, g in res.degradation_curve(pol))
        print(f"gap-to-oracle[{pol}]: {curve}")
    print("\n(the oracle reads the true trace; a flat curve = robust, "
          "a rising curve = savings lost to forecast error)")
    return res


if __name__ == "__main__":
    main()
