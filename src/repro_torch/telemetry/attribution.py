"""Carbon attribution: decompose a run's emissions delta vs its baseline
into named causes that sum float-exactly to the total.

The measured causes are first-order decompositions computed from run
aggregates the engines already account exactly:

- ``capacity_scaling``    — the energy delta (batch runs) priced at the
  baseline's realised carbon intensity: carbon moved by using fewer /
  more server-slots at all, CarbonScaler's marginal-capacity axis;
- ``precision_tiering``   — the same energy-delta term for serving runs
  (the tier mix is the only energy knob there; batch runs report 0);
- ``geo_placement``       — spatial advantage: per-slot carbon below
  what the run's own energy would have emitted at the slot's
  region-mean CI, policy minus baseline (exactly 0 for single-region);
- ``migration_overhead``  — baseline-minus-policy migration carbon
  (negative when the policy pays for moves the baseline avoids);
- ``fault_restore``       — restore-transfer energy delta priced at the
  baseline CI (0 on fault-free runs);
- ``temporal_shifting``   — the residual: carbon moved by running the
  *same* work at different hours, which no aggregate delta isolates.

The residual is then nudged by a fixpoint so that the canonical
left-to-right IEEE sum over ``CAUSES`` equals the measured delta to the
last bit — ``check()`` asserts ``sum(causes) == delta_g`` with ``==``,
not a tolerance (pinned by the additivity property test).  One honest
caveat: when causes partially cancel, the achievable canonical sums
form a lattice whose spacing is set by the largest cause's ulp, and the
measured delta can sit between two lattice points; ``delta_g`` is then
the closest achievable sum — off by ulps of the largest cause, i.e.
sub-nanogram at cluster scale (the property test bounds the gap).
"""
from __future__ import annotations

import dataclasses
import math

CAUSES = ("temporal_shifting", "capacity_scaling", "geo_placement",
          "migration_overhead", "precision_tiering", "fault_restore")


def _ltr_sum(values) -> float:
    """Canonical left-to-right IEEE-754 sum (the additivity contract)."""
    total = 0.0
    for v in values:
        total += v
    return total


@dataclasses.dataclass
class Attribution:
    """One run's carbon delta vs its baseline, decomposed by cause.

    ``delta_g = baseline_carbon_g - carbon_g`` (positive = savings) and
    the ``CAUSES``-ordered left-to-right sum of ``causes`` equals it
    float-exactly.  (Under cancelling causes ``delta_g`` is the closest
    canonically-summable value instead, ulps of the largest cause away
    from the measured delta — see the module docstring.)"""

    policy: str
    baseline: str
    carbon_g: float
    baseline_carbon_g: float
    delta_g: float
    causes: dict[str, float]

    @property
    def savings_pct(self) -> float:
        if self.baseline_carbon_g <= 0:
            return 0.0
        return 100.0 * self.delta_g / self.baseline_carbon_g

    def pp_of_baseline(self, cause: str) -> float:
        """One cause's share, in percentage points of baseline carbon."""
        if self.baseline_carbon_g <= 0:
            return 0.0
        return 100.0 * self.causes[cause] / self.baseline_carbon_g

    def check(self) -> None:
        total = _ltr_sum(self.causes[c] for c in CAUSES)
        if total != self.delta_g:
            raise ArithmeticError(
                f"attribution not additive: sum(causes)={total!r} != "
                f"delta={self.delta_g!r} ({self.policy} vs {self.baseline})")

    def to_dict(self) -> dict:
        return {"policy": self.policy, "baseline": self.baseline,
                "carbon_g": float(self.carbon_g),
                "baseline_carbon_g": float(self.baseline_carbon_g),
                "delta_g": float(self.delta_g),
                "savings_pct": self.savings_pct,
                "causes": {c: float(self.causes[c]) for c in CAUSES}}

    def table(self) -> str:
        lines = [f"{self.policy} vs {self.baseline}: "
                 f"{self.delta_g:,.1f} g saved "
                 f"({self.savings_pct:.2f}% of baseline)"]
        for c in CAUSES:
            v = self.causes[c]
            if v == 0.0:
                continue
            lines.append(f"  {c:<20} {v:>14,.1f} g "
                         f"({self.pp_of_baseline(c):+6.2f} pp)")
        return "\n".join(lines)


def _fit_residual(causes: dict[str, float], delta: float) -> bool:
    """Choose ``temporal_shifting`` so the canonical left-to-right sum
    over CAUSES hits ``delta`` to the last bit.

    The additive correction loop converges in one or two steps almost
    always; when the residual dwarfs the delta the correction can be
    sub-ulp (rounding to a no-op, oscillating one ulp around the
    target), so a short ulp-neighbourhood scan finishes the job."""
    resid = 0.0
    for _ in range(4):
        causes["temporal_shifting"] = resid
        total = _ltr_sum(causes[c] for c in CAUSES)
        if total == delta:
            return True
        resid += delta - total
    lo = hi = resid
    for _ in range(4):
        lo = math.nextafter(lo, -math.inf)
        hi = math.nextafter(hi, math.inf)
        for cand in (lo, hi):
            causes["temporal_shifting"] = cand
            if _ltr_sum(causes[c] for c in CAUSES) == delta:
                return True
    causes["temporal_shifting"] = resid
    return False


def _spatial_advantage(result) -> float:
    """Carbon below region-mean placement: sum_t (e_t * mean_ci_t - c_t).

    Geo slot logs store the region-mean CI; a single-region run has no
    spatial freedom, so its advantage is defined as exactly 0.0."""
    if result.regions is None:
        return 0.0
    adv = 0.0
    for s in result.slots:
        adv += s.energy_kwh * s.ci - s.carbon_g
    return adv


def _restore_energy(result) -> float:
    r = result.resilience
    return float(r.restore_energy_kwh) if r is not None else 0.0


def attribute(result, baseline) -> Attribution:
    """Decompose ``baseline.carbon_g - result.carbon_g`` by cause.

    Both runs must cover the same workload window (the sweep pairing:
    same region / seed / fault / forecast cell, different policy)."""
    delta = float(baseline.carbon_g - result.carbon_g)
    ci_ref = (baseline.carbon_g / baseline.energy_kwh
              if baseline.energy_kwh > 0 else 0.0)
    e_delta = (baseline.energy_kwh - result.energy_kwh) * ci_ref
    serving = result.serving is not None or baseline.serving is not None
    # float() coercions: slot logs and migration totals may be numpy
    # scalars, and the causes dict is the public surface (repr'd into
    # the attribution CSV) — same IEEE doubles, plain Python floats.
    causes = {
        "temporal_shifting": 0.0,
        "capacity_scaling": 0.0 if serving else float(e_delta),
        "geo_placement": float(_spatial_advantage(result)
                               - _spatial_advantage(baseline)),
        "migration_overhead": float(baseline.migration_carbon_g
                                    - result.migration_carbon_g),
        "precision_tiering": float(e_delta) if serving else 0.0,
        "fault_restore": float((_restore_energy(baseline)
                                - _restore_energy(result)) * ci_ref),
    }
    fitted = _fit_residual(causes, delta)
    for _ in range(8):
        if fitted:
            break
        # The residual's float grid can be coarser than delta's (when
        # |temporal_shifting| >> |delta|) so no residual value lands on
        # delta exactly: consecutive residuals step the sum past it.
        # Shift the lattice instead: fold the remaining mismatch — at
        # most half an ulp of the residual, meaningless in grams for a
        # first-order decomposition — into the finest-grained (smallest
        # nonzero) measured cause, then refit.  fl(x + y) is monotone
        # in y, so the fold moves the total toward delta by design.
        total = _ltr_sum(causes[c] for c in CAUSES)
        cands = [c for c in CAUSES[1:] if causes[c] != 0.0]
        if not cands:        # others all zero => total == resid == delta
            break
        c = min(cands, key=lambda c: abs(causes[c]))
        nudged = causes[c] + (delta - total)
        if nudged == causes[c]:      # sub-ulp even here: step one ulp
            nudged = math.nextafter(
                causes[c], math.inf if delta > total else -math.inf)
        causes[c] = nudged
        fitted = _fit_residual(causes, delta)
    if not fitted:
        # The measured delta sits between two points of the achievable
        # sum lattice (cancelling decomposition, see module docstring):
        # delta_g becomes the nearest achievable sum, ulps away.
        delta = _ltr_sum(causes[c] for c in CAUSES)
    return Attribution(policy=result.policy, baseline=baseline.policy,
                       carbon_g=float(result.carbon_g),
                       baseline_carbon_g=float(baseline.carbon_g),
                       delta_g=float(delta), causes=causes)
