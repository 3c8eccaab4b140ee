"""``explain()``: one human-readable report per run.

Combines whatever telemetry is available — the run's aggregates, the
carbon attribution vs a baseline run, the recorded event stream, and
the phase profile — into a plain-text report, one call per run.  Its text
equals the JAX package's for the same run."""
from __future__ import annotations

from .attribution import attribute
from .events import EVENT_KINDS, MemoryRecorder
from .profiler import PhaseProfiler


def explain(result, baseline=None, *, recorder: MemoryRecorder | None = None,
            profiler: PhaseProfiler | None = None,
            run: str | None = None) -> str:
    """Render a report for ``result``.

    ``baseline`` adds the cause decomposition of the carbon delta;
    ``recorder`` adds event counts (restricted to ``run``'s label when
    given); ``profiler`` adds the phase table."""
    lines = [f"run: {result.policy}",
             f"  carbon      {result.carbon_g:,.1f} g",
             f"  energy      {result.energy_kwh:,.3f} kWh",
             f"  mean wait   {result.mean_wait:.2f} slots",
             f"  violations  {result.violation_rate:.2%}"]
    if result.regions is not None:
        lines.append(f"  migrations  {result.migrations} "
                     f"({result.migration_carbon_g:,.1f} g)")
    if result.serving is not None:
        lines.append(f"  quality     {result.serving.quality_mean:.4f} "
                     f"(ledger {result.serving.ledger_final:+.3f})")

    if baseline is not None:
        att = attribute(result, baseline)
        att.check()
        lines.append("")
        lines.append("attribution:")
        lines.extend("  " + ln for ln in att.table().splitlines())

    if recorder is not None:
        counts = recorder.counts(run=run)
        lines.append("")
        if counts:
            lines.append("events:")
            for kind in EVENT_KINDS:
                if kind in counts:
                    lines.append(f"  {kind:<14} {counts[kind]:>8d}")
        else:
            lines.append("events: none recorded")

    if profiler is not None and profiler.seconds:
        lines.append("")
        lines.append("phases:")
        lines.extend("  " + ln for ln in profiler.table().splitlines())
    return "\n".join(lines)
