"""Structured per-slot decision traces (the observability tentpole).

Every engine path (scalar / vector / geo / scan / serving) drives the
same small vocabulary of per-slot events through a
:class:`TraceRecorder`:

=============== ==============================================================
kind            meaning (``job`` = job_id unless noted)
=============== ==============================================================
admit           job entered the active set (arrival or DAG release)
suspend         job was running last slot, received no servers this slot
resume          previously-started job received servers again
scale           running job's allocation changed size (``value`` = new k,
                ``detail`` = ``from=<old k>``)
migrate         started job began moving region (``value`` = destination,
                ``detail`` = ``from=<source region>``)
evict           job kicked off failed capacity (correlated-fault domain)
preempt         job killed; progress rolled back (``value`` = work re-added)
checkpoint      checkpoint slot charged (``value`` = progress factor)
restore         checkpoint re-transfer billed (``value`` = energy kWh)
tier-switch     serving: dominant precision tier changed (``value`` = tier
                index, ``detail`` = ``from=<old index>``; job is None)
forecast-read   policy read a degraded carbon feed (``value`` = staleness
                in slots; job is None)
=============== ==============================================================

Emission is observation-only — recorders never mutate engine state — so
attaching one cannot change results, and ``telemetry=None`` paths skip
every telemetry branch (bit-identity pinned by the golden fixtures).

Cross-engine equality is by construction: the engines feed the shared
:class:`SlotEventTracker` the identical row-ordered (job, k) allocation
stream their float parity already relies on, and the scan engine decodes
the same stream host-side from the ``take``/``fin``/``region``/``mig_now``
grids its device slot loop copies to the host once per chunk (no per-slot
host syncs).  A pure-Python copy of the JAX package's module: nothing here
touches a tensor.
"""
from __future__ import annotations

import dataclasses
from typing import (TYPE_CHECKING, Iterable, NamedTuple, Protocol,
                    runtime_checkable)

if TYPE_CHECKING:                    # profiler is an independent module
    from .profiler import PhaseProfiler

EVENT_KINDS = ("admit", "suspend", "resume", "scale", "migrate", "evict",
               "preempt", "checkpoint", "restore", "tier-switch",
               "forecast-read")


class TraceEvent(NamedTuple):
    """One recorded decision/lifecycle event.

    A NamedTuple rather than a dataclass: construction sits on the
    engines' recording hot path, and
    tuple ``__new__`` is several times cheaper than a frozen-dataclass
    ``__init__`` while keeping immutability and field names."""

    t: int                           # slot index
    kind: str                        # one of EVENT_KINDS
    job: int | None = None           # job_id (None for slot-level events)
    value: float | None = None       # kind-specific scalar (see module doc)
    detail: str = ""                 # kind-specific annotation
    run: str = ""                    # run label (sweep case, bench name, ...)

    def to_dict(self) -> dict:
        return {"t": int(self.t), "kind": self.kind, "job": self.job,
                "value": self.value, "detail": self.detail, "run": self.run}


@runtime_checkable
class TraceRecorder(Protocol):
    """Anything that accepts a stream of :class:`TraceEvent` s."""

    def record(self, event: TraceEvent) -> None: ...


class MemoryRecorder:
    """In-memory recorder: events in emission order, with small query
    helpers for tests, reports and figures."""

    def __init__(self) -> None:
        self.events: list[TraceEvent] = []

    def record(self, event: TraceEvent) -> None:
        self.events.append(event)

    def __len__(self) -> int:
        return len(self.events)

    def by_kind(self, kind: str) -> list[TraceEvent]:
        return [e for e in self.events if e.kind == kind]

    def for_run(self, run: str) -> list[TraceEvent]:
        return [e for e in self.events if e.run == run]

    def counts(self, run: str | None = None) -> dict[str, int]:
        """Event count per kind (insertion order follows EVENT_KINDS)."""
        out = {k: 0 for k in EVENT_KINDS}
        for e in self.events:
            if run is not None and e.run != run:
                continue
            out[e.kind] = out.get(e.kind, 0) + 1
        return {k: v for k, v in out.items() if v}

    def clear(self) -> None:
        self.events.clear()


@dataclasses.dataclass
class Telemetry:
    """The bundle threaded (as one optional argument) through every
    engine: an event recorder, a phase profiler, and the label stamped
    onto emitted events.  Either component may be None; ``emit`` is a
    no-op without a recorder, so call sites guard only on the bundle."""

    recorder: TraceRecorder | None = None
    profiler: "PhaseProfiler | None" = None
    run_label: str = ""

    def for_run(self, label: str) -> "Telemetry":
        """A view of the same recorder/profiler stamping ``label``."""
        return dataclasses.replace(self, run_label=label)

    def emit(self, t: int, kind: str, job: int | None = None,
             value: float | None = None, detail: str = "") -> None:
        if self.recorder is not None:
            self.recorder.record(TraceEvent(
                t=int(t), kind=kind, job=job, value=value, detail=detail,
                run=self.run_label))


class SlotEventTracker:
    """Derives suspend / resume / scale events from per-slot allocations.

    Every engine feeds :meth:`step` the same row-ordered stream of
    positive allocations (job_id, k) its float accounting already walks,
    so the derived event sequence is identical across scalar, vector and
    scan paths.  Within a slot, resume/scale fire in feed (row) order,
    then suspends in sorted job order."""

    def __init__(self, telemetry: Telemetry) -> None:
        self.tele = telemetry
        self._k: dict[int, int] = {}       # job_id -> current allocation
        self._started: set[int] = set()
        self._last: tuple[list, list] | None = None

    def admit(self, t: int, job: int) -> None:
        self.tele.emit(t, "admit", job=job)

    def step(self, t: int, ids: list[int] | Iterable[int],
             ks: list[int] | Iterable[int]) -> None:
        # Steady-state fast path: the same positive (id, k) stream as the
        # previous slot (and no finish() in between) derives no events —
        # every job keeps its allocation, so no resume/scale/suspend can
        # fire.  One C-level list comparison replaces the full walk; this
        # is what keeps recording cheap in the steady state.
        if (self._last is not None and isinstance(ids, list)
                and ids == self._last[0] and ks == self._last[1]):
            return
        active: set[int] = set()
        for jid, k in zip(ids, ks):
            jid, k = int(jid), int(k)
            if k <= 0:
                continue
            active.add(jid)
            prev = self._k.get(jid, 0)
            if prev == 0:
                if jid in self._started:
                    self.tele.emit(t, "resume", job=jid, value=float(k))
            elif k != prev:
                self.tele.emit(t, "scale", job=jid, value=float(k),
                               detail=f"from={prev}")
            self._k[jid] = k
            self._started.add(jid)
        for jid in sorted(self._k):
            if jid not in active:
                self.tele.emit(t, "suspend", job=jid)
                del self._k[jid]
        if isinstance(ids, list) and isinstance(ks, list) and (
                len(active) == len(ids)):    # all-positive stream only
            self._last = (ids, ks)
        else:
            self._last = None

    def finish(self, job: int) -> None:
        """Completion: drop tracking so no spurious suspend fires."""
        self._k.pop(int(job), None)
        self._started.discard(int(job))
        self._last = None


def emit_fault_events(tele: Telemetry, t: int, job_ids, dist,
                      fault_kind: str) -> None:
    """Decode a ``SlotDisturbance`` into per-job fault events.

    Row order matches the engines' fault-apply sequence.  A preempted
    job always carries restore-transfer energy (``extra_energy > 0``),
    which distinguishes it from a restore-in-progress slot (factor 0, no
    energy) without peeking at fault-process internals; checkpoint slots
    (fractional factor) are only meaningful for the preemption process —
    iid stragglers also scale progress but are not checkpoints."""
    ev = dist.evicted
    lost = dist.lost
    extra = dist.extra_energy
    for i, jid in enumerate(job_ids):
        if ev is not None and ev[i]:
            tele.emit(t, "evict", job=int(jid))
        elif extra is not None and extra[i] > 0:
            rb = float(lost[i]) if lost is not None else 0.0
            tele.emit(t, "preempt", job=int(jid), value=rb)
            tele.emit(t, "restore", job=int(jid), value=float(extra[i]))
        elif fault_kind == "preemption" and 0.0 < dist.factors[i] < 1.0:
            tele.emit(t, "checkpoint", job=int(jid),
                      value=float(dist.factors[i]))
