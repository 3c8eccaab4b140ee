"""Telemetry layer: decision traces, carbon attribution, phase profiling.

Everything here is observation-only: the engines behave bit-identically
with telemetry attached or absent.  Pure Python, the JAX package's own
modules copied: ``attribute`` gives its causes bit for bit, ``explain`` its
text; the profiler's ``sync`` waits on CUDA tensors and ``trace()`` wraps
``torch.profiler``."""
from .attribution import CAUSES, Attribution, attribute
from .events import (EVENT_KINDS, MemoryRecorder, SlotEventTracker,
                     Telemetry, TraceEvent, TraceRecorder,
                     emit_fault_events)
from .profiler import PHASES, PhaseProfiler
from .report import explain

__all__ = [
    "CAUSES", "Attribution", "attribute",
    "EVENT_KINDS", "MemoryRecorder", "SlotEventTracker", "Telemetry",
    "TraceEvent", "TraceRecorder", "emit_fault_events",
    "PHASES", "PhaseProfiler",
    "explain",
]
