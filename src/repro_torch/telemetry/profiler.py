"""Lightweight phase profilers for the experiment pipeline.

Four canonical phases bracket where each run's wall-clock goes:

- ``learn``     — knowledge-base construction (``learn_window``);
- ``provision`` — scenario materialisation + policy construction;
- ``decide``    — policy decisions (per-slot on the host engines; the
  device slot loop on the scan path, its per-chunk copies included);
- ``execute``   — progress/energy accounting and bookkeeping.

Timers use ``perf_counter`` and cost one branch per slot when attached;
the engines skip them entirely when no profiler is threaded.  Device
work is synchronised before a bracket closes (:meth:`sync`:
``torch.cuda.synchronize`` on the device of every CUDA tensor given) so
device timings measure compute, not dispatch.  Set ``trace_dir`` to also
export a ``torch.profiler`` Chrome trace around whatever :meth:`trace`
wraps (off by default — the flag exists so deep dives don't need code
edits).  The JAX package names these two ``jax_trace_dir`` /
``jax_trace()``."""
from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

PHASES = ("learn", "provision", "decide", "execute")


def _cuda_devices(tree, out: set) -> None:
    """Collect the CUDA devices of the tensors in ``tree`` (nested
    lists, tuples and dict values)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for x in tree:
            _cuda_devices(x, out)
        return
    device = getattr(tree, "device", None)
    if getattr(device, "type", None) == "cuda":
        out.add(device)


class PhaseProfiler:
    """Accumulates wall-clock seconds (and bracket counts) per phase."""

    def __init__(self, trace_dir: str | None = None) -> None:
        self.seconds: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self.trace_dir = trace_dir

    def add(self, phase: str, dt: float) -> None:
        self.seconds[phase] = self.seconds.get(phase, 0.0) + dt
        self.calls[phase] = self.calls.get(phase, 0) + 1

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Bracket a phase; the device work of ``sync`` (a tensor, or
        lists/tuples/dicts of them) is waited on before the timer stops."""
        t = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                self.sync(sync)
            self.add(name, time.perf_counter() - t)

    @staticmethod
    def sync(tree) -> None:
        """Block until device work on the devices of the CUDA tensors in
        ``tree`` has finished (a no-op for CPU tensors, arrays and
        ``None``)."""
        devices: set = set()
        _cuda_devices(tree, devices)
        for device in devices:
            torch.cuda.synchronize(device)

    @contextlib.contextmanager
    def trace(self):
        """Export a ``torch.profiler`` Chrome trace (``trace.json`` under
        ``trace_dir``) around the wrapped block when ``trace_dir`` is set;
        a plain passthrough otherwise."""
        if not self.trace_dir:
            yield
            return
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self.trace_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(os.path.join(self.trace_dir, "trace.json"))

    def total(self) -> float:
        return sum(self.seconds.values())

    def summary(self) -> dict:
        """Per-phase seconds/calls/share, canonical phases first."""
        order = [p for p in PHASES if p in self.seconds]
        order += [p for p in self.seconds if p not in PHASES]
        tot = self.total()
        return {p: {"seconds": self.seconds[p], "calls": self.calls[p],
                    "share": self.seconds[p] / tot if tot > 0 else 0.0}
                for p in order}

    def table(self) -> str:
        rows = ["phase        seconds   share  brackets"]
        for p, d in self.summary().items():
            rows.append(f"{p:<10} {d['seconds']:>9.4f} {d['share']:>6.1%}"
                        f" {d['calls']:>9d}")
        return "\n".join(rows)
