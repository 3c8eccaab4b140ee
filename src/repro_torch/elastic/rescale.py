"""Elastic training runtime: rescale and fault tolerance (the counterpart of
``repro/elastic/rescale.py``).

The resource manager (CarbonFlexPolicy, MPC, any Policy) grants the job a
data-parallel degree ``k`` per interval; ``k = 0`` suspends it.  The
trainer runs the train step on a mesh (k, ``model_axis``), axes ("data",
"model"); when ``k`` changes it checkpoints, builds the new mesh and
restores the state under the new shardings (the paper's scancel,
checkpoint and resubmit, §5); any step failure, or an injected fault,
rolls back to the last checkpoint.  A step slower than
``straggler_factor`` times the rolling median marks a straggler.

The trainer runs in every rank of the caller's process group (a world of
one without one).  A phase at scale k builds its mesh over the first
k * model_axis ranks (``launch.mesh.DistMesh``: every rank builds each
mesh, as ``new_group`` is collective over the world); the other ranks sit
the phase out.  k * model_axis above the world size raises ``ValueError``,
as the reference's ``make_mesh`` does.  Each rank holds its blocks of the
state; a checkpoint gathers them and the first rank writes the reference's
files.  ``run`` returns the same dict on every rank (the first rank's).

A step that fails rolls back and retries as in the reference, but a failure
that ``MAX_RETRIES`` rollbacks in a row do not cure (a kernel that fails
every launch, memory that is never freed) is raised, where the reference
would retry for ever.  The ranks of a mesh roll back to the step its first
rank agrees on; a failure on one rank alone is not handled.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import distributed as D
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import DistMesh, make_mesh
from repro_torch.models.common import LogicalRules, ModelConfig
from repro_torch.train import (CheckpointManager, OptimizerConfig, SyntheticLM,
                               TrainState, init_state, make_train_step, state_shardings,
                               state_template)


MAX_RETRIES = 3


@dataclasses.dataclass
class RescalePlan:
    """One elastic allocation interval."""

    k: int                 # data-parallel degree (paper: servers for the job)
    steps: int             # train steps to run at this scale


def world_size() -> int:
    """The ranks of the caller's process group (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class ElasticTrainer:
    def __init__(self, cfg: ModelConfig, data: SyntheticLM,
                 opt: OptimizerConfig, ckpt_dir: str,
                 model_axis: int = 1, seed: int = 0,
                 compression: Optional[Callable] = None,
                 straggler_factor: float = 3.0, device="cuda"):
        self.cfg = cfg
        self.data = data
        self.opt = opt
        self.model_axis = model_axis
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(ckpt_dir)
        self.compression = compression
        self.straggler_factor = straggler_factor
        self.seed = seed
        self._state: Optional[TrainState] = None
        self._k = 0
        self._built = False
        self._rules: Optional[LogicalRules] = None
        self._step_fn = None
        self.step_times: list[float] = []
        self.stragglers = 0
        self.rescales = 0
        self.recoveries = 0

    # ----- scale management -------------------------------------------------

    @property
    def member(self) -> bool:
        """Whether this rank is in the current phase's mesh."""
        return self._rules is not None and self._rules.mesh.member

    def _shardings(self):
        return state_shardings(self.cfg, self._rules, self.compression is not None)

    def _save(self, step: int, blocking: bool = False) -> None:
        self.ckpt.save(step, self._state, blocking=blocking, shardings=self._shardings())

    def _restore(self, step: Optional[int] = None) -> TrainState:
        return self.ckpt.restore(state_template(self.cfg, self.compression is not None),
                                 step=step, device=self.device, shardings=self._shardings())

    def _agree(self, value: int) -> int:
        """The mesh's first rank's ``value``, on every rank of the mesh."""
        rules = self._rules
        first = all(rules.coords[a] == 0 for a in rules.mesh.axes)
        t = torch.tensor(value if first else 0, dtype=torch.int64, device=self.device)
        return int(D.all_reduce(t, rules, rules.mesh.axes))

    def _build(self, k: int) -> None:
        n = world_size()
        if k * self.model_axis > n:
            raise ValueError(f"Number of devices {n} must be >= the product of "
                             f"mesh_shape ({k}, {self.model_axis})")
        if self._built:
            # live rescale: the old mesh checkpoints, the new one restores
            if self.member:
                self._save(self._state.step, blocking=True)
            if n > 1:
                dist.barrier()
        backend = dist.get_backend() if n > 1 or dist.is_initialized() else None
        mesh = DistMesh(make_mesh((k, self.model_axis), ("data", "model")),
                        device_type="cuda" if backend == "nccl" else "cpu")
        self._rules = LogicalRules(mesh)
        self._step_fn = make_train_step(self.cfg, self.opt, compression=self.compression,
                                        ce_chunk=128, rules=self._rules)
        compressed = self.compression is not None
        if not self.member:
            self._state = None
        elif self._built:
            self._state = self._restore()
            self.rescales += 1
        elif self.ckpt.latest_step() is not None:
            self._state = self._restore()
            self.recoveries += 1
        else:
            self._state = init_state(self.cfg, self.seed, self.device,
                                     compression=compressed, rules=self._rules)
        self._built = True
        self._k = k

    def set_scale(self, k: int) -> None:
        if k != self._k:
            self._build(k)

    # ----- training ---------------------------------------------------------

    def run(self, plan: list[RescalePlan], checkpoint_every: int = 50,
            fault_at: Optional[int] = None) -> dict:
        """Execute an elastic plan; ``fault_at``: inject a failure at that
        global step (the trainer must recover from the last checkpoint)."""
        losses = []
        faulted = False
        failures = 0               # failed steps since the last one that ran
        for phase in plan:
            if phase.k <= 0:       # suspended (paper: job paused at high CI)
                continue
            self.set_scale(phase.k)
            if not self.member:
                continue
            # a phase advances state.step by phase.steps: after a fault
            # rollback the re-done steps are not counted twice
            target = self._state.step + phase.steps
            while self._state.step < target:
                step_no = self._state.step
                tokens = torch.from_numpy(self.data.batch_at(step_no))
                tokens = self._rules.sharding("batch", "seq", dims=tuple(tokens.shape)
                                              ).local(tokens)
                batch = {"tokens": tokens.to(self.device)}
                t0 = time.time()
                try:
                    if fault_at is not None and step_no == fault_at and not faulted:
                        faulted = True
                        raise RuntimeError("injected node failure")
                    self._state, metrics = self._step_fn(self._state, batch)
                    loss = float(metrics["loss"])
                except RuntimeError:
                    # fault: restore the last checkpoint and continue, unless
                    # rollbacks have not cured it MAX_RETRIES times in a row
                    failures += 1
                    if failures > MAX_RETRIES:
                        raise
                    self.ckpt.wait()
                    latest = self._agree(-1 if self.ckpt.latest_step() is None
                                         else self.ckpt.latest_step())
                    if latest >= 0:
                        self._state = self._restore(latest)
                    self.recoveries += 1
                    continue
                failures = 0
                dt = time.time() - t0
                self.step_times.append(dt)
                med = float(np.median(self.step_times[-20:]))
                if len(self.step_times) > 5 and dt > self.straggler_factor * med:
                    self.stragglers += 1
                losses.append(loss)
                if step_no and step_no % checkpoint_every == 0:
                    self._save(step_no)
        self.ckpt.wait()
        if self.member:
            self._save(self._state.step, blocking=True)
        out = {
            "losses": losses,
            "final_step": None if self._state is None else self._state.step,
            "rescales": self.rescales,
            "recoveries": self.recoveries,
            "stragglers": self.stragglers,
        }
        if world_size() > 1:
            box = [out]
            dist.broadcast_object_list(box, src=0)
            out = box[0]
        return out
