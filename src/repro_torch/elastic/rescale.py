"""Elastic training runtime: rescale and fault tolerance (the counterpart of
``repro/elastic/rescale.py``).

The resource manager (CarbonFlexPolicy, MPC, any Policy) grants the job a
data-parallel degree ``k`` per interval; ``k = 0`` suspends it.  When ``k``
changes, the trainer checkpoints and restores its state (the paper's
scancel, checkpoint and resubmit, §5); any step failure, or an injected
fault, rolls back to the last checkpoint.  A step slower than
``straggler_factor`` times the rolling median marks a straggler.

The port runs the step on one device.  A ``k`` above the number of visible
devices raises, as the reference's ``make_mesh`` does; a ``k`` within it
runs the same step on the trainer's device (data parallelism across cards
waits for the sharding work, and changes no value: the reference's sharded
step computes the same loss), so a rescale between two such ``k`` is the
checkpoint round trip alone.  ``model_axis`` above 1 raises.

A step that fails rolls back and retries as in the reference, but a failure
that ``MAX_RETRIES`` rollbacks in a row do not cure (a kernel that fails
every launch, memory that is never freed) is raised, where the reference
would retry for ever.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import ModelConfig
from repro_torch.train import (CheckpointManager, OptimizerConfig, SyntheticLM,
                               TrainState, init_state, make_train_step, state_template)


MAX_RETRIES = 3


@dataclasses.dataclass
class RescalePlan:
    """One elastic allocation interval."""

    k: int                 # data-parallel degree (paper: servers for the job)
    steps: int             # train steps to run at this scale


def visible_devices(device: torch.device) -> int:
    """Devices a data-parallel mesh could span: the CUDA devices, or one host."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


class ElasticTrainer:
    def __init__(self, cfg: ModelConfig, data: SyntheticLM,
                 opt: OptimizerConfig, ckpt_dir: str,
                 model_axis: int = 1, seed: int = 0,
                 compression: Optional[Callable] = None,
                 straggler_factor: float = 3.0, device="cuda"):
        if model_axis != 1:
            raise NotImplementedError(
                f"model_axis={model_axis}: tensor parallelism waits for the sharding work")
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
        self._step_fn = None
        self.step_times: list[float] = []
        self.stragglers = 0
        self.rescales = 0
        self.recoveries = 0

    # ----- scale management -------------------------------------------------

    def _build(self, k: int) -> None:
        n = visible_devices(self.device)
        if k > n:
            raise ValueError(f"Number of devices {n} must be >= the product of "
                             f"mesh_shape ({k}, {self.model_axis})")
        self._step_fn = make_train_step(self.cfg, self.opt, compression=self.compression,
                                        ce_chunk=128)
        compressed = self.compression is not None
        if self._state is None:
            if self.ckpt.latest_step() is not None:
                self._state = self.ckpt.restore(state_template(self.cfg, compressed),
                                                device=self.device)
                self.recoveries += 1
            else:
                self._state = init_state(self.cfg, self.seed, self.device,
                                         compression=compressed)
        else:
            # live rescale: checkpoint -> restore at the new scale
            self.ckpt.save(self._state.step, self._state, blocking=True)
            self._state = self.ckpt.restore(self._state)
            self.rescales += 1
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
            # a phase advances state.step by phase.steps: after a fault
            # rollback the re-done steps are not counted twice
            target = self._state.step + phase.steps
            while self._state.step < target:
                step_no = self._state.step
                batch = {"tokens": torch.from_numpy(self.data.batch_at(step_no))
                         .to(self.device)}
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
                    if self.ckpt.latest_step() is not None:
                        self._state = self.ckpt.restore(self._state)
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
                    self.ckpt.save(step_no, self._state)
        self.ckpt.wait()
        self.ckpt.save(self._state.step, self._state, blocking=True)
        return {
            "losses": losses,
            "final_step": self._state.step,
            "rescales": self.rescales,
            "recoveries": self.recoveries,
            "stragglers": self.stragglers,
        }
