"""Data pipeline: deterministic synthetic LM batches with host-side prefetch
and device placement (the counterpart of ``repro/train/data.py``).

No text corpora ship with the repo, so the pipeline draws Zipf-distributed
token streams.  Each batch is seeded by (seed, step), so a run resumed from
step N regenerates batches N, N+1, ... exactly.  The numpy draws are the
reference's, call for call, so the batches equal its bit for bit.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass
class DataConfig:
    batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    zipf_a: float = 1.2
    prefetch: int = 2


class SyntheticLM:
    """Deterministic Zipf token batches; index-addressable for restart."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = 1.0 / np.power(ranks, cfg.zipf_a)
        self._p = p / p.sum()

    def batch_at(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step]))
        return rng.choice(
            self.cfg.vocab_size,
            size=(self.cfg.batch, self.cfg.seq_len),
            p=self._p,
        ).astype(np.int32)


class PrefetchLoader:
    """A host thread keeps ``prefetch`` batches ready; ``next`` places one on
    ``device`` (through pinned memory on a CUDA device).  For a config with
    ``prefix_len`` each batch carries ``prefix_embeds`` (B, P, d) float32,
    drawn from ``SeedSequence([seed, step, 7])`` as the reference draws them.
    ``sharding``: a ``Sharding`` (or a dict of them by key, as
    ``train.batch_specs`` gives) placing this rank's block of each batch,
    the reference's device placement under a ``NamedSharding``; each placed
    tensor carries its ``Sharding`` as ``.sharding`` (a batch replicated over
    the batch axes is the whole batch on every rank, ``models.common.batch_rules``)."""

    def __init__(self, source: SyntheticLM, start_step: int = 0, device="cuda",
                 model_cfg: Optional[ModelConfig] = None, sharding=None):
        self.source = source
        self.sharding = sharding
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self._q: queue.Queue = queue.Queue(maxsize=source.cfg.prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _make(self, step: int) -> dict:
        tokens = self.source.batch_at(step)
        batch = {"tokens": tokens}
        if self.model_cfg is not None and self.model_cfg.prefix_len:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.source.cfg.seed, step, 7]))
            batch["prefix_embeds"] = rng.normal(
                0, 0.02, (tokens.shape[0], self.model_cfg.prefix_len,
                          self.model_cfg.d_model)).astype(np.float32)
        return batch

    def _work(self):
        while not self._stop.is_set():
            try:
                self._q.put(self._make(self._step), timeout=0.5)
                self._step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        host = self._q.get()
        out = {}
        for k, v in host.items():
            t = torch.from_numpy(v)
            sh = self.sharding.get(k) if isinstance(self.sharding, dict) else self.sharding
            if sh is not None:
                sh = getattr(sh, "sharding", sh)       # a batch_specs stand-in
                t = sh.local(t)
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            if sh is not None:
                t.sharding = sh                        # the train step reads it
            out[k] = t
        return out

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
