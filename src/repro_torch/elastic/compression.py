"""Error-feedback gradient compression for the data-parallel all-reduce (the
counterpart of ``repro/elastic/compression.py``).

- ``int8``: per-tensor max-abs scaling to int8 (4x fewer bytes than fp32);
- ``topk``: keep the largest ``ratio`` fraction of entries per tensor.

Both keep a bf16 error-feedback residual, so the quantisation error is fed
back into the next step's gradient.  Each step is the reference's float32
expression; ``torch.round`` rounds half to even, as ``jnp.round`` does, and
``torch.topk`` picks the same threshold, so the results equal the
reference's bit for bit.  Compress and decompress run back to back, as in
the reference's jitted step.  On a mesh the train step
(``train/step.py::make_train_step``) hands the compressor the whole reduced
gradient of each leaf (gathered from the ranks' blocks) and keeps this
rank's block of what it returns, as the reference compresses its global
gradient: a per-tensor scale or top-k threshold is the whole leaf's.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.train.step import leaves, unflatten

def _int8_roundtrip(g32: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q.to(torch.float32) * scale


def _topk_roundtrip(g32: torch.Tensor, ratio: float) -> torch.Tensor:
    flat = g32.reshape(-1)
    k = max(int(flat.shape[0] * ratio), 1)
    thresh = torch.topk(torch.abs(flat), k).values[-1]
    kept = torch.where(torch.abs(flat) >= thresh, flat, 0.0)
    return kept.reshape(g32.shape)


def make_compressor(kind: str = "int8", ratio: float = 0.05
                    ) -> Callable[[dict, Optional[dict]], tuple[dict, dict]]:
    """Returns compress(grads, ef) -> (decompressed grads, new ef), both
    nested dicts shaped as ``grads``."""

    def compress(grads: dict, ef: Optional[dict]):
        paths, sent_leaves, ef_leaves = [], [], []
        old = dict(leaves(ef)) if ef is not None else {}
        for path, g in leaves(grads):
            e = old.get(path)        # no residual yet: zeros, as the reference's
            g32 = g.to(torch.float32) + (e.to(torch.float32) if e is not None else 0.0)
            if kind == "int8":
                sent = _int8_roundtrip(g32)
            elif kind == "topk":
                sent = _topk_roundtrip(g32, ratio)
            else:
                raise ValueError(kind)
            paths.append(path)
            sent_leaves.append(sent.to(g.dtype))
            ef_leaves.append((g32 - sent).to(torch.bfloat16))
        return unflatten(paths, sent_leaves), unflatten(paths, ef_leaves)

    return compress
