"""Train-step builder: chunked cross-entropy and AdamW, optional gradient
compression (the counterpart of ``repro/train/step.py``).

The loss never holds the full (B, S, V) logits: the final hidden states are
projected to the vocabulary one chunk of positions at a time, each chunk
under a checkpoint, so the backward recomputes its logits.  The port runs
on one device, so the reference's sharding helpers (``abstract_state``,
``state_shardings``, ``batch_specs``) wait for the sharding work.

Parameters, moments and the error-feedback residual are nested dicts of
tensors; the optimizer walks their leaves in sorted key order, the order of
``jax.tree.leaves`` on the reference's dicts.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.common import ModelConfig, checkpoint

from .optimizer import OptimizerConfig, adamw_update, init_moments, zeros_like_tree


def leaves(tree: dict, prefix: tuple = ()) -> list[tuple[tuple, torch.Tensor]]:
    """(path, leaf) of a nested dict in sorted key order."""
    out = []
    for key in sorted(tree):
        v = tree[key]
        if isinstance(v, dict):
            out.extend(leaves(v, prefix + (key,)))
        else:
            out.append((prefix + (key,), v))
    return out


def unflatten(paths, values) -> dict:
    out: dict = {}
    for path, v in zip(paths, values):
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = v
    return out


def _chunk_nll(xc: torch.Tensor, tc: torch.Tensor, head: torch.Tensor):
    logits = (xc @ head.to(xc.dtype)).float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.take_along_dim(logits, torch.clamp(tc, min=0)[..., None], dim=-1)[..., 0]
    valid = tc >= 0
    return torch.where(valid, lse - picked, 0.0).sum(), valid.sum()


def chunked_cross_entropy(x: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
                          chunk: int = 512, prefix: int = 0) -> torch.Tensor:
    """Mean next-token CE.  x: (B, S, d) final hidden; head: (d, V);
    targets: (B, St) token ids.  Position ``prefix + i`` predicts
    ``targets[:, i + 1]``; positions are taken ``chunk`` at a time (the last
    chunk padded with targets of -1, which count for nothing), each under a
    checkpoint, and the chunks' sums added in order."""
    st = targets.shape[1]
    xs = x[:, prefix: prefix + st - 1]
    tg = targets[:, 1:].long()
    if xs.shape[1] != tg.shape[1]:
        raise ValueError(f"the hidden states hold {xs.shape[1]} positions after a prefix of "
                         f"{prefix}, the targets need {tg.shape[1]}: a config with "
                         "prefix_len needs the batch's prefix_embeds")
    b, s, d = xs.shape
    nchunk = max(math.ceil(s / chunk), 1)
    pad = nchunk * chunk - s
    if pad:
        xs = torch.nn.functional.pad(xs, (0, 0, 0, pad))
        tg = torch.nn.functional.pad(tg, (0, pad), value=-1)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.int64, device=x.device)
    for c in range(nchunk):
        nll, n = checkpoint(_chunk_nll, xs[:, c * chunk:(c + 1) * chunk],
                            tg[:, c * chunk:(c + 1) * chunk], head)
        total = total + nll
        count = count + n
    return total / torch.clamp(count, min=1)


@dataclasses.dataclass
class TrainState:
    params: dict
    m: dict
    v: dict
    step: int
    ef: Optional[dict] = None      # gradient-compression error feedback


def init_state(cfg: ModelConfig, seed: int = 0, device="cuda",
               compression: bool = False) -> TrainState:
    """Master weights (every leaf in ``param_dtype``) from ``seed``, zero
    moments in ``moment_dtype``, a zero bf16 residual when ``compression``."""
    params = api.init_params(cfg, seed, device, master=True)
    m, v = init_moments(params, cfg.moment_dtype)
    ef = zeros_like_tree(params, torch.bfloat16) if compression else None
    return TrainState(params=params, m=m, v=v, step=0, ef=ef)


def state_template(cfg: ModelConfig, compression: bool = False) -> TrainState:
    """A TrainState of tensors on the ``meta`` device (shapes and dtypes, no
    storage): what ``CheckpointManager.restore`` needs to load a state."""
    shapes = leaves(api.module_for(cfg).param_shapes(cfg))

    def tree(dtype):
        return unflatten([p for p, _ in shapes],
                         [torch.empty(s, dtype=dtype, device="meta") for _, s in shapes])

    return TrainState(params=tree(cfg.param_dtype), m=tree(cfg.moment_dtype),
                      v=tree(cfg.moment_dtype), step=0,
                      ef=tree(torch.bfloat16) if compression else None)


def state_from_reference(cfg: ModelConfig, tree: dict, device="cuda") -> TrainState:
    """The port's TrainState from the reference's, given as a dict of numpy
    arrays: ``params``, ``m``, ``v`` (the reference's param dicts), ``step``
    and optionally ``ef``; each leaf in the reference's dtype (bf16 leaves
    as their 16 bits, numpy ``V2``)."""
    dev = resolve_device(device)

    def load(node, dtype):
        return unflatten(*zip(*[(p, from_numpy(a, dtype).to(dev)) for p, a in leaves(node)]))

    params = api.params_from_reference(cfg, tree["params"], device=dev, master=True)
    ef = tree.get("ef")
    return TrainState(params=params, m=load(tree["m"], cfg.moment_dtype),
                      v=load(tree["v"], cfg.moment_dtype), step=int(np.asarray(tree["step"])),
                      ef=load(ef, torch.bfloat16) if ef is not None else None)


def from_numpy(a, dtype: torch.dtype) -> torch.Tensor:
    """A host array as a CPU tensor of ``dtype``; bf16 leaves come as their
    16 bits (numpy has no bfloat16: the reference's files store them as
    ``V2``)."""
    a = np.asarray(a)
    if dtype == torch.bfloat16 and a.dtype.itemsize == 2 and a.dtype.kind == "V":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(dtype)


def make_train_step(cfg: ModelConfig, opt: OptimizerConfig = OptimizerConfig(),
                    compression: Optional[Callable] = None, ce_chunk: int = 512):
    """Returns train_step(state, batch) -> (new state, {"loss", "lr",
    "grad_norm"}), the metrics float32 0-d tensors.  ``batch``: "tokens"
    (B, St) and, for a prefix config, "prefix_embeds" (B, P, d), on the
    state's device.  The state passed in is left as it is."""

    def loss_fn(params, batch):
        x, head = api.forward(params, batch["tokens"], cfg, return_hidden=True,
                              prefix_embeds=batch.get("prefix_embeds"))
        return chunked_cross_entropy(x, head, batch["tokens"], chunk=ce_chunk,
                                     prefix=cfg.prefix_len)

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        flat = leaves(state.params)
        paths = [p for p, _ in flat]
        live = [t.detach().requires_grad_() for _, t in flat]
        with torch.enable_grad():
            loss = loss_fn(unflatten(paths, live), batch)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, live)]
        del live
        ef = state.ef
        if compression is not None:
            g_tree, ef = compression(unflatten(paths, grads), ef)
            grads = [t for _, t in leaves(g_tree)]
        params, m, v, lr, gnorm = adamw_update(
            [t for _, t in flat], grads, [t for _, t in leaves(state.m)],
            [t for _, t in leaves(state.v)], state.step, opt, cfg.moment_dtype)
        new_state = TrainState(params=unflatten(paths, params), m=unflatten(paths, m),
                               v=unflatten(paths, v), step=state.step + 1, ef=ef)
        return new_state, {"loss": loss.detach(), "lr": lr, "grad_norm": gnorm}

    return train_step
