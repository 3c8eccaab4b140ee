"""Train-step builder: chunked cross-entropy and AdamW, optional gradient
compression (the counterpart of ``repro/train/step.py``).

The loss never holds the full (B, S, V) logits: the final hidden states are
projected to the vocabulary one chunk of positions at a time, each chunk
under a checkpoint, so the backward recomputes its logits.

On a mesh (``rules`` bound to ranks) the state is each rank's blocks
(``state_shardings``), the batch is split over (pod, data), and the step is
explicit SPMD: the loss is the global mean (each rank's sum over the
global count), logits split over the vocabulary take their max and sum
with ``pmax``/``psum`` over ``model``, the gradient of each leaf is summed
over the batch axes its blocks are not split on (a split leaf's gather
already summed it), and no leaf needs a sum over ``model``: the
tensor-parallel layer's ``copy``/``psum`` pairs leave every replicated
leaf with its whole gradient on every rank (``repro_torch/distributed.py``).
A batch that does not divide the batch axes is replicated over them, as
the reference's spec falls back (``batch_specs``, ``PrefetchLoader``,
``ElasticTrainer``): its tokens carry that ``Sharding`` as ``.sharding``,
and the step then runs under ``rules.replicating_batch()``: every rank
computes the whole batch and nothing is summed or gathered over the batch
axes, so the loss, the gradient and an MoE layer's global dispatch are the
one-device step's.

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

from repro_torch import distributed as D
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.common import LogicalRules, ModelConfig, Sharding, checkpoint

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


def _chunk_nll_split(xc: torch.Tensor, tc: torch.Tensor, head: torch.Tensor,
                     rules: LogicalRules):
    """``_chunk_nll`` over logits split over the vocabulary on ``model``:
    head is the rank's (d, V/model) block."""
    logits = (D.copy(xc, rules, "model") @ head.to(xc.dtype)).float()
    m = D.pmax(logits.amax(dim=-1), rules, "model")
    lse = torch.log(D.psum(torch.exp(logits - m[..., None]).sum(dim=-1), rules, "model")) + m
    vl = logits.shape[-1]
    rel = tc - rules.coords["model"] * vl
    own = (rel >= 0) & (rel < vl)
    picked = torch.take_along_dim(logits, rel.clamp(0, vl - 1)[..., None], dim=-1)[..., 0]
    picked = D.psum(torch.where(own, picked, 0.0), rules, "model")
    valid = tc >= 0
    return torch.where(valid, lse - picked, 0.0).sum(), valid.sum()


def chunked_cross_entropy(x: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
                          chunk: int = 512, prefix: int = 0,
                          rules: LogicalRules | None = None,
                          vocab_split: bool = False) -> torch.Tensor:
    """Mean next-token CE.  x: (B, S, d) final hidden; head: (d, V);
    targets: (B, St) token ids.  Position ``prefix + i`` predicts
    ``targets[:, i + 1]``; positions are taken ``chunk`` at a time (the last
    chunk padded with targets of -1, which count for nothing), each under a
    checkpoint, and the chunks' sums added in order.  With ``rules``: the
    rank's batch slice (and with ``vocab_split`` the rank's block of the
    head's vocabulary); returns the rank's sum over the global count,
    whose sum over the batch axes is the global mean."""
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
    fn, extra = (_chunk_nll_split, (rules,)) if vocab_split else (_chunk_nll, ())
    for c in range(nchunk):
        nll, n = checkpoint(fn, xs[:, c * chunk:(c + 1) * chunk],
                            tg[:, c * chunk:(c + 1) * chunk], head, *extra)
        total = total + nll
        count = count + n
    if rules is not None:
        count = D.all_reduce(count, rules, rules.batch_axes)
    return total / torch.clamp(count, min=1)


@dataclasses.dataclass
class TrainState:
    params: dict
    m: dict
    v: dict
    step: int
    ef: Optional[dict] = None      # gradient-compression error feedback


def init_state(cfg: ModelConfig, seed: int = 0, device="cuda",
               compression: bool = False, rules: LogicalRules | None = None) -> TrainState:
    """Master weights (every leaf in ``param_dtype``) from ``seed``, zero
    moments in ``moment_dtype``, a zero bf16 residual when ``compression``;
    with ``rules`` this rank's blocks of them (the same draws)."""
    params = api.init_params(cfg, seed, device, master=True)
    if rules is not None:
        params = api.shard_params(params, cfg, rules)
    m, v = init_moments(params, cfg.moment_dtype)
    ef = zeros_like_tree(params, torch.bfloat16) if compression else None
    return TrainState(params=params, m=m, v=v, step=0, ef=ef)


def _with_sharding(t: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    t.sharding = sharding
    return t


def abstract_state(cfg: ModelConfig, rules: LogicalRules,
                   compression: bool = False) -> TrainState:
    """A TrainState of ``meta`` tensors (whole shapes) each carrying its
    ``.sharding``: the reference's ``abstract_state``."""
    ps = api.param_shardings(cfg, rules)
    shapes = leaves(api.module_for(cfg).param_shapes(cfg))
    shards = dict(leaves(ps))

    def tree(dtype):
        return unflatten([p for p, _ in shapes],
                         [_with_sharding(torch.empty(s, dtype=dtype, device="meta"), shards[p])
                          for p, s in shapes])

    step = _with_sharding(torch.empty((), dtype=torch.int32, device="meta"), rules.sharding())
    return TrainState(params=tree(cfg.param_dtype), m=tree(cfg.moment_dtype),
                      v=tree(cfg.moment_dtype), step=step,
                      ef=tree(torch.bfloat16) if compression else None)


def state_shardings(cfg: ModelConfig, rules: LogicalRules,
                    compression: bool = False) -> TrainState:
    """Each state leaf's ``Sharding``: moments and residual as the params."""
    ps = api.param_shardings(cfg, rules)
    return TrainState(params=ps, m=ps, v=ps, step=rules.sharding(),
                      ef=ps if compression else None)


def batch_specs(cfg: ModelConfig, shape, rules: LogicalRules) -> dict:
    """``meta`` stand-ins of one global training batch with their
    ``.sharding`` (the batch over (pod, data))."""
    b, sl = shape.global_batch, shape.seq_len
    st = sl - cfg.prefix_len
    out = {"tokens": _with_sharding(torch.empty((b, st), dtype=torch.int32, device="meta"),
                                    rules.sharding("batch", "seq", dims=(b, st)))}
    if cfg.prefix_len:
        dims = (b, cfg.prefix_len, cfg.d_model)
        out["prefix_embeds"] = _with_sharding(
            torch.empty(dims, dtype=cfg.compute_dtype, device="meta"),
            rules.sharding("batch", "seq", "embed", dims=dims))
    return out


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


def state_from_reference(cfg: ModelConfig, tree: dict, device="cuda",
                         rules: LogicalRules | None = None) -> TrainState:
    """The port's TrainState from the reference's, given as a dict of numpy
    arrays: ``params``, ``m``, ``v`` (the reference's param dicts), ``step``
    and optionally ``ef``; each leaf in the reference's dtype (bf16 leaves
    as their 16 bits, numpy ``V2``).  With ``rules``, this rank's blocks."""
    dev = resolve_device(device)
    shards = dict(leaves(api.param_shardings(cfg, rules))) if rules is not None else {}

    def load(node, dtype):
        return unflatten(*zip(*[(p, _block(from_numpy(a, dtype).to(dev), shards.get(p)))
                                for p, a in leaves(node)]))

    params = api.params_from_reference(cfg, tree["params"], device=dev, master=True,
                                       rules=rules)
    ef = tree.get("ef")
    return TrainState(params=params, m=load(tree["m"], cfg.moment_dtype),
                      v=load(tree["v"], cfg.moment_dtype), step=int(np.asarray(tree["step"])),
                      ef=load(ef, torch.bfloat16) if ef is not None else None)


def _block(t: torch.Tensor, sharding: Sharding | None) -> torch.Tensor:
    return t if sharding is None else sharding.local(t)


def from_numpy(a, dtype: torch.dtype) -> torch.Tensor:
    """A host array as a CPU tensor of ``dtype``; bf16 leaves come as their
    16 bits (numpy has no bfloat16: the reference's files store them as
    ``V2``)."""
    a = np.asarray(a)
    if dtype == torch.bfloat16 and a.dtype.itemsize == 2 and a.dtype.kind == "V":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(dtype)


def _axes(sharding: Sharding, ndim: int) -> tuple[str, ...]:
    """Every mesh axis a leaf's blocks are split over."""
    return tuple(a for axes in sharding.dims(ndim) for a in axes)


def gather_whole(t: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """A leaf's block made whole on every rank of its mesh."""
    return D.gather_leaf(t, sharding.dims(t.dim()), sharding.rules)


def batch_rules(rules: LogicalRules | None, tokens: torch.Tensor) -> LogicalRules | None:
    """The rules a step on ``tokens`` runs under: ``rules``, or
    ``rules.replicating_batch()`` where the tokens' ``.sharding`` (set by
    ``PrefetchLoader`` and ``ElasticTrainer``) splits their batch over none of
    the batch axes.  Tokens without one are taken as split."""
    sh = getattr(tokens, "sharding", None)
    if rules is None or sh is None or not rules.batch_axes or sh.dims(tokens.dim())[0]:
        return rules
    return rules.replicating_batch()


def make_train_step(cfg: ModelConfig, opt: OptimizerConfig = OptimizerConfig(),
                    compression: Optional[Callable] = None, ce_chunk: int = 512,
                    rules: LogicalRules | None = None):
    """Returns train_step(state, batch) -> (new state, {"loss", "lr",
    "grad_norm"}), the metrics float32 0-d tensors.  ``batch``: "tokens"
    (B, St) and, for a prefix config, "prefix_embeds" (B, P, d), on the
    state's device.  The state passed in is left as it is.  With ``rules``
    (bound to ranks): the state is this rank's blocks (``state_shardings``),
    the batch its slice over (pod, data) (``batch_specs``), and the
    metrics are the global ones, equal on every rank; compression runs on
    the whole reduced gradient, as the reference's on its global gradient.
    Tokens whose ``.sharding`` replicates the batch run under
    ``batch_rules``."""
    from repro_torch.models import transformer

    vocab_split = transformer.split(cfg, rules, "", "embed", 0)
    shards = [sh for _, sh in leaves(api.param_shardings(cfg, rules))] if rules else None

    def loss_fn(params, batch, rules):
        x, head = api.forward(params, batch["tokens"], cfg, rules=rules, return_hidden=True,
                              prefix_embeds=batch.get("prefix_embeds"))
        return chunked_cross_entropy(x, head, batch["tokens"], chunk=ce_chunk,
                                     prefix=cfg.prefix_len, rules=rules,
                                     vocab_split=vocab_split)

    def reduce(grads, flat, rules):
        """Each leaf's gradient summed over the batch axes its blocks are
        not split on."""
        for i, ((_, t), sh) in enumerate(zip(flat, shards)):
            split = set(_axes(sh, t.dim()))
            grads[i] = D.all_reduce(grads[i], rules, tuple(a for a in rules.batch_axes
                                                            if a not in split))
        return grads

    def compress(paths, grads, ef):
        """The compressor on the whole leaves; this rank keeps its blocks."""
        if rules is None:
            g_tree, ef = compression(unflatten(paths, grads), ef)
            return [t for _, t in leaves(g_tree)], ef
        full = [gather_whole(g, sh) for g, sh in zip(grads, shards)]
        ef_full = (None if ef is None else unflatten(
            paths, [gather_whole(e, sh) for (_, e), sh in zip(leaves(ef), shards)]))
        g_tree, ef_full = compression(unflatten(paths, full), ef_full)
        sent = [sh.local(t) for (_, t), sh in zip(leaves(g_tree), shards)]
        return sent, unflatten(paths, [sh.local(t) for (_, t), sh
                                       in zip(leaves(ef_full), shards)])

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        flat = leaves(state.params)
        paths = [p for p, _ in flat]
        live = [t.detach().requires_grad_() for _, t in flat]
        step_rules = batch_rules(rules, batch["tokens"])
        with torch.enable_grad():
            loss = loss_fn(unflatten(paths, live), batch, step_rules)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, live)]
        del live
        loss = loss.detach()
        norm_axes = None
        if rules is not None:
            grads = reduce(grads, flat, step_rules)
            loss = D.all_reduce(loss, step_rules, step_rules.batch_axes)
            norm_axes = [_axes(sh, t.dim()) for (_, t), sh in zip(flat, shards)]
        ef = state.ef
        if compression is not None:
            grads, ef = compress(paths, grads, ef)
        params, m, v, lr, gnorm = adamw_update(
            [t for _, t in flat], grads, [t for _, t in leaves(state.m)],
            [t for _, t in leaves(state.v)], state.step, opt, cfg.moment_dtype,
            rules=rules, norm_axes=norm_axes)
        new_state = TrainState(params=unflatten(paths, params), m=unflatten(paths, m),
                               v=unflatten(paths, v), step=state.step + 1, ef=ef)
        return new_state, {"loss": loss, "lr": lr, "grad_norm": gnorm}

    return train_step
