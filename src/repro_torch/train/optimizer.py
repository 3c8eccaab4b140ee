"""AdamW and the LR schedules (cosine and MiniCPM's WSD), the counterpart of
``repro/train/optimizer.py``.

The optimizer is hand-rolled, as the reference's: moments live in
``cfg.moment_dtype`` and every update is computed in float32, scalar by
scalar as ``jnp`` computes it (Python constants rounded to float32 where the
reference's weak types round them).  Updates are functional: new tensors
are returned and the inputs are left as they are, so a step can be run
twice from one state.
"""
from __future__ import annotations

import dataclasses
import math

import torch

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"       # "cosine" | "wsd" | "const"
    wsd_stable_frac: float = 0.8   # WSD: fraction of steps at peak LR


def lr_at(step, cfg: OptimizerConfig, device="cpu") -> torch.Tensor:
    """The learning rate at ``step`` (an int or a 0-d tensor) as a float32
    0-d tensor."""
    s = torch.as_tensor(step, device=device).to(F32)
    warm = torch.clamp((s + 1.0) / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "const":
        return cfg.lr * warm
    if cfg.schedule == "wsd":
        # Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395): hold peak LR for
        # the stable phase, then decay exponentially to 10%.
        stable_end = cfg.wsd_stable_frac * cfg.total_steps
        decay_len = max(cfg.total_steps - stable_end, 1.0)
        frac = torch.clamp((s - stable_end) / decay_len, 0.0, 1.0)
        decay = torch.pow(torch.tensor(0.1, dtype=F32, device=s.device), frac)
        return cfg.lr * warm * torch.where(s < stable_end, torch.ones_like(decay), decay)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return cfg.lr * warm * (0.5 * (1.0 + torch.cos(math.pi * prog)))


def global_norm(leaves, rules=None, norm_axes=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in float32, the
    leaves added left to right.  On a mesh (``rules``) each leaf is the
    rank's block: its sum of squares is summed over the axes its blocks
    are split on (``norm_axes[i]``), so each leaf counts once whether split
    or replicated."""
    total = None
    for i, x in enumerate(leaves):
        sq = torch.sum(torch.square(x.to(F32)))
        if rules is not None:
            from repro_torch.distributed import all_reduce

            sq = all_reduce(sq, rules, norm_axes[i])
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads: list, max_norm: float, rules=None, norm_axes=None):
    """Scale the leaves of ``grads`` to ``max_norm`` where their global norm
    exceeds it, as ``(g.f32 * scale).astype(g.dtype)``.  Returns (grads,
    norm).  The list's entries are replaced one by one, so no second copy
    of the gradients is ever whole."""
    norm = global_norm(grads, rules, norm_axes)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for i, g in enumerate(grads):
        grads[i] = (g.to(F32) * scale).to(g.dtype)
    return grads, norm


def zeros_like_tree(tree: dict, dtype: torch.dtype) -> dict:
    """Zeros of ``dtype`` shaped as each leaf of a nested dict, on its device."""
    return {k: zeros_like_tree(v, dtype) if isinstance(v, dict) else
            torch.zeros(v.shape, dtype=dtype, device=v.device) for k, v in tree.items()}


def init_moments(params: dict, moment_dtype: torch.dtype) -> tuple[dict, dict]:
    """Zero first and second moments shaped as ``params``."""
    return zeros_like_tree(params, moment_dtype), zeros_like_tree(params, moment_dtype)


def adamw_update(params, grads, m, v, step, opt: OptimizerConfig, moment_dtype,
                 rules=None, norm_axes=None):
    """One AdamW step over parallel lists of leaves, the gradients clipped
    to ``opt.grad_clip`` by their global norm.  Returns (params, m, v, lr,
    grad_norm), the first three as new lists.  Each leaf's arithmetic is
    the reference's operation for operation; it runs in place on the
    leaf's fresh temporaries, and each entry of the list ``grads`` is
    clipped in place and set to None once used, so the gradients are freed
    as the new state grows and at most a few leaf-sized tensors are live
    beside the two states (at internvl2-2b's largest leaf, 1.6 GB each).
    On a mesh each rank updates its blocks; only the norm crosses ranks
    (``global_norm``)."""
    grads, gnorm = clip_by_global_norm(grads, opt.grad_clip, rules, norm_axes)
    dev = gnorm.device
    lr = lr_at(step, opt, dev)
    t = torch.as_tensor(step, device=dev).to(F32) + 1.0
    bc1 = 1.0 - torch.pow(torch.tensor(opt.b1, dtype=F32, device=dev), t)
    bc2 = 1.0 - torch.pow(torch.tensor(opt.b2, dtype=F32, device=dev), t)

    new_p, new_m, new_v = [], [], []
    for i, (p, m_, v_) in enumerate(zip(params, m, v)):
        g32, grads[i] = grads[i].to(F32), None
        m_new = m_.to(F32) * opt.b1
        m_new += g32 * (1 - opt.b1)
        v_new = v_.to(F32) * opt.b2
        g32.square_()
        g32 *= 1 - opt.b2
        v_new += g32
        del g32
        delta = m_new / bc1                      # mhat
        den = v_new / bc2                        # vhat
        den.sqrt_()
        den += opt.eps
        delta /= den
        del den
        p32 = p.to(F32)
        delta += p32 * opt.weight_decay
        delta *= lr
        new_p.append((p32 - delta).to(p.dtype))
        del delta
        new_m.append(m_new.to(moment_dtype))
        new_v.append(v_new.to(moment_dtype))
    return new_p, new_m, new_v, lr, gnorm
