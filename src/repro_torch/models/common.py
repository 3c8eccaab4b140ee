"""Shared model substrate: the config, norms, rotary embedding, attention
and the MLP, as pure functions over tensors (the counterpart of
``repro/models/common.py``).

The port runs on one device, so the reference's logical sharding rules
(``LogicalRules``, ``constrain``) have no counterpart: on a 1×1 mesh they
are identities.  Dtype promotion follows the reference step by step:
``rms_norm`` works in fp32 and returns the input dtype, ``rope`` mixes the
input with fp32 cos/sin and casts back, attention accumulates in fp32.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels import flash_attention

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One assigned architecture (see ``repro_torch/configs/``)."""

    name: str
    family: str                    # "dense" | "moe" | "ssm" | "hybrid" | "vlm" | "audio"
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    shared_attn_every: int = 6     # zamba2: shared attention block period
    # frontend stubs
    prefix_len: int = 0            # vlm/audio: precomputed embedding prefix
    # numerics
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    moment_dtype: torch.dtype = torch.float32
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    use_bias: bool = False
    tie_embeddings: bool = False
    # training
    remat: str = "collectives"     # "full" | "dots" | "collectives" | "none"
    lr_schedule: str = "cosine"    # minicpm uses "wsd"
    sequence_parallel: bool = False
    # attention implementation: "flash" (the hand-written kernel, the
    # reference's "pallas") | "chunked" (plain torch, the reference's "xla")
    attention_backend: str = "flash"
    attention_chunk: int = 1024

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def param_count(self) -> int:
        """Analytic parameter count (the reference's formula)."""
        d, h = self.d_model, self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":                      # rwkv6-style
            att = self.num_layers * (d * d * 4 + d * d // 2)
            ff = self.num_layers * 2 * d * self.d_ff
            return emb + att + ff
        attn = self.num_layers * (
            d * self.num_heads * h + 2 * d * self.num_kv_heads * h
            + self.num_heads * h * d
        )
        if self.num_experts:
            ff = self.num_layers * (
                3 * d * self.d_ff * self.num_experts + d * self.num_experts
            )
        else:
            ff = self.num_layers * 3 * d * self.d_ff
        if self.family == "hybrid":                   # mamba2 blocks dominate
            ff = self.num_layers * 3 * d * self.d_ff
            attn = attn // max(self.num_layers // self.shared_attn_every, 1)
        return emb + attn + ff

    def active_param_count(self) -> int:
        """Per-token active params (MoE: only routed experts)."""
        if not self.num_experts:
            return self.param_count()
        d = self.d_model
        dense = self.param_count() - self.num_layers * 3 * d * self.d_ff * self.num_experts
        return dense + self.num_layers * 3 * d * self.d_ff * self.experts_per_token


# --------------------------------------------------------------------------
# initializer


def dense_init(shape, dtype: torch.dtype, generator: torch.Generator,
               in_axis: int = 0) -> torch.Tensor:
    """Unit normal over sqrt(fan_in), fan_in = ``shape[in_axis]``, drawn in
    fp32 on the generator's device and cast to ``dtype``."""
    fan_in = max(int(shape[in_axis]), 1) if shape else 1
    x = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return x.div_(math.sqrt(fan_in)).to(dtype)


# --------------------------------------------------------------------------
# building blocks


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * scale.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding; x: (..., seq, heads, head_dim)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions.float()[..., None] * freqs            # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal_offset: int, chunk: int) -> torch.Tensor:
    """Causal GQA attention as a loop over KV chunks with an online softmax
    (m, l, o) in fp32.  q: (B, Sq, H, D); k/v: (B, Sk, KV, D);
    ``causal_offset`` is the absolute position of q[0] minus k[0].  The last
    chunk is cut short where the reference pads and masks: padded keys
    weigh exactly 0 there."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, sq, hkv, group, d).float()
    scale = 1.0 / math.sqrt(d)
    q_pos = causal_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, hkv, group, sq), -math.inf, device=q.device)
    l = torch.zeros((b, hkv, group, sq), device=q.device)
    o = torch.zeros((b, hkv, group, sq, d), device=q.device)
    for start in range(0, sk, chunk):
        kb = k[:, start:start + chunk].float()
        vb = v[:, start:start + chunk].float()
        k_pos = start + torch.arange(kb.shape[1], device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kb) * scale
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vb)
        m = m_new
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


def attention(q, k, v, causal_offset: int, cfg: ModelConfig) -> torch.Tensor:
    if cfg.attention_backend == "flash":
        return flash_attention.gqa_flash(q, k, v, causal_offset=causal_offset)
    if cfg.attention_backend == "chunked":
        return chunked_attention(q, k, v, causal_offset, cfg.attention_chunk)
    raise ValueError(f"attention_backend {cfg.attention_backend!r}: use "
                     "'flash' or 'chunked'")


def remat_mode(cfg: ModelConfig) -> str:
    """What a forward checkpoints under ``cfg.remat`` (the reference's
    ``_remat``): "none" when grad mode is off or ``cfg.remat`` is "none"
    (every activation kept); "sublayers" for "collectives" (each sublayer
    under its own checkpoint, so only its output, the reference's
    ``attn_out``/``mlp_out``, is kept); "layer" for "full" and "dots" (the
    whole layer under one).  Recompute runs the same ops on the same
    inputs, so no bit moves."""
    if not torch.is_grad_enabled() or cfg.remat == "none":
        return "none"
    return "sublayers" if cfg.remat == "collectives" else "layer"


def checkpoint(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are recomputed in the backward instead of kept."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def layer(stacked: dict, *index) -> dict:
    """One layer's slice (views) of params stacked on leading layer axes."""
    return {name: t[index] for name, t in stacked.items()}


def heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) @ (d, H, hd) -> (B, S, H, hd), w cast to x's dtype."""
    b, s, d = x.shape
    return (x @ w.reshape(d, -1).to(x.dtype)).view(b, s, w.shape[1], w.shape[2])


def merge_heads(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) @ (H, hd, d) -> (B, S, d), w cast to o's dtype."""
    return o.flatten(2) @ w.reshape(-1, w.shape[-1]).to(o.dtype)


def swiglu(x, w_gate, w_up, w_down) -> torch.Tensor:
    h = x @ w_gate.to(x.dtype)
    u = x @ w_up.to(x.dtype)
    return (F.silu(h) * u) @ w_down.to(x.dtype)
