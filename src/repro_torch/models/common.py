"""Shared model substrate: the config, norms, rotary embedding, attention
and the MLP, as pure functions over tensors, and the logical sharding
rules (the counterpart of ``repro/models/common.py``).

Sharding follows the reference's logical-axis rules: every tensor dimension
carries a logical name, and ``LogicalRules`` maps it to mesh axes with the
reference's ``spec`` semantics.  The reference hands the specs to GSPMD
through ``constrain``; here they place tensors explicitly: each rank holds
its shard of a leaf (``Sharding.local``), and the model code calls the
collectives of ``repro_torch/distributed.py`` where the layout needs them
(explicit SPMD), so ``constrain`` has no counterpart.  Dtype promotion
follows the reference step by step:
``rms_norm`` works in fp32 and returns the input dtype, ``rope`` mixes the
input with fp32 cos/sin and casts back, attention accumulates in fp32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

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


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell of the assigned grid."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# --------------------------------------------------------------------------
# logical sharding rules


DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,          # activation d_model
    "fsdp": "data",         # weight contracting / largest dim (ZeRO-3 style)
    "vocab": "model",
    "heads": "model",
    "kv": None,             # GQA kv heads usually < model axis -> replicate
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_mlp": None,
    "layers": None,
    "seq_sp": "model",      # sequence-parallel residual stream (opt-in)
    "cache_seq": "model",   # decode: sequence-sharded KV cache
    "cache_batch": ("pod", "data"),
    "ssm_state": None,
}


def axes_of(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry (None, an axis, or a tuple of axes)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class LogicalRules:
    """Maps logical axis names to mesh axes, validated against the mesh.

    ``mesh`` is a ``launch.mesh.Mesh`` (a description: specs only), a
    ``launch.mesh.DistMesh`` (bound to ranks: specs, local slices and the
    collectives) or a ``launch.mesh.StandInMesh`` (rank 0's view with no
    process group: the collectives recorded, not run)."""

    def __init__(self, mesh, overrides: dict[str, Any] | None = None):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES)
        if overrides:
            self.rules.update(overrides)

    @property
    def sizes(self) -> dict[str, int]:
        return self.mesh.sizes

    def size(self, axes) -> int:
        """The product of the extents of ``axes`` (an entry of a spec)."""
        return math.prod(self.sizes.get(a, 1) for a in axes_of(axes))

    @property
    def coords(self) -> dict:
        """This rank's coordinate on each axis (0 everywhere on a mesh of one
        device with no process group)."""
        coords = getattr(self.mesh, "coords", None)
        if coords is not None:
            return coords
        if self.mesh.devices != 1:
            raise ValueError(f"mesh {self.mesh.shape} spans {self.mesh.devices} devices: "
                             "bind it to the caller's process group (launch.mesh.DistMesh)")
        return {a: 0 for a in self.mesh.axes}

    def index(self, axes) -> int:
        """This rank's position along ``axes`` taken row-major, major axis
        first (the shard of a dim split over them)."""
        i = 0
        for a in axes_of(axes):
            i = i * self.sizes.get(a, 1) + (self.coords.get(a) or 0)
        return i

    def spec(self, *logical: Optional[str], dims: Sequence[int] | None = None) -> tuple:
        """The reference's PartitionSpec entries for the given logical dims:
        axes missing from the mesh dropped, replication where a dim size
        does not divide the mesh extent (minicpm's 36 heads on 16),
        trailing Nones stripped."""
        out = []
        for i, name in enumerate(logical):
            axes = axes_of(self.rules.get(name)) if name is not None else ()
            axes = tuple(a for a in axes if a in self.sizes)
            if not axes or (dims is not None and dims[i] % self.size(axes) != 0):
                out.append(None)
                continue
            out.append(axes[0] if len(axes) == 1 else axes)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def sharding(self, *logical: Optional[str], dims: Sequence[int] | None = None
                 ) -> "Sharding":
        return Sharding(self, self.spec(*logical, dims=dims))

    @property
    def batch_axes(self) -> tuple[str, ...]:
        """The mesh axes a batch is split over: the "batch" rule's axes in
        the mesh (("pod", "data") by default; none under
        ``replicating_batch``).  Every other axis holds replicas of a rank's
        batch slice."""
        return tuple(a for a in axes_of(self.rules.get("batch")) if a in self.sizes)

    def replicating_batch(self) -> "LogicalRules":
        """These rules with the batch replicated over the mesh, as the
        reference's spec falls back for a batch that does not divide the
        batch axes: every rank holds and computes all of it, so nothing is
        gathered or summed over the batch axes."""
        return LogicalRules(self.mesh, {**self.rules, "batch": None})

    @property
    def tp(self) -> int:
        """The ``model`` axis' extent."""
        return self.sizes.get("model", 1)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec under a set of rules (the counterpart of ``NamedSharding``):
    ``spec[i]`` names the mesh axes dim i is split over."""

    rules: LogicalRules
    spec: tuple

    def dims(self, ndim: int) -> tuple[tuple[str, ...], ...]:
        """The mesh axes of each of ``ndim`` dims (the spec padded)."""
        return tuple(axes_of(e) for e in self.spec) + ((),) * (ndim - len(self.spec))

    def local_shape(self, shape) -> tuple[int, ...]:
        return tuple(n // self.rules.size(a) for n, a in zip(shape, self.dims(len(shape))))

    def slices(self, shape) -> tuple[slice, ...]:
        """This rank's block of a leaf of ``shape``."""
        out = []
        for n, axes in zip(shape, self.dims(len(shape))):
            c = n // self.rules.size(axes)
            i = self.rules.index(axes)
            out.append(slice(i * c, (i + 1) * c))
        return tuple(out)

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole leaf ``full`` (a copy)."""
        return full[self.slices(full.shape)].clone()


def batch_rules(rules: LogicalRules | None, tokens: torch.Tensor) -> LogicalRules | None:
    """The rules a step on ``tokens`` runs under: ``rules``, or
    ``rules.replicating_batch()`` where the tokens' ``.sharding`` (set by
    ``PrefetchLoader``, ``ElasticTrainer`` and ``serve.greedy_generate``)
    splits their batch over none of the batch axes.  Tokens without one are
    taken as split.  The train step, the prefill and the decode step read
    it."""
    sh = getattr(tokens, "sharding", None)
    if rules is None or sh is None or not rules.batch_axes or sh.dims(tokens.dim())[0]:
        return rules
    return rules.replicating_batch()


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
