"""Dense / MoE decoder-only transformer (GQA + RoPE + SwiGLU), the
counterpart of ``repro/models/transformer.py`` for the transformer families
(dense, moe, vlm, audio).

Parameters are a dict of tensors stacked on a leading ``layers`` axis, as
the reference's; the layer loop is a Python loop where the reference scans.
Prefill attention goes through ``common.attention`` (the flash kernel by
default).  MoE layers route by the reference's sort-based capacity
dispatch (``moe_block_global``); the port runs on one device, so the
reference's expert-parallel route (``_moe_local_dispatch``, shard_map over
the ``model`` axis) has no counterpart here.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import (ModelConfig, attention, checkpoint, heads, merge_heads, remat_mode, rms_norm,
                     rope, swiglu)


def param_shapes(cfg: ModelConfig) -> dict:
    L, d, hd = cfg.num_layers, cfg.d_model, cfg.resolved_head_dim
    H, KV, f = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    layers = {
        "ln1": (L, d), "ln2": (L, d),
        "wq": (L, d, H, hd), "wk": (L, d, KV, hd), "wv": (L, d, KV, hd),
        "wo": (L, H, hd, d),
    }
    if cfg.num_experts:
        E = cfg.num_experts
        layers.update({
            "router": (L, d, E),
            "w_gate": (L, E, d, f), "w_up": (L, E, d, f), "w_down": (L, E, f, d),
        })
    else:
        layers.update({"w_gate": (L, d, f), "w_up": (L, d, f), "w_down": (L, f, d)})
    out = {"embed": (cfg.vocab_size, d), "layers": layers, "ln_f": (d,)}
    if not cfg.tie_embeddings:
        out["lm_head"] = (d, cfg.vocab_size)
    return out


def qkv(h: torch.Tensor, lp: dict, li: int):
    """Layer ``li``'s q (B, S, H, hd) and k/v (B, S, KV, hd) of h (B, S, d)."""
    return heads(h, lp["wq"][li]), heads(h, lp["wk"][li]), heads(h, lp["wv"][li])


def attn_out(o: torch.Tensor, lp: dict, li: int) -> torch.Tensor:
    """(B, S, H, hd) @ wo[li] (H, hd, d) -> (B, S, d)."""
    return merge_heads(o, lp["wo"][li])


# --------------------------------------------------------------------------
# MoE layer (sort-based capacity dispatch)


class Routing(NamedTuple):
    """One MoE dispatch of T tokens to K of E experts, C slots each.
    ``gate``/``eidx`` (T, K): the normalised fp32 gates and expert ids of
    each token's top-K; the rest is indexed by position in the stable sort
    of the (T*K,) flat expert ids: ``order`` the flat pair at each position,
    ``keep`` whether it found a slot (rank within its expert < C), ``slot``
    its row in the (E*C + 1)-row buffer (E*C, the trash row, when dropped),
    ``src_tok`` its token."""

    gate: torch.Tensor
    eidx: torch.Tensor
    order: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    src_tok: torch.Tensor


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` tokens, the reference's float64
    expression left to right (no floor of 1: a decode step of 4 tokens on
    qwen3's 128 experts gets C = 1)."""
    return int(math.ceil(tokens * cfg.experts_per_token / cfg.num_experts
                         * cfg.capacity_factor))


def moe_route(probs: torch.Tensor, k: int, cap: int) -> Routing:
    """Route router probabilities ``probs`` (T, E) fp32 as the reference's
    ``moe_block_global``.  Top-K is the first K of a stable descending sort,
    so equal probabilities pick the lower expert id first, as ``lax.top_k``
    does; the flat pairs sort stably by expert and each keeps its rank
    among its expert's pairs, so an expert's later pairs are the ones
    dropped."""
    t, e = probs.shape
    gate, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = gate[:, :k], eidx[:, :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    flat_e = eidx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    ranks = torch.arange(t * k, device=probs.device) - first
    keep = ranks < cap
    slot = torch.where(keep, sorted_e * cap + ranks, e * cap)
    return Routing(gate, eidx, order, slot, keep, order // k)


def moe_experts(eb: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """SwiGLU of every expert on its C slots: eb (E, C, d) -> (E, C, d),
    three batched products in eb's dtype."""
    h = torch.bmm(eb, w_gate.to(eb.dtype))
    u = torch.bmm(eb, w_up.to(eb.dtype))
    return torch.bmm(F.silu(h) * u, w_down.to(eb.dtype))


def moe_combine(yb: torch.Tensor, r: Routing) -> torch.Tensor:
    """Each token's output: its kept experts' rows of yb (E, C, d) times
    their gates, summed in yb's dtype.  The reference scatter-adds the
    contributions in sorted order, which reaches each token's pairs in
    ascending expert id; here each token's K contributions are gathered in
    that order and added left to right, so the sum is the same on every
    run (no atomics) and its order the reference's."""
    e, c, d = yb.shape
    t, k = r.eidx.shape
    ybuf = torch.cat([yb.reshape(e * c, d), yb.new_zeros((1, d))])
    weight = (r.gate.reshape(-1)[r.order] * r.keep).to(yb.dtype)
    pos = torch.empty_like(r.order)
    pos[r.order] = torch.arange(t * k, device=pos.device)
    pos = pos.view(t, k).sort(dim=-1).values     # sorted positions, by expert
    y = yb.new_zeros((t, d))
    for j in range(k):
        p = pos[:, j]
        y = y + ybuf[r.slot[p]] * weight[p, None]
    return y


def moe_block_global(x: torch.Tensor, lp: dict, li: int, cfg: ModelConfig) -> torch.Tensor:
    """Layer ``li``'s MoE block on x (B, S, d): router logits in x's dtype,
    softmax in fp32, ``moe_route`` over the B*S tokens (batch-major) with
    ``capacity`` slots per expert, the kept tokens scattered into an
    (E*C + 1, d) buffer whose last row is trash, the experts, the combine."""
    b, s, d = x.shape
    t = b * s
    e = cfg.num_experts
    cap = capacity(cfg, t)
    xt = x.reshape(t, d)
    logits = xt @ lp["router"][li].to(x.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    r = moe_route(probs, cfg.experts_per_token, cap)
    buf = x.new_zeros((e * cap + 1, d))
    buf[r.slot] = xt[r.src_tok] * r.keep[:, None].to(x.dtype)
    yb = moe_experts(buf[:e * cap].view(e, cap, d), lp["w_gate"][li],
                     lp["w_up"][li], lp["w_down"][li])
    return moe_combine(yb, r).view(b, s, d)


def moe_block(x: torch.Tensor, lp: dict, li: int, cfg: ModelConfig) -> torch.Tensor:
    """The reference's ``moe_block`` on one device: a mesh with no ``model``
    axis above 1 takes the global dispatch."""
    return moe_block_global(x, lp, li, cfg)


def mlp(x: torch.Tensor, lp: dict, li: int, cfg: ModelConfig) -> torch.Tensor:
    h2 = rms_norm(x, lp["ln2"][li], cfg.norm_eps)
    if cfg.num_experts:
        return moe_block(h2, lp, li, cfg)
    return swiglu(h2, lp["w_gate"][li], lp["w_up"][li], lp["w_down"][li])


def attention_block(x, lp: dict, li: int, cfg: ModelConfig, positions):
    """Layer ``li``'s attention sublayer: (its output (B, S, d), (k, v)), the
    fresh K/V after rope on k."""
    h = rms_norm(x, lp["ln1"][li], cfg.norm_eps)
    q, k, v = qkv(h, lp, li)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, 0, cfg)
    return attn_out(o, lp, li), (k, v)


def decoder_layer(x, lp: dict, li: int, cfg: ModelConfig, positions):
    """Layer ``li`` of the stacked params.  Returns (out, (k, v)): the fresh
    K/V (after rope on k) build the prefill cache."""
    a, kv = attention_block(x, lp, li, cfg, positions)
    x = x + a
    x = x + mlp(x, lp, li, cfg)
    return x, kv


def remat_layer(x, lp: dict, li: int, cfg: ModelConfig, positions, mode: str):
    """``decoder_layer`` as ``remat_mode`` says: "sublayers" checkpoints the
    attention and the MLP sublayers apart, "layer" the whole layer."""
    if mode == "none":
        return decoder_layer(x, lp, li, cfg, positions)
    if mode == "sublayers":
        a, kv = checkpoint(attention_block, x, lp, li, cfg, positions)
        x = x + a
        return x + checkpoint(mlp, x, lp, li, cfg), kv
    return checkpoint(decoder_layer, x, lp, li, cfg, positions)


def output_head(params: dict) -> torch.Tensor:
    head = params.get("lm_head")
    return params["embed"].T if head is None else head


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            prefix_embeds: torch.Tensor | None = None, return_kv: bool = False,
            return_hidden: bool = False):
    """Token logits (B, S, V).  ``prefix_embeds`` (B, P, d): the modality
    frontend stub's precomputed embeddings (vlm/audio), cast to
    ``compute_dtype`` and prepended.  ``return_kv`` also returns the stacked
    (L, B, S, KV, hd) k and v; ``return_hidden`` returns (final hidden
    states, output head) instead.  Each layer runs as ``remat_mode`` says
    (``remat_layer``)."""
    x = params["embed"].to(cfg.compute_dtype)[tokens]
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(cfg.compute_dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    lp = params["layers"]
    mode = remat_mode(cfg)
    ks, vs = [], []
    for li in range(cfg.num_layers):
        x, (k, v) = remat_layer(x, lp, li, cfg, positions, mode)
        if return_kv:
            ks.append(k)
            vs.append(v)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    head = output_head(params)
    if return_hidden:
        return x, head
    logits = x @ head.to(x.dtype)
    if return_kv:
        return logits, (torch.stack(ks), torch.stack(vs))
    return logits
