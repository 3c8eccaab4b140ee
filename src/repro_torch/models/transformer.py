"""Dense decoder-only transformer (GQA + RoPE + SwiGLU), the counterpart of
``repro/models/transformer.py`` for the dense families (dense, vlm, audio).

Parameters are a dict of tensors stacked on a leading ``layers`` axis, as
the reference's; the layer loop is a Python loop where the reference scans.
Prefill attention goes through ``common.attention`` (the flash kernel by
default).  The MoE blocks come with a later slice of the port.
"""
from __future__ import annotations

import torch

from .common import ModelConfig, attention, rms_norm, rope, swiglu


def require_dense(cfg: ModelConfig) -> None:
    if cfg.num_experts:
        raise NotImplementedError(
            f"{cfg.name}: the MoE block (moe_block) is not ported yet; it comes "
            "with the MoE slice of the LM stack")


def param_shapes(cfg: ModelConfig) -> dict:
    require_dense(cfg)
    L, d, hd = cfg.num_layers, cfg.d_model, cfg.resolved_head_dim
    H, KV, f = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    layers = {
        "ln1": (L, d), "ln2": (L, d),
        "wq": (L, d, H, hd), "wk": (L, d, KV, hd), "wv": (L, d, KV, hd),
        "wo": (L, H, hd, d),
        "w_gate": (L, d, f), "w_up": (L, d, f), "w_down": (L, f, d),
    }
    out = {"embed": (cfg.vocab_size, d), "layers": layers, "ln_f": (d,)}
    if not cfg.tie_embeddings:
        out["lm_head"] = (d, cfg.vocab_size)
    return out


def qkv(h: torch.Tensor, lp: dict, li: int):
    """Layer ``li``'s q (B, S, H, hd) and k/v (B, S, KV, hd) of h (B, S, d)."""
    b, s, d = h.shape

    def proj(w):
        w = w[li]
        return (h @ w.reshape(d, -1).to(h.dtype)).view(b, s, w.shape[1], w.shape[2])

    return proj(lp["wq"]), proj(lp["wk"]), proj(lp["wv"])


def attn_out(o: torch.Tensor, lp: dict, li: int) -> torch.Tensor:
    """(B, S, H, hd) @ wo[li] (H, hd, d) -> (B, S, d)."""
    wo = lp["wo"][li]
    return o.flatten(2) @ wo.reshape(-1, wo.shape[-1]).to(o.dtype)


def mlp(x: torch.Tensor, lp: dict, li: int, cfg: ModelConfig) -> torch.Tensor:
    h2 = rms_norm(x, lp["ln2"][li], cfg.norm_eps)
    return swiglu(h2, lp["w_gate"][li], lp["w_up"][li], lp["w_down"][li])


def decoder_layer(x, lp: dict, li: int, cfg: ModelConfig, positions):
    """Layer ``li`` of the stacked params.  Returns (out, (k, v)): the fresh
    K/V (after rope on k) build the prefill cache."""
    h = rms_norm(x, lp["ln1"][li], cfg.norm_eps)
    q, k, v = qkv(h, lp, li)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, 0, cfg)
    x = x + attn_out(o, lp, li)
    x = x + mlp(x, lp, li, cfg)
    return x, (k, v)


def output_head(params: dict) -> torch.Tensor:
    head = params.get("lm_head")
    return params["embed"].T if head is None else head


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            return_kv: bool = False, return_hidden: bool = False):
    """Token logits (B, S, V).  ``return_kv`` also returns the stacked
    (L, B, S, KV, hd) k and v; ``return_hidden`` returns (final hidden
    states, output head) instead."""
    require_dense(cfg)
    x = params["embed"].to(cfg.compute_dtype)[tokens]
    positions = torch.arange(x.shape[1], device=x.device)
    lp = params["layers"]
    ks, vs = [], []
    for li in range(cfg.num_layers):
        x, (k, v) = decoder_layer(x, lp, li, cfg, positions)
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
