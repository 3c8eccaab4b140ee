"""RWKV6 "Finch" (attention-free, data-dependent decay), the counterpart of
``repro/models/rwkv6.py`` (arXiv:2404.05892).

Token-shift mixing, per-channel data-dependent decay ``w = exp(-exp(w0 +
lora(x)))``, current-token bonus ``u``, per-head matrix-valued state,
squared-ReLU channel mix.  The time mix runs on the chunked
linear-recurrence engine (``ssm.py``).  Parameters are stacked on a leading
``layers`` axis as the reference's; the block functions take one layer's
slice (``common.layer(params["layers"], li)``), and the layer loop is a
Python loop where the reference scans.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import ssm
from .common import ModelConfig, checkpoint, heads, layer, merge_heads, remat_mode, rms_norm

LORA_RANK = 64
HEAD_DIM = 64


def num_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // HEAD_DIM


def param_shapes(cfg: ModelConfig) -> dict:
    L, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
    H, hd = num_heads(cfg), HEAD_DIM
    return {
        "embed": (cfg.vocab_size, d),
        "layers": {
            "ln1": (L, d), "ln2": (L, d),
            "mix": (L, 5, d),                      # token-shift mus: r,k,v,w,g
            "wr": (L, d, H, hd), "wk": (L, d, H, hd), "wv": (L, d, H, hd),
            "wg": (L, d, H, hd), "wo": (L, H, hd, d),
            "w0": (L, d), "w1": (L, d, LORA_RANK), "w2": (L, LORA_RANK, d),
            "u": (L, H, hd),
            "mix_c": (L, 2, d),                    # channel-mix mus: k,r
            "ck": (L, d, f), "cv": (L, f, d), "cr": (L, d, d),
        },
        "ln_f": (d,),
        "lm_head": (d, cfg.vocab_size),
    }


def param_specs(cfg: ModelConfig) -> dict:
    """Logical axis names per parameter (the reference's, leaf for leaf)."""
    return {
        "embed": ("vocab", "fsdp"),
        "layers": {
            "ln1": ("layers", "fsdp"), "ln2": ("layers", "fsdp"),
            "mix": ("layers", None, "fsdp"),
            "wr": ("layers", "fsdp", "heads", "head_dim"),
            "wk": ("layers", "fsdp", "heads", "head_dim"),
            "wv": ("layers", "fsdp", "heads", "head_dim"),
            "wg": ("layers", "fsdp", "heads", "head_dim"),
            "wo": ("layers", "heads", "head_dim", "fsdp"),
            "w0": ("layers", "fsdp"),
            "w1": ("layers", "fsdp", None),
            "w2": ("layers", None, "fsdp"),
            "u": ("layers", "heads", "head_dim"),
            "mix_c": ("layers", None, "fsdp"),
            "ck": ("layers", "fsdp", "mlp"),
            "cv": ("layers", "mlp", "fsdp"),
            "cr": ("layers", "fsdp", None),
        },
        "ln_f": ("fsdp",),
        "lm_head": ("fsdp", "vocab"),
    }


def cache_specs(cfg: ModelConfig) -> dict:
    return {
        "state": ("layers", "cache_batch", "heads", None, None),
        "tok1": ("layers", "cache_batch", "embed"),
        "tok2": ("layers", "cache_batch", "embed"),
    }


def _shift(x: torch.Tensor, prev: torch.Tensor | None = None) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros / carried ``prev`` at t=0)."""
    first = prev[:, None] if prev is not None else torch.zeros_like(x[:, :1])
    return torch.cat([first, x[:, :-1]], dim=1)


def time_mix(x, lp, cfg: ModelConfig, state=None, prev_tok=None, return_state=False):
    b, s, d = x.shape
    H, hd = num_heads(cfg), HEAD_DIM
    xx = _shift(x, prev_tok)

    def mixed(i):
        mu = lp["mix"][i].to(x.dtype)
        return x + (xx - x) * mu

    r = heads(mixed(0), lp["wr"])
    k = heads(mixed(1), lp["wk"])
    v = heads(mixed(2), lp["wv"])
    g = heads(mixed(4), lp["wg"])
    # data-dependent per-channel decay (kept in log space, <= 0)
    lora = torch.tanh(mixed(3) @ lp["w1"].to(x.dtype)) @ lp["w2"].to(x.dtype)
    log_w = -torch.exp(
        (lp["w0"].float()[None, None] + lora.float()).clamp(-8.0, 4.0)
    ).reshape(b, s, H, hd)
    chunk = cfg.attention_chunk // 8 or 128
    if return_state or state is not None:
        y, new_state = ssm.chunked_linear_attention(
            r, k, v, log_w, u=lp["u"], chunk=chunk, initial_state=state,
            return_state=True)
    else:
        y = ssm.chunked_linear_attention(r, k, v, log_w, u=lp["u"], chunk=chunk)
        new_state = None
    out = merge_heads(y * F.silu(g), lp["wo"])
    if return_state:
        return out, new_state
    return out


def channel_mix(x, lp, cfg: ModelConfig, prev_tok=None):
    xx = _shift(x, prev_tok)
    mu_k = lp["mix_c"][0].to(x.dtype)
    mu_r = lp["mix_c"][1].to(x.dtype)
    xk = x + (xx - x) * mu_k
    xr = x + (xx - x) * mu_r
    kk = torch.square(F.relu(xk @ lp["ck"].to(x.dtype)))
    rr = torch.sigmoid(xr @ lp["cr"].to(x.dtype))
    return rr * (kk @ lp["cv"].to(x.dtype))


def _time_block(x, lp, cfg: ModelConfig):
    return time_mix(rms_norm(x, lp["ln1"], cfg.norm_eps), lp, cfg)


def _channel_block(x, lp, cfg: ModelConfig):
    return channel_mix(rms_norm(x, lp["ln2"], cfg.norm_eps), lp, cfg)


def _layer(x, lp, cfg: ModelConfig):
    x = x + _time_block(x, lp, cfg)
    return x + _channel_block(x, lp, cfg)


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, rules=None,
            return_hidden: bool = False, **_):
    """Token logits (B, S, V); ``return_hidden`` returns (final hidden
    states, output head) instead.  Other keywords (``prefix_embeds``) are
    ignored, as the reference ignores them.  Layers run as ``remat_mode``
    says: its "sublayers" are the time mix and the channel mix."""
    if rules is not None:
        # on a mesh: every leaf gathered whole and the compute replicated
        # over ``model`` (the batch stays split over the batch axes)
        from .api import gather_params

        params = gather_params(params, cfg, rules)
    x = params["embed"].to(cfg.compute_dtype)[tokens]
    layers = params["layers"]
    mode = remat_mode(cfg)
    for li in range(cfg.num_layers):
        lp = layer(layers, li)
        if mode == "none":
            x = _layer(x, lp, cfg)
        elif mode == "sublayers":
            x = x + checkpoint(_time_block, x, lp, cfg)
            x = x + checkpoint(_channel_block, x, lp, cfg)
        else:
            x = checkpoint(_layer, x, lp, cfg)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    if return_hidden:
        return x, params["lm_head"]
    return x @ params["lm_head"].to(x.dtype)


def decode_step(params: dict, token: torch.Tensor, cache: dict, cfg: ModelConfig):
    """O(1) decode: cache = {"state": (L, B, H, hd, hd) f32,
    "tok1": (L, B, d), "tok2": (L, B, d)} (token-shift carries per block).
    As in the reference, the time mix runs the one new token through the
    chunked form (padded to a whole chunk).  The cache's tensors are
    written in place and returned in a new dict."""
    x = params["embed"].to(cfg.compute_dtype)[token][:, None]      # (B, 1, d)
    layers = params["layers"]
    for li in range(cfg.num_layers):
        lp = layer(layers, li)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, new_state = time_mix(h, lp, cfg, state=cache["state"][li],
                                prev_tok=cache["tok1"][li], return_state=True)
        x = x + y
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + channel_mix(h2, lp, cfg, prev_tok=cache["tok2"][li])
        cache["state"][li] = new_state
        cache["tok1"][li] = h[:, 0]
        cache["tok2"][li] = h2[:, 0]
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = x @ params["lm_head"].to(x.dtype)
    return logits[:, 0], {"state": cache["state"], "tok1": cache["tok1"],
                          "tok2": cache["tok2"]}


def init_cache(cfg: ModelConfig, batch: int, device: torch.device) -> dict:
    H, hd = num_heads(cfg), HEAD_DIM
    L, d = cfg.num_layers, cfg.d_model
    return {
        "state": torch.zeros((L, batch, H, hd, hd), dtype=torch.float32, device=device),
        "tok1": torch.zeros((L, batch, d), dtype=cfg.compute_dtype, device=device),
        "tok2": torch.zeros((L, batch, d), dtype=cfg.compute_dtype, device=device),
    }
