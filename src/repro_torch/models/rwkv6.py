"""RWKV6 "Finch" (attention-free, data-dependent decay), the counterpart of
``repro/models/rwkv6.py`` (arXiv:2404.05892).

Token-shift mixing, per-channel data-dependent decay ``w = exp(-exp(w0 +
lora(x)))``, current-token bonus ``u``, per-head matrix-valued state,
squared-ReLU channel mix.  The time mix runs on the chunked
linear-recurrence engine (``ssm.py``).  Parameters are stacked on a leading
``layers`` axis as the reference's; the block functions take one layer's
slice (``common.layer(params["layers"], li)``), and the layer loop is a
Python loop where the reference scans.

On a mesh (``rules`` bound to ranks) each rank holds its blocks of the
leaves (``param_specs``) and its slice of the batch, leaves on "fsdp" are
gathered over ``data`` at use (``transformer.leaf``), and the layer is
tensor-parallel over ``model`` as the reference's specs place it:

- the time mix on the rank's heads: r, k, v, g column-parallel (``wr``,
  ``wk``, ``wv``, ``wg`` on "heads"), the LoRA decay computed replicated
  (``w0``, ``w1``, ``w2`` are not on ``model``) and sliced to the rank's
  heads, ``u`` the rank's heads, the chunked recurrence on them alone (each
  head's state is its own), ``wo`` row-parallel
  (``transformer.row_parallel``); the decode cache's ``state`` holds the
  rank's heads;
- the channel mix: ``ck`` column-parallel, ``cv`` row-parallel on "mlp";
  ``cr`` replicated, so its gate multiplies the summed product;
- ``embed`` and ``lm_head`` vocab-parallel (``transformer.embed``,
  ``transformer.lm_logits``): ``forward`` and ``decode_step`` return the
  rank's block of the vocabulary.

Each block's leaves sit on one logical axis over one extent (the time mix's
on "heads" over H, the channel mix's on "mlp" over d_ff), so a block is
either split or, where its extent does not divide ``model``, replicated
whole with no collective: no block's layout can fall back in part.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch import distributed as D

from . import ssm, transformer
from .common import ModelConfig, checkpoint, heads, layer, merge_heads, remat_mode, rms_norm
from .transformer import leaf

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


def time_mix(x, lp, cfg: ModelConfig, state=None, prev_tok=None, return_state=False,
             rules=None):
    """The time mix of one layer's slice ``lp``; on a mesh that splits the
    heads over ``model``, the rank's heads (``state`` too), its output the
    row-parallel sum."""
    b, s, d = x.shape
    H, hd = num_heads(cfg), HEAD_DIM
    xx = _shift(x, prev_tok)
    mix = leaf(lp, "mix", cfg, rules)
    tp = transformer.split(cfg, rules, "layers", "wr", 2)

    def mixed(i, x=x, xx=xx, mix=mix):
        mu = mix[i].to(x.dtype)
        return x + (xx - x) * mu

    col = mixed
    if tp:
        # the column-parallel products' inputs: their gradient, and that of
        # the mixes they read, summed over ``model`` (two sums for the four)
        xc = D.copy(x, rules, "model")          # x itself where no gradient is taken
        col = functools.partial(mixed, x=xc, xx=xx if xc is x else _shift(xc, prev_tok),
                                mix=D.copy(mix, rules, "model"))
    r = heads(col(0), leaf(lp, "wr", cfg, rules))
    k = heads(col(1), leaf(lp, "wk", cfg, rules))
    v = heads(col(2), leaf(lp, "wv", cfg, rules))
    g = heads(col(4), leaf(lp, "wg", cfg, rules))
    # data-dependent per-channel decay (kept in log space, <= 0)
    lora = torch.tanh(mixed(3) @ leaf(lp, "w1", cfg, rules).to(x.dtype)) \
        @ leaf(lp, "w2", cfg, rules).to(x.dtype)
    log_w = -torch.exp(
        (leaf(lp, "w0", cfg, rules).float()[None, None] + lora.float()).clamp(-8.0, 4.0)
    ).reshape(b, s, H, hd)
    if tp:
        # the rank's heads of the replicated decay; its gradient summed over
        # ``model`` back into the replicated LoRA
        log_w = D.block(D.copy(log_w, rules, "model"), 2, rules, "model")
    u = leaf(lp, "u", cfg, rules)
    chunk = cfg.attention_chunk // 8 or 128
    if return_state or state is not None:
        y, new_state = ssm.chunked_linear_attention(
            r, k, v, log_w, u=u, chunk=chunk, initial_state=state,
            return_state=True)
    else:
        y = ssm.chunked_linear_attention(r, k, v, log_w, u=u, chunk=chunk)
        new_state = None
    wo = leaf(lp, "wo", cfg, rules)
    if tp:
        out = transformer.row_parallel((y * F.silu(g)).flatten(2),
                                       wo.reshape(-1, wo.shape[-1]), rules)
    else:
        out = merge_heads(y * F.silu(g), wo)
    if return_state:
        return out, new_state
    return out


def channel_mix(x, lp, cfg: ModelConfig, prev_tok=None, rules=None):
    """The channel mix; on a mesh that splits "mlp", ``ck`` column- and
    ``cv`` row-parallel, the replicated ``cr`` gate on the summed product."""
    xx = _shift(x, prev_tok)
    mix_c = leaf(lp, "mix_c", cfg, rules)
    mu_k = mix_c[0].to(x.dtype)
    mu_r = mix_c[1].to(x.dtype)
    xk = x + (xx - x) * mu_k
    xr = x + (xx - x) * mu_r
    tp = transformer.split(cfg, rules, "layers", "ck", 2)
    if tp:
        xk = D.copy(xk, rules, "model")
    kk = torch.square(F.relu(xk @ leaf(lp, "ck", cfg, rules).to(x.dtype)))
    rr = torch.sigmoid(xr @ leaf(lp, "cr", cfg, rules).to(x.dtype))
    cv = leaf(lp, "cv", cfg, rules)
    if tp:
        return rr * transformer.row_parallel(kk, cv, rules)
    return rr * (kk @ cv.to(x.dtype))


def _time_block(x, lp, cfg: ModelConfig, rules=None):
    return time_mix(rms_norm(x, leaf(lp, "ln1", cfg, rules), cfg.norm_eps), lp, cfg,
                    rules=rules)


def _channel_block(x, lp, cfg: ModelConfig, rules=None):
    return channel_mix(rms_norm(x, leaf(lp, "ln2", cfg, rules), cfg.norm_eps), lp, cfg,
                       rules=rules)


def _layer(x, lp, cfg: ModelConfig, rules=None):
    x = x + _time_block(x, lp, cfg, rules)
    return x + _channel_block(x, lp, cfg, rules)


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, rules=None,
            return_hidden: bool = False, **_):
    """Token logits (B, S, V); ``return_hidden`` returns (final hidden
    states, output head) instead.  Other keywords (``prefix_embeds``) are
    ignored, as the reference ignores them.  Layers run as ``remat_mode``
    says: its "sublayers" are the time mix and the channel mix.  On a mesh:
    the rank's params and batch slice in, its batch slice of the logits out,
    over its block of the vocabulary (of the head with ``return_hidden``)."""
    x = transformer.embed(params, tokens, cfg, rules)
    layers = params["layers"]
    mode = remat_mode(cfg)
    for li in range(cfg.num_layers):
        lp = layer(layers, li)
        if mode == "none":
            x = _layer(x, lp, cfg, rules)
        elif mode == "sublayers":
            x = x + checkpoint(_time_block, x, lp, cfg, rules)
            x = x + checkpoint(_channel_block, x, lp, cfg, rules)
        else:
            x = checkpoint(_layer, x, lp, cfg, rules)
    x = rms_norm(x, transformer.top(params, "ln_f", cfg, rules), cfg.norm_eps)
    if return_hidden:
        return x, transformer.output_head(params, cfg, rules)
    return transformer.lm_logits(x, params, cfg, rules)


def decode_step(params: dict, token: torch.Tensor, cache: dict, cfg: ModelConfig,
                rules=None):
    """O(1) decode: cache = {"state": (L, B, H, hd, hd) f32,
    "tok1": (L, B, d), "tok2": (L, B, d)} (token-shift carries per block).
    As in the reference, the time mix runs the one new token through the
    chunked form (padded to a whole chunk).  The cache's tensors are
    written in place and returned in a new dict.  On a mesh: the rank's
    blocks of the cache (``state`` on its heads), its batch slice, the
    logits over its block of the vocabulary."""
    x = transformer.embed(params, token, cfg, rules)[:, None]      # (B, 1, d)
    layers = params["layers"]
    for li in range(cfg.num_layers):
        x = decode_layer(x, layer(layers, li), li, cache, cfg, rules)
    x = rms_norm(x, transformer.top(params, "ln_f", cfg, rules), cfg.norm_eps)
    logits = transformer.lm_logits(x, params, cfg, rules)
    return logits[:, 0], {"state": cache["state"], "tok1": cache["tok1"],
                          "tok2": cache["tok2"]}


def decode_layer(x, lp, li: int, cache: dict, cfg: ModelConfig, rules=None):
    """Layer ``li`` (its slice ``lp``) of a decode step on x (B, 1, d), its
    state and token-shift carries in ``cache`` written in place."""
    h = rms_norm(x, leaf(lp, "ln1", cfg, rules), cfg.norm_eps)
    y, new_state = time_mix(h, lp, cfg, state=cache["state"][li],
                            prev_tok=cache["tok1"][li], return_state=True, rules=rules)
    x = x + y
    h2 = rms_norm(x, leaf(lp, "ln2", cfg, rules), cfg.norm_eps)
    x = x + channel_mix(h2, lp, cfg, prev_tok=cache["tok2"][li], rules=rules)
    cache["state"][li] = new_state
    cache["tok1"][li] = h[:, 0]
    cache["tok2"][li] = h2[:, 0]
    return x


def init_cache(cfg: ModelConfig, batch: int, device: torch.device) -> dict:
    H, hd = num_heads(cfg), HEAD_DIM
    L, d = cfg.num_layers, cfg.d_model
    return {
        "state": torch.zeros((L, batch, H, hd, hd), dtype=torch.float32, device=device),
        "tok1": torch.zeros((L, batch, d), dtype=cfg.compute_dtype, device=device),
        "tok2": torch.zeros((L, batch, d), dtype=cfg.compute_dtype, device=device),
    }
