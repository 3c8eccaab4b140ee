"""Zamba2 hybrid: a Mamba2 (SSD) backbone and one *shared* attention block
applied every ``shared_attn_every`` layers, the counterpart of
``repro/models/zamba2.py`` (arXiv:2411.15242).

Mamba2 block: in_proj -> (gate z, conv stream x, B, C, dt); causal
depthwise conv (width 4); SSD recurrence with scalar-per-head decay on the
chunked engine (``ssm.py``); gated out_proj.  The shared block (GQA
attention through ``common.attention`` and SwiGLU) has one set of weights
reused at every application.  The reference scans the layer groups and
enters the shared block inside the scan; here Python loops walk the
groups, their layers and the remainder layers after the last group, which
have no shared block after them.

Decode keeps the O(1) Mamba state, the conv carry and one K/V cache per
shared-block application.  The reference writes the new token's K/V by
blending a one-hot mask into the cache; here the step writes them at
``length`` by index, in place (equal for finite values), and attends over
the cache with the plain chunked attention, as the reference does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import ssm
from .common import (ModelConfig, attention, checkpoint, chunked_attention, heads, layer,
                     merge_heads, remat_mode, rms_norm, rope, swiglu)

CONV_WIDTH = 4
MAMBA_HEAD = 64


def dims(cfg: ModelConfig):
    d_inner = 2 * cfg.d_model
    heads = d_inner // MAMBA_HEAD
    return d_inner, heads, cfg.ssm_state or 64


def param_shapes(cfg: ModelConfig) -> dict:
    L, d = cfg.num_layers, cfg.d_model
    di, H, N = dims(cfg)
    hd = cfg.resolved_head_dim
    return {
        "embed": (cfg.vocab_size, d),
        "layers": {
            "ln": (L, d),
            "in_z": (L, d, di), "in_x": (L, d, di),
            # B/C are per-GROUP (shared across heads), as in Mamba2
            "in_b": (L, d, N), "in_c": (L, d, N), "in_dt": (L, d, H),
            "conv": (L, CONV_WIDTH, di),
            "a_log": (L, H), "dt_bias": (L, H), "d_skip": (L, H),
            "out": (L, di, d),
        },
        "shared": {
            "ln1": (d,), "ln2": (d,),
            "wq": (d, cfg.num_heads, hd), "wk": (d, cfg.num_kv_heads, hd),
            "wv": (d, cfg.num_kv_heads, hd), "wo": (cfg.num_heads, hd, d),
            "w_gate": (d, cfg.d_ff), "w_up": (d, cfg.d_ff), "w_down": (cfg.d_ff, d),
        },
        "ln_f": (d,),
        "lm_head": (d, cfg.vocab_size),
    }


def param_specs(cfg: ModelConfig) -> dict:
    """Logical axis names per parameter (the reference's, leaf for leaf)."""
    return {
        "embed": ("vocab", "fsdp"),
        "layers": {
            "ln": ("layers", "fsdp"),
            "in_z": ("layers", "fsdp", "mlp"), "in_x": ("layers", "fsdp", "mlp"),
            "in_b": ("layers", "fsdp", "ssm_state"),
            "in_c": ("layers", "fsdp", "ssm_state"),
            "in_dt": ("layers", "fsdp", "heads"),
            "conv": ("layers", None, "mlp"),
            "a_log": ("layers", "heads"), "dt_bias": ("layers", "heads"),
            "d_skip": ("layers", "heads"),
            "out": ("layers", "mlp", "fsdp"),
        },
        "shared": {
            "ln1": ("fsdp",), "ln2": ("fsdp",),
            "wq": ("fsdp", "heads", "head_dim"), "wk": ("fsdp", "kv", "head_dim"),
            "wv": ("fsdp", "kv", "head_dim"), "wo": ("heads", "head_dim", "fsdp"),
            "w_gate": ("fsdp", "mlp"), "w_up": ("fsdp", "mlp"),
            "w_down": ("mlp", "fsdp"),
        },
        "ln_f": ("fsdp",),
        "lm_head": ("fsdp", "vocab"),
    }


def cache_specs(cfg: ModelConfig) -> dict:
    return {
        "ssm": ("layers", "cache_batch", "heads", "ssm_state", None),
        "conv": ("layers", "cache_batch", None, "mlp"),
        "k": ("layers", "cache_batch", "cache_seq", "kv", "head_dim"),
        "v": ("layers", "cache_batch", "cache_seq", "kv", "head_dim"),
        "length": (),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, carry: torch.Tensor | None = None):
    """Depthwise causal conv, width CONV_WIDTH.  x: (B, S, di), w: (W, di).
    ``carry``: (B, W-1, di) previous tokens (decode).  Returns (silu of the
    conv, the new carry)."""
    pad = carry if carry is not None else torch.zeros(
        (x.shape[0], CONV_WIDTH - 1, x.shape[-1]), dtype=x.dtype, device=x.device)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i].to(x.dtype) for i in range(CONV_WIDTH))
    return F.silu(out), xp[:, -(CONV_WIDTH - 1):]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), with no threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mamba_block(x, lp, cfg: ModelConfig, state=None, conv_carry=None,
                return_state=False):
    b, s, d = x.shape
    di, H, N = dims(cfg)
    z = x @ lp["in_z"].to(x.dtype)
    xs = x @ lp["in_x"].to(x.dtype)
    xs, conv_out = _causal_conv(xs, lp["conv"], conv_carry)
    B = (x @ lp["in_b"].to(x.dtype))[:, :, None].expand(b, s, H, N)
    C = (x @ lp["in_c"].to(x.dtype))[:, :, None].expand(b, s, H, N)
    dt = _softplus((x @ lp["in_dt"].to(x.dtype)).float() + lp["dt_bias"].float()[None, None])
    a = -torch.exp(lp["a_log"].float())[None, None]                 # (1, 1, H)
    log_w = (dt * a)[..., None]                                     # (B, S, H, 1)
    xh = xs.reshape(b, s, H, MAMBA_HEAD)
    # SSD recurrence: k=B (state dim), v=dt*x (head dim), q=C
    v = (xh.float() * dt[..., None]).to(x.dtype)
    log_w_full = log_w.expand(b, s, H, N)
    chunk = cfg.attention_chunk // 8 or 128
    if return_state or state is not None:
        y, new_state = ssm.chunked_linear_attention(
            C, B, v, log_w_full, chunk=chunk, initial_state=state, return_state=True)
    else:
        y = ssm.chunked_linear_attention(C, B, v, log_w_full, chunk=chunk)
        new_state = None
    y = y + xh * lp["d_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(b, s, di) * F.silu(z)
    out = y @ lp["out"].to(y.dtype)
    if return_state:
        return out, new_state, conv_out
    return out


def shared_block(x, sp, cfg: ModelConfig, positions):
    """The shared GQA-attention + SwiGLU block (one weight set)."""
    h = rms_norm(x, sp["ln1"], cfg.norm_eps)
    q, k, v = heads(h, sp["wq"]), heads(h, sp["wk"]), heads(h, sp["wv"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, 0, cfg)
    x = x + merge_heads(o, sp["wo"])
    h2 = rms_norm(x, sp["ln2"], cfg.norm_eps)
    return x + swiglu(h2, sp["w_gate"], sp["w_up"], sp["w_down"])


def _split_groups(layers: dict, L: int, period: int):
    """The (L, ...)-stacked layer params as (G, period, ...) full groups and
    an (R, ...) remainder (no shared attention after those), as views."""
    G = L // period
    R = L - G * period
    grouped = ({name: t[:G * period].view((G, period) + t.shape[1:])
                for name, t in layers.items()} if G else None)
    rest = {name: t[G * period:] for name, t in layers.items()} if R else None
    return grouped, rest, G, R


def _mamba_sublayer(x, lp, cfg: ModelConfig):
    return mamba_block(rms_norm(x, lp["ln"], cfg.norm_eps), lp, cfg)


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, rules=None,
            return_hidden: bool = False, **_):
    """Token logits (B, S, V); ``return_hidden`` returns (final hidden
    states, output head) instead.  Other keywords (``prefix_embeds``) are
    ignored, as the reference ignores them.  Unless ``remat_mode`` is
    "none", each Mamba block and each application
    of the shared block runs under a checkpoint, keeping their outputs (the
    reference's ``mlp_out``/``attn_out``); the reference's "full" also
    recomputes a group's blocks inside the group's own checkpoint, which
    changes what is kept, not a value."""
    if rules is not None:
        # on a mesh: every leaf gathered whole and the compute replicated
        # over ``model`` (the batch stays split over the batch axes)
        from .api import gather_params

        params = gather_params(params, cfg, rules)
    x = params["embed"].to(cfg.compute_dtype)[tokens]
    positions = torch.arange(x.shape[1], device=x.device)
    sp = params["shared"]
    grouped, rest, G, R = _split_groups(params["layers"], cfg.num_layers,
                                        cfg.shared_attn_every)
    remat = remat_mode(cfg) != "none"

    def mamba_layer(x, lp):
        if remat:
            return x + checkpoint(_mamba_sublayer, x, lp, cfg)
        return x + _mamba_sublayer(x, lp, cfg)

    for g in range(G):
        for j in range(cfg.shared_attn_every):
            x = mamba_layer(x, layer(grouped, g, j))
        x = (checkpoint(shared_block, x, sp, cfg, positions) if remat
             else shared_block(x, sp, cfg, positions))
    for j in range(R):
        x = mamba_layer(x, layer(rest, j))
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    if return_hidden:
        return x, params["lm_head"]
    return x @ params["lm_head"].to(x.dtype)


# --------------------------------------------------------------------------
# decode (O(1) mamba state + the shared attention's KV cache)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device: torch.device) -> dict:
    di, H, N = dims(cfg)
    L = cfg.num_layers
    G = L // cfg.shared_attn_every
    hd = cfg.resolved_head_dim
    kv = (G, batch, max_seq, cfg.num_kv_heads, hd)
    return {
        "ssm": torch.zeros((L, batch, H, N, MAMBA_HEAD), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((L, batch, CONV_WIDTH - 1, di), dtype=cfg.compute_dtype,
                            device=device),
        "k": torch.zeros(kv, dtype=cfg.compute_dtype, device=device),
        "v": torch.zeros(kv, dtype=cfg.compute_dtype, device=device),
        "length": 0,
    }


def _mamba_decode_step(x, lp, cfg: ModelConfig, state, conv_carry):
    """x: (B, 1, d).  Returns (out, new_state, new_conv_carry)."""
    b = x.shape[0]
    di, H, N = dims(cfg)
    z = x @ lp["in_z"].to(x.dtype)
    xs = x @ lp["in_x"].to(x.dtype)
    xs, conv_out = _causal_conv(xs, lp["conv"], conv_carry)
    B = (x @ lp["in_b"].to(x.dtype))[:, 0][:, None].expand(b, H, N)
    C = (x @ lp["in_c"].to(x.dtype))[:, 0][:, None].expand(b, H, N)
    dt = _softplus((x @ lp["in_dt"].to(x.dtype)).float()
                   + lp["dt_bias"].float()[None, None])[:, 0]
    a = -torch.exp(lp["a_log"].float())[None]
    log_w = (dt * a)[..., None].expand(b, H, N)
    xh = xs.reshape(b, H, MAMBA_HEAD)
    v = (xh.float() * dt[..., None]).to(x.dtype)
    y, new_state = ssm.recurrence_step(C, B, v, log_w, state)
    y = y + xh * lp["d_skip"].to(x.dtype)[None, :, None]
    y = y.reshape(b, 1, di) * F.silu(z)
    return y @ lp["out"].to(y.dtype), new_state, conv_out


def _shared_decode(x, sp, cfg: ModelConfig, kc, vc, length: int):
    """The shared block for one new token: its K/V written into this
    application's cache kc/vc (B, max_seq, KV, hd) at ``length``, in place,
    then attention over the cache."""
    h = rms_norm(x, sp["ln1"], cfg.norm_eps)
    q, k, v = heads(h, sp["wq"]), heads(h, sp["wk"]), heads(h, sp["wv"])
    pos = torch.arange(length, length + 1, device=x.device)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    kc[:, length] = k[:, 0]
    vc[:, length] = v[:, 0]
    o = chunked_attention(q, kc, vc, causal_offset=length, chunk=cfg.attention_chunk)
    x = x + merge_heads(o, sp["wo"])
    h2 = rms_norm(x, sp["ln2"], cfg.norm_eps)
    return x + swiglu(h2, sp["w_gate"], sp["w_up"], sp["w_down"])


def decode_step(params: dict, token: torch.Tensor, cache: dict, cfg: ModelConfig):
    """One decode step: every layer's Mamba state and conv carry, and each
    shared-block application's K/V cache, updated in place.  Returns
    (logits (B, V), the cache with ``length`` + 1)."""
    length = cache["length"]
    if not 0 <= length < cache["k"].shape[2]:
        raise ValueError(f"cache full: position {length} of max_seq {cache['k'].shape[2]}")
    x = params["embed"].to(cfg.compute_dtype)[token][:, None]
    sp = params["shared"]
    layers = params["layers"]
    p = cfg.shared_attn_every
    G = cfg.num_layers // p

    def mamba_layer(x, li):
        lp = layer(layers, li)
        h = rms_norm(x, lp["ln"], cfg.norm_eps)
        out, st, cv = _mamba_decode_step(h, lp, cfg, cache["ssm"][li], cache["conv"][li])
        cache["ssm"][li] = st
        cache["conv"][li] = cv
        return x + out

    for li in range(cfg.num_layers):
        x = mamba_layer(x, li)
        if (li + 1) % p == 0 and li < G * p:
            g = li // p
            x = _shared_decode(x, sp, cfg, cache["k"][g], cache["v"][g], length)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = x @ params["lm_head"].to(x.dtype)
    return logits[:, 0], dict(cache, length=length + 1)
