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

On a mesh (``rules`` bound to ranks) each rank holds its blocks of the
leaves (``param_specs``) and its slice of the batch, leaves on "fsdp" are
gathered over ``data`` at use (``transformer.leaf``), and each block is
tensor-parallel over ``model`` as the reference's specs place it:

- a Mamba block (``mamba_layout`` "tp"): ``in_z``, ``in_x`` and the
  depthwise ``conv`` on the rank's "mlp" channels, ``in_dt``, ``a_log``,
  ``dt_bias`` and ``d_skip`` on its "heads"; the rank's channels are
  exactly its heads' after the (B, S, H, 64) reshape; ``in_b``/``in_c``
  replicated ("ssm_state" is on no axis); the recurrence on the rank's
  heads; ``out`` row-parallel (``transformer.row_parallel``).  The decode
  cache's ``ssm`` holds the rank's heads and ``conv`` its channels;
- the shared block as the transformer's layer: q heads split, the KV
  heads they read (``transformer.local_kv``; ``wk``/``wv`` replicated),
  ``gqa_flash`` on the local heads, ``wo`` row-parallel, the MLP column-
  and row-parallel; its decode attends over the K/V cache split over
  ``model`` along the sequence (``attend``: the serving layer's
  ``sharded_decode_attention``), q gathered and the output sliced back;
- ``embed`` and ``lm_head`` vocab-parallel: ``forward`` and ``decode_step``
  return the rank's block of the vocabulary.

A Mamba block's "mlp" extent (2d) and "heads" extent (2d / 64) can fall
back apart: where ``model`` divides the channels and not the heads
(``mamba_layout`` "whole"), that block alone gathers its leaves (and its
split decode cache) whole and computes replicated.  The shared block's
attention and MLP each sit on one extent, so each is split or replicated
whole.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import distributed as D

from . import ssm, transformer
from .common import (ModelConfig, attention, checkpoint, chunked_attention, heads, layer,
                     merge_heads, remat_mode, rms_norm, rope, swiglu)
from .transformer import leaf

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


def mamba_layout(cfg: ModelConfig, rules=None) -> str:
    """How a Mamba block runs under ``rules``: "tp" (its "mlp" and "heads"
    leaves both split over ``model``), "whole" (one of the two split and the
    other not: its leaves gathered whole, computed replicated) or "one" (no
    leaf split over ``model``: the one-device compute)."""
    cols = transformer.split(cfg, rules, "layers", "in_x", 2)
    hds = transformer.split(cfg, rules, "layers", "in_dt", 2)
    if cols and hds:
        return "tp"
    return "whole" if cols or hds else "one"


def _mamba_in(x, lp, cfg: ModelConfig, layout: str, rules, conv_carry):
    """A Mamba block's projections of x (B, S, d): (z, the conv stream after
    the conv, the new conv carry, B and C (B, S, N), dt (B, S, H), a (H,)
    and the block's leaf getter); on a "tp" layout z, the stream and dt over
    the rank's channels and heads."""
    keep = () if layout == "whole" else ("model",)

    def w(name):
        return leaf(lp, name, cfg, rules, keep=keep)

    tp = layout == "tp"
    xc = D.copy(x, rules, "model") if tp else x
    z = xc @ w("in_z").to(x.dtype)
    xs = xc @ w("in_x").to(x.dtype)
    xs, conv_out = _causal_conv(xs, w("conv"), conv_carry)
    b_in = x @ w("in_b").to(x.dtype)
    c_in = x @ w("in_c").to(x.dtype)
    if tp:                      # replicated, read by the rank's heads alone
        n = b_in.shape[-1]
        b_in, c_in = D.copy(torch.cat([b_in, c_in], -1), rules, "model").split(n, -1)
    dt = _softplus((xc @ w("in_dt").to(x.dtype)).float() + w("dt_bias").float()[None, None])
    a = -torch.exp(w("a_log").float())
    if tp and xs.shape[-1] != dt.shape[-1] * MAMBA_HEAD:
        raise ValueError(f"the rank's {xs.shape[-1]} channels are not its {dt.shape[-1]} "
                         f"heads of {MAMBA_HEAD}")
    return z, xs, conv_out, b_in, c_in, dt, a, w


def _whole_cache(t, dim: int, rules, split: bool):
    """A decode cache block whose dim ``dim`` is split over ``model`` made
    whole (the "whole" layout); ``t`` as it is when not split."""
    return D.all_gather(t, dim, rules, "model") if split else t


def mamba_block(x, lp, cfg: ModelConfig, state=None, conv_carry=None,
                return_state=False, rules=None):
    """One Mamba block on x (B, S, d); on a mesh as ``mamba_layout`` says."""
    b, s, _ = x.shape
    _, _, N = dims(cfg)
    layout = mamba_layout(cfg, rules)
    z, xs, conv_out, b_in, c_in, dt, a, w = _mamba_in(x, lp, cfg, layout, rules, conv_carry)
    H = dt.shape[-1]
    B = b_in[:, :, None].expand(b, s, H, N)
    C = c_in[:, :, None].expand(b, s, H, N)
    log_w = (dt * a[None, None])[..., None]                        # (B, S, H, 1)
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
    y = y + xh * w("d_skip").to(x.dtype)[None, None, :, None]
    y = y.reshape(b, s, -1) * F.silu(z)
    out = _mamba_out(y, w, layout, rules)
    if return_state:
        return out, new_state, conv_out
    return out


def _mamba_out(y, w, layout: str, rules):
    if layout == "tp":
        return transformer.row_parallel(y, w("out"), rules)
    return y @ w("out").to(y.dtype)


def _shared_out(x, o, w, cfg: ModelConfig, rules):
    """The shared block after its attention: ``wo`` (row-parallel on split
    heads), the residual, then the SwiGLU MLP (column/row-parallel on split
    "mlp") and its residual."""
    wo = w("wo")
    if transformer.split(cfg, rules, "shared", "wo", 0):
        x = x + transformer.row_parallel(o.flatten(2), wo.reshape(-1, wo.shape[-1]), rules)
    else:
        x = x + merge_heads(o, wo)
    h2 = rms_norm(x, w("ln2"), cfg.norm_eps)
    wg, wu, wd = w("w_gate"), w("w_up"), w("w_down")
    if not transformer.split(cfg, rules, "shared", "w_gate", 1):
        return x + swiglu(h2, wg, wu, wd)
    h2 = D.copy(h2, rules, "model")
    hidden = F.silu(h2 @ wg.to(h2.dtype)) * (h2 @ wu.to(h2.dtype))
    return x + transformer.row_parallel(hidden, wd, rules)


def _shared_getter(sp, cfg: ModelConfig, rules):
    return lambda name: leaf(sp, name, cfg, rules, group="shared")


def shared_block(x, sp, cfg: ModelConfig, positions, rules=None):
    """The shared GQA-attention + SwiGLU block (one weight set); on a mesh
    that splits its heads, the rank's query heads against the KV heads they
    read, through the same kernel wrapper."""
    w = _shared_getter(sp, cfg, rules)
    h = rms_norm(x, w("ln1"), cfg.norm_eps)
    heads_split = transformer.split(cfg, rules, "shared", "wq", 1)
    hq = D.copy(h, rules, "model") if heads_split else h
    q, k, v = heads(hq, w("wq")), heads(h, w("wk")), heads(h, w("wv"))
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if heads_split:
        hl = q.shape[2]
        k, v = transformer.local_kv(D.copy(k, rules, "model"), D.copy(v, rules, "model"),
                                    rules.coords["model"] * hl, hl, cfg.q_per_kv)
    o = attention(q, k, v, 0, cfg)
    return _shared_out(x, o, w, cfg, rules)


def _split_groups(layers: dict, L: int, period: int):
    """The (L, ...)-stacked layer params as (G, period, ...) full groups and
    an (R, ...) remainder (no shared attention after those), as views."""
    G = L // period
    R = L - G * period
    grouped = ({name: t[:G * period].view((G, period) + t.shape[1:])
                for name, t in layers.items()} if G else None)
    rest = {name: t[G * period:] for name, t in layers.items()} if R else None
    return grouped, rest, G, R


def _mamba_sublayer(x, lp, cfg: ModelConfig, rules=None):
    return mamba_block(rms_norm(x, leaf(lp, "ln", cfg, rules), cfg.norm_eps), lp, cfg,
                       rules=rules)


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, rules=None,
            return_hidden: bool = False, **_):
    """Token logits (B, S, V); ``return_hidden`` returns (final hidden
    states, output head) instead.  Other keywords (``prefix_embeds``) are
    ignored, as the reference ignores them.  Unless ``remat_mode`` is
    "none", each Mamba block and each application
    of the shared block runs under a checkpoint, keeping their outputs (the
    reference's ``mlp_out``/``attn_out``); the reference's "full" also
    recomputes a group's blocks inside the group's own checkpoint, which
    changes what is kept, not a value.  On a mesh: the rank's params and
    batch slice in, its batch slice of the logits out, over its block of the
    vocabulary (of the head with ``return_hidden``)."""
    x = transformer.embed(params, tokens, cfg, rules)
    positions = torch.arange(x.shape[1], device=x.device)
    sp = params["shared"]
    grouped, rest, G, R = _split_groups(params["layers"], cfg.num_layers,
                                        cfg.shared_attn_every)
    remat = remat_mode(cfg) != "none"

    def mamba_layer(x, lp):
        if remat:
            return x + checkpoint(_mamba_sublayer, x, lp, cfg, rules)
        return x + _mamba_sublayer(x, lp, cfg, rules)

    for g in range(G):
        for j in range(cfg.shared_attn_every):
            x = mamba_layer(x, layer(grouped, g, j))
        x = (checkpoint(shared_block, x, sp, cfg, positions, rules) if remat
             else shared_block(x, sp, cfg, positions, rules))
    for j in range(R):
        x = mamba_layer(x, layer(rest, j))
    x = rms_norm(x, transformer.top(params, "ln_f", cfg, rules), cfg.norm_eps)
    if return_hidden:
        return x, transformer.output_head(params, cfg, rules)
    return transformer.lm_logits(x, params, cfg, rules)


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


def _mamba_decode_step(x, lp, cfg: ModelConfig, state, conv_carry, rules=None):
    """x: (B, 1, d).  Returns (out, new_state, new_conv_carry); on a mesh as
    ``mamba_layout`` says, with the rank's blocks of the state and carry."""
    b = x.shape[0]
    _, _, N = dims(cfg)
    layout = mamba_layout(cfg, rules)
    whole = layout == "whole"
    cols = whole and transformer.split(cfg, rules, "layers", "in_x", 2)
    hds = whole and transformer.split(cfg, rules, "layers", "in_dt", 2)
    conv_carry = _whole_cache(conv_carry, 2, rules, cols)        # (B, W - 1, di)
    state = _whole_cache(state, 1, rules, hds)                      # (B, H, N, 64)
    z, xs, conv_out, b_in, c_in, dt, a, w = _mamba_in(x, lp, cfg, layout, rules, conv_carry)
    H = dt.shape[-1]
    B = b_in[:, 0][:, None].expand(b, H, N)
    C = c_in[:, 0][:, None].expand(b, H, N)
    dt = dt[:, 0]
    log_w = (dt * a[None])[..., None].expand(b, H, N)
    xh = xs.reshape(b, H, MAMBA_HEAD)
    v = (xh.float() * dt[..., None]).to(x.dtype)
    y, new_state = ssm.recurrence_step(C, B, v, log_w, state)
    y = y + xh * w("d_skip").to(x.dtype)[None, :, None]
    y = y.reshape(b, 1, -1) * F.silu(z)
    out = _mamba_out(y, w, layout, rules)
    if cols:
        conv_out = D.block(conv_out, 2, rules, "model")
    if hds:
        new_state = D.block(new_state, 1, rules, "model")
    return out, new_state, conv_out


def mamba_decode_layer(x, lp, li: int, cache: dict, cfg: ModelConfig, rules=None):
    """Mamba layer ``li`` (its slice ``lp``) of a decode step on x (B, 1,
    d) with its residual, its state and conv carry in ``cache`` written in
    place."""
    h = rms_norm(x, leaf(lp, "ln", cfg, rules), cfg.norm_eps)
    out, st, cv = _mamba_decode_step(h, lp, cfg, cache["ssm"][li], cache["conv"][li], rules)
    cache["ssm"][li] = st
    cache["conv"][li] = cv
    return x + out


def _shared_decode(x, sp, cfg: ModelConfig, kc, vc, length: int, rules=None, attend=None):
    """The shared block for one new token: attention over this application's
    cache kc/vc (B, max_seq, KV, hd), the new K/V written into it at
    ``length`` in place; by default the one-device attention, else
    ``attend(q, kc, vc, k, v, length)`` (the serving layer's sequence-sharded
    attention, which writes them).  On a mesh that splits the heads, q is
    gathered over ``model`` first and the output sliced back to the rank's
    heads."""
    w = _shared_getter(sp, cfg, rules)
    h = rms_norm(x, w("ln1"), cfg.norm_eps)
    q, k, v = heads(h, w("wq")), heads(h, w("wk")), heads(h, w("wv"))
    pos = torch.arange(length, length + 1, device=x.device)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    heads_split = transformer.split(cfg, rules, "shared", "wq", 1)
    if heads_split:
        q = D.all_gather(q, 2, rules, "model")
    if attend is None:
        kc[:, length] = k[:, 0]
        vc[:, length] = v[:, 0]
        o = chunked_attention(q, kc, vc, causal_offset=length, chunk=cfg.attention_chunk)
    else:
        o = attend(q, kc, vc, k, v, length)
    if heads_split:
        o = D.block(o, 2, rules, "model")
    return _shared_out(x, o, w, cfg, rules)


def decode_step(params: dict, token: torch.Tensor, cache: dict, cfg: ModelConfig,
                rules=None, attend=None):
    """One decode step: every layer's Mamba state and conv carry, and each
    shared-block application's K/V cache, updated in place.  Returns
    (logits (B, V), the cache with ``length`` + 1).  On a mesh: the rank's
    blocks of the cache and its batch slice, the logits over its block of
    the vocabulary; ``attend`` as ``_shared_decode`` takes it (a cache split
    along the sequence records its whole ``max_seq``)."""
    length = cache["length"]
    max_seq = cache.get("max_seq", cache["k"].shape[2])
    if not 0 <= length < max_seq:
        raise ValueError(f"cache full: position {length} of max_seq {max_seq}")
    x = transformer.embed(params, token, cfg, rules)[:, None]
    sp = params["shared"]
    layers = params["layers"]
    p = cfg.shared_attn_every
    G = cfg.num_layers // p
    for li in range(cfg.num_layers):
        x = mamba_decode_layer(x, layer(layers, li), li, cache, cfg, rules)
        if (li + 1) % p == 0 and li < G * p:
            g = li // p
            x = _shared_decode(x, sp, cfg, cache["k"][g], cache["v"][g], length, rules,
                               attend)
    x = rms_norm(x, transformer.top(params, "ln_f", cfg, rules), cfg.norm_eps)
    logits = transformer.lm_logits(x, params, cfg, rules)
    return logits[:, 0], dict(cache, length=length + 1)
