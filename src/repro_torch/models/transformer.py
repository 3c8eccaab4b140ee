"""Dense / MoE decoder-only transformer (GQA + RoPE + SwiGLU), the
counterpart of ``repro/models/transformer.py`` for the transformer families
(dense, moe, vlm, audio).

Parameters are a dict of tensors stacked on a leading ``layers`` axis, as
the reference's; the layer loop is a Python loop where the reference scans.
Prefill attention goes through ``common.attention`` (the flash kernel by
default).  MoE layers route by the reference's sort-based capacity
dispatch.

On a mesh (``rules`` bound to ranks) each rank holds its blocks of the
leaves (``param_specs``) and its slice of the batch, and the layer is
tensor-parallel over ``model`` (explicit SPMD, ``repro_torch/distributed.py``):

- q heads column-parallel on "heads", ``wk``/``wv`` replicated ("kv"), so
  the attention runs the rank's query heads against the KV heads they
  read (``local_kv``) through the same kernel wrapper; ``wo`` row-parallel,
  then a ``psum`` (``row_parallel``: 16-bit partial products kept in fp32,
  summed in fp32, rounded once).  Heads that do not divide the axis are
  replicated (the reference's fallback) and the attention needs no
  collective;
- the MLP: ``w_gate``/``w_up`` column-parallel on "mlp", ``w_down``
  row-parallel, then a ``psum``;
- ``embed`` and ``lm_head`` vocab-parallel on "vocab": the lookup sums
  each rank's rows (``psum``), the logits stay split over the vocabulary
  (``forward`` returns the rank's block);
- leaves on "fsdp" (``data``) are stored split and gathered at use, one
  layer at a time (ZeRO-3); the gradient of the gather is summed over
  ``data`` and sliced back;
- the MoE block: the reference's expert-parallel route
  (``moe_block_local``: each (data, model) rank routes its own tokens to
  its own E/model experts, capacity over its tokens, then one ``psum``
  over ``model``) when ``model`` is above 1 and divides E, else the
  global dispatch over the whole batch (gathered over the batch axes).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import distributed as D

from . import api
from .common import (LogicalRules, ModelConfig, attention, checkpoint, heads, merge_heads,
                     remat_mode, rms_norm, rope, swiglu)


def param_specs(cfg: ModelConfig) -> dict:
    """Logical axis names per parameter (the reference's, leaf for leaf)."""
    layers = {
        "ln1": ("layers", "fsdp"),
        "ln2": ("layers", "fsdp"),
        "wq": ("layers", "fsdp", "heads", "head_dim"),
        "wk": ("layers", "fsdp", "kv", "head_dim"),
        "wv": ("layers", "fsdp", "kv", "head_dim"),
        "wo": ("layers", "heads", "head_dim", "fsdp"),
    }
    if cfg.num_experts:
        layers.update({
            "router": ("layers", "fsdp", "experts"),
            "w_gate": ("layers", "experts", "fsdp", "expert_mlp"),
            "w_up": ("layers", "experts", "fsdp", "expert_mlp"),
            "w_down": ("layers", "experts", "expert_mlp", "fsdp"),
        })
    else:
        layers.update({
            "w_gate": ("layers", "fsdp", "mlp"),
            "w_up": ("layers", "fsdp", "mlp"),
            "w_down": ("layers", "mlp", "fsdp"),
        })
    out = {"embed": ("vocab", "fsdp"), "layers": layers, "ln_f": ("fsdp",)}
    if not cfg.tie_embeddings:
        out["lm_head"] = ("fsdp", "vocab")
    return out


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


# --------------------------------------------------------------------------
# the layout on a mesh


def leaf(lp: dict, name: str, cfg: ModelConfig, rules=None, group: str = "layers",
         keep=("model",)) -> torch.Tensor:
    """Leaf ``name`` of one layer's slice ``lp`` of the stacked ``group``
    ("layers"), of an unstacked group ("shared": zamba2's block) or, with
    ``group`` "", of the top of the tree; gathered over every axis but those
    of ``keep`` (by default every axis but ``model``: ZeRO-3 at use;
    ``keep=()`` makes it whole)."""
    t = lp[name]
    if rules is None:
        return t
    sh = api.param_shardings(cfg, rules)
    stacked = int(group == "layers")
    dims = (sh[group] if group else sh)[name].dims(t.dim() + stacked)[stacked:]
    return D.gather_leaf(t, dims, rules, keep=keep)


def weight(lp: dict, name: str, li: int, cfg: ModelConfig, rules=None) -> torch.Tensor:
    """Layer ``li``'s slice of the stacked leaf ``name``, gathered over every
    axis but ``model`` (ZeRO-3 at use)."""
    return leaf({name: lp[name][li]}, name, cfg, rules)


def top(params: dict, name: str, cfg: ModelConfig, rules=None) -> torch.Tensor:
    """A leaf outside the layer stack, gathered over every axis but ``model``."""
    return leaf(params, name, cfg, rules, group="")


def split(cfg: ModelConfig, rules, group: str, name: str, dim: int) -> bool:
    """Whether dim ``dim`` of the stored leaf ``group/name`` (``name`` alone
    when ``group`` is empty) is split over a ``model`` axis above 1."""
    if rules is None or rules.tp == 1:
        return False
    sh = api.param_shardings(cfg, rules)
    sh = sh[group][name] if group else sh[name]
    return "model" in sh.dims(dim + 1)[dim]


def local_kv(k: torch.Tensor, v: torch.Tensor, h0: int, hl: int, group: int):
    """The K/V heads that query heads [h0, h0 + hl) read, GQA group
    ``group``: whole groups take their KV heads; heads inside one group
    take its KV head; otherwise each query head gets its own KV head's copy
    (group 1).  Returns (k, v) for ``gqa_flash``."""
    if hl % group == 0:
        return k[:, :, h0 // group:(h0 + hl) // group], v[:, :, h0 // group:(h0 + hl) // group]
    if group % hl == 0:
        g = h0 // group
        return k[:, :, g:g + 1], v[:, :, g:g + 1]
    idx = torch.arange(h0, h0 + hl, device=k.device) // group
    return k.index_select(2, idx), v.index_select(2, idx)


def qkv(h: torch.Tensor, lp: dict, li: int, cfg: ModelConfig | None = None, rules=None):
    """Layer ``li``'s q (B, S, H, hd) and k/v (B, S, KV, hd) of h (B, S, d);
    on a mesh with split heads, q holds the rank's H/model heads."""
    if rules is None:
        return heads(h, lp["wq"][li]), heads(h, lp["wk"][li]), heads(h, lp["wv"][li])
    hq = D.copy(h, rules, "model") if split(cfg, rules, "layers", "wq", 2) else h
    return (heads(hq, weight(lp, "wq", li, cfg, rules)),
            heads(h, weight(lp, "wk", li, cfg, rules)), heads(h, weight(lp, "wv", li, cfg, rules)))


class _MatmulF32(torch.autograd.Function):
    """a (N, K) @ b (K, M) of 16-bit floats with the fp32 sums as the output
    (cuBLAS's ``out_dtype``); the gradient in the inputs' dtype, as a 16-bit
    product's."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return g @ b.T, a.T @ g


def row_parallel(x: torch.Tensor, w: torch.Tensor, rules) -> torch.Tensor:
    """x (..., K/model) @ w (K/model, M) summed over ``model``: each rank's
    partial product kept in fp32 (the fp32 sums of a 16-bit product), the
    ``psum`` in fp32, one rounding to x's dtype after it, so the sum rounds
    where the one-device product rounds."""
    a = x.reshape(-1, x.shape[-1])
    w = w.to(x.dtype)
    if x.dtype == torch.float32:
        y = a @ w
    elif a.is_cuda:
        y = _MatmulF32.apply(a, w)
    else:
        y = a.float() @ w.float()
    return D.psum(y, rules, "model").to(x.dtype).view(*x.shape[:-1], w.shape[-1])


def attn_out(o: torch.Tensor, lp: dict, li: int, cfg: ModelConfig | None = None,
             rules=None) -> torch.Tensor:
    """(B, S, H, hd) @ wo[li] (H, hd, d) -> (B, S, d); on a mesh with split
    heads, the rank's heads' partial product summed over ``model``
    (``row_parallel``)."""
    if rules is None:
        return merge_heads(o, lp["wo"][li])
    w = weight(lp, "wo", li, cfg, rules)
    if not split(cfg, rules, "layers", "wo", 1):
        return merge_heads(o, w)
    return row_parallel(o.flatten(2), w.reshape(-1, w.shape[-1]), rules)


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


def moe_route(probs: torch.Tensor, k: int, cap: int, e0: int = 0,
              e_loc: int | None = None) -> Routing:
    """Route router probabilities ``probs`` (T, E) fp32 as the reference's
    ``moe_block_global``.  Top-K is the first K of a stable descending sort,
    so equal probabilities pick the lower expert id first, as ``lax.top_k``
    does; the flat pairs sort stably by expert and each keeps its rank
    among its expert's pairs, so an expert's later pairs are the ones
    dropped.  With ``e0``/``e_loc``, the reference's ``_moe_local_dispatch``:
    only pairs routed to experts [e0, e0 + e_loc) are kept, ids relative to
    e0, the others sorted last and dropped (slots and buffer of e_loc
    experts)."""
    t, e = probs.shape
    e_loc = e if e_loc is None else e_loc
    gate, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = gate[:, :k], eidx[:, :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    flat_e = eidx.reshape(-1)
    if e_loc != e:
        local = (flat_e >= e0) & (flat_e < e0 + e_loc)
        flat_e = torch.where(local, flat_e - e0, e_loc)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    ranks = torch.arange(t * k, device=probs.device) - first
    keep = ranks < cap
    if e_loc != e:
        keep &= sorted_e < e_loc
    slot = torch.where(keep, sorted_e * cap + ranks, e_loc * cap)
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


def moe_block_global(x: torch.Tensor, lp: dict, li: int, cfg: ModelConfig,
                     rules=None) -> torch.Tensor:
    """Layer ``li``'s MoE block on x (B, S, d): router logits in x's dtype,
    softmax in fp32, ``moe_route`` over the B*S tokens (batch-major) with
    ``capacity`` slots per expert, the kept tokens scattered into an
    (E*C + 1, d) buffer whose last row is trash, the experts, the combine.
    On a mesh the dispatch is global, as GSPMD makes the reference's: the
    batch is gathered over the batch axes, every rank routes all of it and
    keeps its own slice of the output."""
    if rules is not None:
        ba = rules.batch_axes
        xg = D.gather(x, 0, rules, ba, reduce=ba)
        w = {n: weight(lp, n, li, cfg, rules)[None]
             for n in ("router", "w_gate", "w_up", "w_down")}
        return D.block(moe_block_global(xg, w, 0, cfg), 0, rules, ba)
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


def local_capacity(cfg: ModelConfig, tokens: int) -> int:
    """The expert-parallel route's slots per expert over a rank's
    ``tokens``: ``capacity`` with a floor of 1, as the reference's
    ``_moe_local_dispatch``."""
    return max(capacity(cfg, tokens), 1)


def moe_block_local(x: torch.Tensor, lp: dict, li: int, cfg: ModelConfig,
                    rules: LogicalRules, routing: list | None = None) -> torch.Tensor:
    """The reference's ``_moe_local_dispatch``: this rank routes its own
    tokens (x: its batch slice, replicated over ``model``) to its own
    E/model experts, ``local_capacity`` slots each, computes them and
    combines a partial output, which one ``psum`` over ``model`` completes.
    The router is gathered whole; its gradient is summed over ``model``
    (each rank's gates reach only its experts).  ``routing``: a list that
    receives this rank's ``Routing``."""
    b, s, d = x.shape
    t = b * s
    e = cfg.num_experts
    e_loc = e // rules.tp
    e0 = rules.coords["model"] * e_loc
    cap = local_capacity(cfg, t)
    xt = D.copy(x.reshape(t, d), rules, "model")
    router = D.gather(weight(lp, "router", li, cfg, rules), 1, rules, "model",
                      reduce="model")
    probs = torch.softmax((xt @ router.to(x.dtype)).float(), dim=-1)
    r = moe_route(probs, cfg.experts_per_token, cap, e0, e_loc)
    if routing is not None:
        routing.append(r)
    buf = x.new_zeros((e_loc * cap + 1, d))
    buf[r.slot] = xt[r.src_tok] * r.keep[:, None].to(x.dtype)
    yb = moe_experts(buf[:e_loc * cap].view(e_loc, cap, d),
                     weight(lp, "w_gate", li, cfg, rules), weight(lp, "w_up", li, cfg, rules),
                     weight(lp, "w_down", li, cfg, rules))
    return D.psum(moe_combine(yb, r), rules, "model").view(b, s, d)


def moe_block(x: torch.Tensor, lp: dict, li: int, cfg: ModelConfig,
              rules=None) -> torch.Tensor:
    """The reference's ``moe_block``: the expert-parallel route when the
    mesh's ``model`` axis is above 1 and divides E, else the global
    dispatch."""
    if rules is None or rules.tp == 1 or cfg.num_experts % rules.tp != 0:
        return moe_block_global(x, lp, li, cfg, rules)
    return moe_block_local(x, lp, li, cfg, rules)


def mlp(x: torch.Tensor, lp: dict, li: int, cfg: ModelConfig, rules=None) -> torch.Tensor:
    h2 = rms_norm(x, weight(lp, "ln2", li, cfg, rules), cfg.norm_eps)
    if cfg.num_experts:
        return moe_block(h2, lp, li, cfg, rules)
    if rules is None:
        return swiglu(h2, lp["w_gate"][li], lp["w_up"][li], lp["w_down"][li])
    w = [weight(lp, n, li, cfg, rules) for n in ("w_gate", "w_up", "w_down")]
    if not split(cfg, rules, "layers", "w_gate", 2):
        return swiglu(h2, *w)
    h2 = D.copy(h2, rules, "model")
    hidden = F.silu(h2 @ w[0].to(h2.dtype)) * (h2 @ w[1].to(h2.dtype))
    return row_parallel(hidden, w[2], rules)


def attention_block(x, lp: dict, li: int, cfg: ModelConfig, positions, rules=None):
    """Layer ``li``'s attention sublayer: (its output (B, S, d), (k, v)), the
    fresh K/V after rope on k (all KV heads, on every rank).  On a mesh
    with split heads the attention runs this rank's query heads against
    the KV heads they read."""
    h = rms_norm(x, weight(lp, "ln1", li, cfg, rules), cfg.norm_eps)
    q, k, v = qkv(h, lp, li, cfg, rules)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    ka, va = k, v
    if split(cfg, rules, "layers", "wq", 2):
        hl = q.shape[2]
        ka, va = local_kv(D.copy(k, rules, "model"), D.copy(v, rules, "model"),
                          rules.coords["model"] * hl, hl, cfg.q_per_kv)
    o = attention(q, ka, va, 0, cfg)
    return attn_out(o, lp, li, cfg, rules), (k, v)


def decoder_layer(x, lp: dict, li: int, cfg: ModelConfig, positions, rules=None):
    """Layer ``li`` of the stacked params.  Returns (out, (k, v)): the fresh
    K/V (after rope on k) build the prefill cache."""
    a, kv = attention_block(x, lp, li, cfg, positions, rules)
    x = x + a
    x = x + mlp(x, lp, li, cfg, rules)
    return x, kv


def remat_layer(x, lp: dict, li: int, cfg: ModelConfig, positions, mode: str, rules=None):
    """``decoder_layer`` as ``remat_mode`` says: "sublayers" checkpoints the
    attention and the MLP sublayers apart, "layer" the whole layer.  A
    recompute repeats the layer's collectives, on every rank alike."""
    if mode == "none":
        return decoder_layer(x, lp, li, cfg, positions, rules)
    if mode == "sublayers":
        a, kv = checkpoint(attention_block, x, lp, li, cfg, positions, rules)
        x = x + a
        return x + checkpoint(mlp, x, lp, li, cfg, rules), kv
    return checkpoint(decoder_layer, x, lp, li, cfg, positions, rules)


def output_head(params: dict, cfg: ModelConfig | None = None, rules=None) -> torch.Tensor:
    """(d, V) ``lm_head``, or the tied ``embed`` transposed; on a mesh the
    rank's vocabulary block."""
    if params.get("lm_head") is None:
        return top(params, "embed", cfg, rules).T
    return top(params, "lm_head", cfg, rules)


def embed(params: dict, tokens: torch.Tensor, cfg: ModelConfig, rules=None) -> torch.Tensor:
    """The tokens' rows of ``embed`` in ``compute_dtype``; vocab-parallel on
    a mesh that splits the vocabulary: each rank looks up the ids in its
    block, zeros elsewhere, and a ``psum`` over ``model`` adds them."""
    table = top(params, "embed", cfg, rules).to(cfg.compute_dtype)
    if not split(cfg, rules, "", "embed", 0):
        return table[tokens]
    vl = table.shape[0]
    rel = tokens - rules.coords["model"] * vl
    own = (rel >= 0) & (rel < vl)
    rows = table[rel.clamp(0, vl - 1)] * own[..., None].to(table.dtype)
    return D.psum(rows, rules, "model")


def lm_logits(x: torch.Tensor, params: dict, cfg: ModelConfig, rules=None) -> torch.Tensor:
    """x (B, S, d) through the output head; on a mesh that splits the
    vocabulary, the rank's block (x entering the column-parallel product
    through ``copy``)."""
    head = output_head(params, cfg, rules)
    if split(cfg, rules, "", "embed", 0):
        x = D.copy(x, rules, "model")
    return x @ head.to(x.dtype)


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, rules=None,
            prefix_embeds: torch.Tensor | None = None, return_kv: bool = False,
            return_hidden: bool = False):
    """Token logits (B, S, V).  ``prefix_embeds`` (B, P, d): the modality
    frontend stub's precomputed embeddings (vlm/audio), cast to
    ``compute_dtype`` and prepended.  ``return_kv`` also returns the stacked
    (L, B, S, KV, hd) k and v; ``return_hidden`` returns (final hidden
    states, output head) instead.  Each layer runs as ``remat_mode`` says
    (``remat_layer``).  On a mesh: the rank's params and batch slice in,
    its batch slice of the logits out, over its block of the vocabulary
    (of the head with ``return_hidden``)."""
    x = embed(params, tokens, cfg, rules)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(cfg.compute_dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    lp = params["layers"]
    mode = remat_mode(cfg)
    ks, vs = [], []
    for li in range(cfg.num_layers):
        x, (k, v) = remat_layer(x, lp, li, cfg, positions, mode, rules)
        if return_kv:
            ks.append(k)
            vs.append(v)
    x = rms_norm(x, top(params, "ln_f", cfg, rules), cfg.norm_eps)
    if return_hidden:
        return x, output_head(params, cfg, rules)
    logits = lm_logits(x, params, cfg, rules)
    if return_kv:
        return logits, (torch.stack(ks), torch.stack(vs))
    return logits
