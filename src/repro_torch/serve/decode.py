"""Serving layer: prefill a batch of prompts into a cache, then decode one
new token per sequence per step (the counterpart of
``repro/serve/decode.py`` on one device).

Transformer families: the cache is ``{"k", "v": (L, B, max_seq, KV, hd) in
compute_dtype, "length": int}``.  Prefill runs the prompt through
``forward`` (attention through the flash kernel) and keeps each layer's
K/V; each decode step writes the new token's K/V at ``length`` and attends
over the cache with the plain chunked attention, as the reference's
single-device branch.

SSM/hybrid families dispatch to their O(1)-state decode (``rwkv6``:
``{"state", "tok1", "tok2"}``; ``zamba2``: ``{"ssm", "conv", "k", "v",
"length"}``), and their prefill replays the prompt through that decode
step token by token, as the reference does: their state is the cache.

Unlike the reference, which returns a new cache, every step writes the
cache's tensors in place (an index write where the reference blends a
one-hot mask into the K/V cache: equal for finite values) and returns the
same tensors, so a 1 GB cache is not copied every step.

On a mesh (``rules`` bound to ranks) each rank holds its block of the cache
as ``cache_specs`` places it: batch over (pod, data), the transformer's
sequence dim over ``model`` (``cache_seq``).  Decode attention is then the
reference's ``sharded_decode_attention``: the rank writes the new K/V only
if ``length`` falls in its slice, computes partial (m, l, o) over its
slice, and a ``pmax`` and a renormalised ``psum`` combine them; q is
gathered over ``model`` first, and the output sliced back to the rank's
heads for the row-parallel ``wo``.  A ``model`` axis of 1, or one that
does not divide the cache length, takes the plain path, as the
reference's.  rwkv6 and zamba2 decode tensor-parallel on their blocks of
the cache (``rwkv6.decode_step``, ``zamba2.decode_step``: the recurrent
state on the rank's heads, zamba2's conv carry on its channels, its shared
block's K/V cache along the sequence through ``sharded_decode_attention``).
A cache on a mesh records its whole ``max_seq``.  A batch that does not
divide the batch axes is replicated over them, as the reference's spec
falls back: every rank then holds and computes the whole batch.
"""
from __future__ import annotations

import math
import time

import torch

from repro_torch import distributed as D
from repro_torch.device import resolve_device
from repro_torch.kernels import flash_attention
from repro_torch.models import api, rwkv6, transformer, zamba2
from repro_torch.models.common import (LogicalRules, ModelConfig, chunked_attention,
                                       rms_norm, rope)

DECODE_CHUNK = 2048


def _tf_cache_specs(cfg: ModelConfig) -> dict:
    kv = ("layers", "cache_batch", "cache_seq", "kv", "head_dim")
    return {"k": kv, "v": kv, "length": ()}


def cache_specs(cfg: ModelConfig) -> dict:
    if cfg.family == "ssm":
        return rwkv6.cache_specs(cfg)
    if cfg.family == "hybrid":
        return zamba2.cache_specs(cfg)
    return _tf_cache_specs(cfg)


def _cache_leaves(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """The whole cache's leaves as (shape, dtype); ``length`` as ((), None)."""
    cache = init_cache(cfg, batch, max_seq, device="meta")
    return {k: (tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor) else ((), None)
            for k, v in cache.items()}


def cache_shardings(cfg: ModelConfig, rules: LogicalRules, batch: int, max_seq: int) -> dict:
    """Each cache leaf's ``Sharding`` for a whole batch and ``max_seq``."""
    specs = cache_specs(cfg)
    return {k: rules.sharding(*specs[k], dims=shape)
            for k, (shape, _) in _cache_leaves(cfg, batch, max_seq).items()}


def abstract_cache(cfg: ModelConfig, batch: int, max_seq: int, rules: LogicalRules) -> dict:
    """``meta`` tensors of the whole cache, each with its ``.sharding``
    (``length`` an int32 scalar)."""
    out = {}
    for k, v in init_cache(cfg, batch, max_seq, device="meta").items():
        t = v if isinstance(v, torch.Tensor) else torch.empty((), dtype=torch.int32,
                                                               device="meta")
        t.sharding = rules.sharding(*cache_specs(cfg)[k], dims=tuple(t.shape))
        out[k] = t
    return out


def serve_input_specs(cfg: ModelConfig, batch: int, rules: LogicalRules) -> torch.Tensor:
    """The (batch,) int32 tokens of a decode step, split over the batch axes."""
    t = torch.empty((batch,), dtype=torch.int32, device="meta")
    t.sharding = rules.sharding("batch", dims=(batch,))
    return t


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda",
               rules: LogicalRules | None = None) -> dict:
    """A zero cache for ``batch`` sequences of ``max_seq``; with ``rules``
    this rank's blocks (``cache_shardings``: a batch that does not divide
    the batch axes replicated over them) and the whole ``max_seq``."""
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    if rules is not None:
        shard = cache_shardings(cfg, rules, batch, max_seq)
        out = {k: (torch.zeros(shard[k].local_shape(shape), dtype=dt, device=dev) if dt else 0)
               for k, (shape, dt) in _cache_leaves(cfg, batch, max_seq).items()}
        if "k" in out:
            out["max_seq"] = max_seq
        return out
    if cfg.family == "ssm":
        return rwkv6.init_cache(cfg, batch, dev)
    if cfg.family == "hybrid":
        return zamba2.init_cache(cfg, batch, max_seq, dev)
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
        "length": 0,
    }


def rank_cache(cfg: ModelConfig, tokens: torch.Tensor, max_seq: int,
               rules: LogicalRules | None = None) -> dict:
    """A zero cache for the prompts ``tokens`` (B, S) a rank holds: on a
    mesh its slice of the batch (the whole batch where the batch is
    replicated), so its cache's batch dim is ``tokens``'s either way: the
    blocks of a batch that ``tokens.shape[0]`` times the batch axes' ranks
    split evenly."""
    b = tokens.shape[0] * (1 if rules is None else rules.size(rules.batch_axes))
    return init_cache(cfg, b, max_seq, device=tokens.device, rules=rules)


def seq_split(cache: dict, rules: LogicalRules | None) -> bool:
    """Whether the cache's sequence dim is split over ``model``: an axis
    above 1 that divides the whole ``max_seq``."""
    return (rules is not None and rules.tp > 1 and "max_seq" in cache
            and cache["max_seq"] % rules.tp == 0)


def decode_attention(q, kc, vc, kn, vn, length: int) -> torch.Tensor:
    """One decode step's attention on one device (the reference's
    ``sharded_decode_attention`` without a sharded cache): write kn/vn
    (B, 1, KV, hd) into the layer's cache kc/vc (B, max_seq, KV, hd) at
    ``length``, in place, then attend q (B, 1, H, hd) over the cache."""
    if not 0 <= length < kc.shape[1]:
        raise ValueError(f"cache full: position {length} of max_seq {kc.shape[1]}")
    kc[:, length] = kn[:, 0]
    vc[:, length] = vn[:, 0]
    return chunked_attention(q, kc, vc, causal_offset=length, chunk=DECODE_CHUNK)


def sharded_decode_attention(q, kc, vc, kn, vn, length: int, rules: LogicalRules | None,
                             split: bool):
    """The reference's ``sharded_decode_attention``.  q (B, 1, H, hd) and
    kn/vn (B, 1, KV, hd) replicated over ``model``; kc/vc (B, S_loc, KV, hd)
    the rank's block of the layer's cache (``split``: the sequence split
    over ``model``; else the whole cache and ``decode_attention``).  Each
    rank writes kn/vn at ``length`` if it falls in its slice, computes the
    partial (m, l, o) of its slice in fp32 (``_decode_attn_local``), and a
    ``pmax`` and a renormalised ``psum`` over ``model`` combine them."""
    if not split:
        return decode_attention(q, kc, vc, kn, vn, length)
    b, s_loc, hkv, dh = kc.shape
    hq = q.shape[2]
    group = hq // hkv
    off = rules.coords["model"] * s_loc
    pos = length - off
    if 0 <= pos < s_loc:
        kc[:, pos] = kn[:, 0]
        vc[:, pos] = vn[:, 0]
    qg = q.reshape(b, 1, hkv, group, dh).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kc.float()) / math.sqrt(dh)
    kpos = off + torch.arange(s_loc, device=q.device)
    s = torch.where(kpos <= length, s, -1e30)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    denom = p.sum(dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, vc.float())
    m_glob = D.pmax(m, rules, "model")
    corr = torch.exp(m - m_glob)
    l_glob = D.all_reduce(denom * corr, rules, "model")
    o_glob = D.all_reduce(o * corr[..., None], rules, "model")
    out = o_glob / torch.clamp(l_glob, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, 1, hq, dh).to(vn.dtype)


def _whole_vocab(logits, cfg, rules):
    """Logits over the rank's block of the vocabulary made whole."""
    if transformer.split(cfg, rules, "", "embed", 0):
        logits = D.all_gather(logits, -1, rules, "model")
    return logits


def _tf_decode_step(params: dict, token: torch.Tensor, cache: dict,
                    cfg: ModelConfig, rules: LogicalRules | None = None):
    x = transformer.embed(params, token, cfg, rules)[:, None]       # (B, 1, d)
    length = cache["length"]
    max_seq = cache.get("max_seq", cache["k"].shape[2])
    if not 0 <= length < max_seq:
        raise ValueError(f"cache full: position {length} of max_seq {max_seq}")
    pos = torch.arange(length, length + 1, device=x.device)
    lp = params["layers"]
    split = seq_split(cache, rules)
    heads_split = transformer.split(cfg, rules, "layers", "wq", 2)
    for li in range(cfg.num_layers):
        h = rms_norm(x, transformer.weight(lp, "ln1", li, cfg, rules), cfg.norm_eps)
        q, k, v = transformer.qkv(h, lp, li, cfg, rules)
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
        if heads_split:
            q = D.all_gather(q, 2, rules, "model")
        o = sharded_decode_attention(q, cache["k"][li], cache["v"][li], k, v, length,
                                     rules, split)
        if heads_split:
            o = D.block(o, 2, rules, "model")
        x = x + transformer.attn_out(o, lp, li, cfg, rules)
        x = x + transformer.mlp(x, lp, li, cfg, rules)
    x = rms_norm(x, transformer.top(params, "ln_f", cfg, rules), cfg.norm_eps)
    logits = _whole_vocab(transformer.lm_logits(x, params, cfg, rules), cfg, rules)
    return logits[:, 0], dict(cache, length=length + 1)


def make_prefill(cfg: ModelConfig, max_seq: int, rules: LogicalRules | None = None):
    """prefill(params, tokens) -> (last-position logits, cache): one
    forward pass over the prompt, whose per-layer K/V fill a ``max_seq``
    cache (transformer families); SSM/hybrid families replay the prompt
    through their decode step, one token at a time.  With ``rules``:
    this rank's params, its batch slice of the prompts, its cache blocks."""
    if cfg.family in ("ssm", "hybrid"):
        step = make_serve_step(cfg, rules)

        def prefill_ssm(params: dict, tokens: torch.Tensor):
            b, s = tokens.shape
            if s < 1:
                raise ValueError("an empty prompt has no last-position logits")
            cache = rank_cache(cfg, tokens, max_seq, rules)
            for t in range(s):
                logits, cache = step(params, cache, tokens[:, t])
            return logits, cache

        return prefill_ssm

    def prefill(params: dict, tokens: torch.Tensor):
        b, s = tokens.shape
        if s > max_seq:
            raise ValueError(f"prompt of {s} tokens exceeds max_seq {max_seq}")
        logits, (k, v) = api.forward(params, tokens, cfg, rules=rules, return_kv=True)
        cache = rank_cache(cfg, tokens, max_seq, rules)
        if seq_split(cache, rules):
            s_loc = cache["k"].shape[2]
            off = rules.coords["model"] * s_loc
            n = max(min(s - off, s_loc), 0)
            cache["k"][:, :, :n] = k[:, :, off:off + n]
            cache["v"][:, :, :n] = v[:, :, off:off + n]
        else:
            cache["k"][:, :, :s] = k
            cache["v"][:, :, :s] = v
        cache["length"] = s
        # a copy, so the (B, S, V) logits are freed with the prefill
        return _whole_vocab(logits[:, -1].contiguous(), cfg, rules), cache

    return prefill


def make_serve_step(cfg: ModelConfig, rules: LogicalRules | None = None):
    """serve_step(params, cache, tokens) -> (logits, cache): one new token
    per sequence against the cached context (with ``rules``: this rank's
    params, cache blocks and batch slice; logits over the whole
    vocabulary)."""
    if cfg.family == "ssm":
        def step(params: dict, cache: dict, tokens: torch.Tensor):
            logits, cache = rwkv6.decode_step(params, tokens, cache, cfg, rules)
            return _whole_vocab(logits, cfg, rules), cache
        return step

    if cfg.family == "hybrid":
        def step(params: dict, cache: dict, tokens: torch.Tensor):
            attend = None
            if seq_split(cache, rules):
                def attend(q, kc, vc, kn, vn, length):
                    return sharded_decode_attention(q, kc, vc, kn, vn, length, rules, True)
            logits, cache = zamba2.decode_step(params, tokens, cache, cfg, rules, attend)
            return _whole_vocab(logits, cfg, rules), cache
        return step

    def step(params: dict, cache: dict, tokens: torch.Tensor):
        return _tf_decode_step(params, tokens, cache, cfg, rules)

    return step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def greedy_generate(params: dict, prompts: torch.Tensor, cfg: ModelConfig,
                    new_tokens: int, rules: LogicalRules | None = None) -> dict:
    """Prefill ``prompts`` (B, P), then ``new_tokens`` greedy decode steps,
    as the reference's serving example does (with ``rules``, on its mesh).
    Returns the prefill's last-position logits, the (B, new_tokens)
    generated ids (the argmax of the prefill logits first), the last step's
    logits, the cache, the prefill and decode wall seconds (each ended by a
    device synchronise) and the flash kernel's launches in each phase."""
    b, p = prompts.shape
    prefill = make_prefill(cfg, p + new_tokens, rules)
    step = make_serve_step(cfg, rules)
    launched = flash_attention.launches["gqa_flash"]
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompts)
    _sync(prompts.device)
    prefill_s = time.perf_counter() - t0
    prefill_launches = flash_attention.launches["gqa_flash"] - launched
    first = logits
    generated = []
    tok = torch.argmax(logits, dim=-1)
    t0 = time.perf_counter()
    for _ in range(new_tokens):
        generated.append(tok)
        logits, cache = step(params, cache, tok)
        tok = torch.argmax(logits, dim=-1)
    _sync(prompts.device)
    decode_s = time.perf_counter() - t0
    return dict(prefill_logits=first, tokens=torch.stack(generated, dim=1),
                last_logits=logits, cache=cache, prefill_s=prefill_s,
                decode_s=decode_s, prefill_flash_launches=prefill_launches,
                decode_flash_launches=flash_attention.launches["gqa_flash"]
                - launched - prefill_launches)
