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
"""
from __future__ import annotations

import time

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import flash_attention
from repro_torch.models import api, rwkv6, transformer, zamba2
from repro_torch.models.common import ModelConfig, chunked_attention, rms_norm, rope

DECODE_CHUNK = 2048


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda") -> dict:
    dev = resolve_device(device)
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


def _tf_decode_step(params: dict, token: torch.Tensor, cache: dict,
                    cfg: ModelConfig):
    x = params["embed"].to(cfg.compute_dtype)[token][:, None]      # (B, 1, d)
    length = cache["length"]
    pos = torch.arange(length, length + 1, device=x.device)
    lp = params["layers"]
    for li in range(cfg.num_layers):
        h = rms_norm(x, lp["ln1"][li], cfg.norm_eps)
        q, k, v = transformer.qkv(h, lp, li)
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
        o = decode_attention(q, cache["k"][li], cache["v"][li], k, v, length)
        x = x + transformer.attn_out(o, lp, li)
        x = x + transformer.mlp(x, lp, li, cfg)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = x @ transformer.output_head(params).to(x.dtype)
    return logits[:, 0], {"k": cache["k"], "v": cache["v"], "length": length + 1}


def make_prefill(cfg: ModelConfig, max_seq: int):
    """prefill(params, tokens) -> (last-position logits, cache): one
    forward pass over the prompt, whose per-layer K/V fill a ``max_seq``
    cache (transformer families); SSM/hybrid families replay the prompt
    through their decode step, one token at a time."""
    if cfg.family in ("ssm", "hybrid"):
        step = make_serve_step(cfg)

        def prefill_ssm(params: dict, tokens: torch.Tensor):
            b, s = tokens.shape
            if s < 1:
                raise ValueError("an empty prompt has no last-position logits")
            cache = init_cache(cfg, b, max_seq, device=tokens.device)
            for t in range(s):
                logits, cache = step(params, cache, tokens[:, t])
            return logits, cache

        return prefill_ssm

    def prefill(params: dict, tokens: torch.Tensor):
        b, s = tokens.shape
        if s > max_seq:
            raise ValueError(f"prompt of {s} tokens exceeds max_seq {max_seq}")
        logits, (k, v) = api.forward(params, tokens, cfg, return_kv=True)
        cache = init_cache(cfg, b, max_seq, device=tokens.device)
        cache["k"][:, :, :s] = k
        cache["v"][:, :, :s] = v
        cache["length"] = s
        # a copy, so the (B, S, V) logits are freed with the prefill
        return logits[:, -1].contiguous(), cache

    return prefill


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, cache, tokens) -> (logits, cache): one new token
    per sequence against the cached context."""
    decode = {"ssm": rwkv6.decode_step, "hybrid": zamba2.decode_step}.get(
        cfg.family, _tf_decode_step)

    def step(params: dict, cache: dict, tokens: torch.Tensor):
        return decode(params, tokens, cache, cfg)

    return step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def greedy_generate(params: dict, prompts: torch.Tensor, cfg: ModelConfig,
                    new_tokens: int) -> dict:
    """Prefill ``prompts`` (B, P), then ``new_tokens`` greedy decode steps,
    as the reference's serving example does.  Returns the prefill's
    last-position logits, the (B, new_tokens) generated ids (the argmax of
    the prefill logits first), the last step's logits, the cache, the
    prefill and decode wall seconds (each ended by a device synchronise)
    and the flash kernel's launches in each phase."""
    b, p = prompts.shape
    prefill = make_prefill(cfg, p + new_tokens)
    step = make_serve_step(cfg)
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
