"""Assigned-architecture registry: ``--arch <id>`` resolves here.

The same ten configurations as the JAX package's ``repro/configs``, with
torch dtypes.  ``reduced()`` gives the small same-family variant used by
the CPU tests and the ``--reduced`` serving run.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.common import ModelConfig

from .command_r_plus_104b import CONFIG as command_r_plus_104b
from .dbrx_132b import CONFIG as dbrx_132b
from .internvl2_2b import CONFIG as internvl2_2b
from .llama3_8b import CONFIG as llama3_8b
from .minicpm_2b import CONFIG as minicpm_2b
from .musicgen_large import CONFIG as musicgen_large
from .qwen3_moe_235b_a22b import CONFIG as qwen3_moe_235b_a22b
from .rwkv6_7b import CONFIG as rwkv6_7b
from .stablelm_1_6b import CONFIG as stablelm_1_6b
from .zamba2_7b import CONFIG as zamba2_7b

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        internvl2_2b, command_r_plus_104b, minicpm_2b, llama3_8b,
        stablelm_1_6b, musicgen_large, zamba2_7b, rwkv6_7b, dbrx_132b,
        qwen3_moe_235b_a22b,
    ]
}

# long_500k needs sub-quadratic attention: only the SSM/hybrid archs run it
# (the full-attention archs skip it, as in the JAX package).
LONG_CONTEXT_ARCHS = {"rwkv6-7b", "zamba2-7b"}


def get(name: str) -> ModelConfig:
    return ARCHS[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU tests (the reference's widths)."""
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=min(cfg.num_layers, 3 if cfg.family != "hybrid" else 7),
        d_model=128,
        num_heads=4, num_kv_heads=2 if cfg.num_kv_heads < cfg.num_heads else 4,
        d_ff=256,
        vocab_size=512,
        prefix_len=8 if cfg.prefix_len else 0,
        param_dtype=torch.float32, moment_dtype=torch.float32,
        compute_dtype=torch.float32,
        attention_chunk=64,
        shared_attn_every=3,
    )
    if cfg.num_experts:
        kw.update(num_experts=4, experts_per_token=2)
    if cfg.family == "ssm":
        kw.update(num_heads=2, num_kv_heads=2)   # d_model/64 = 2 heads
    if cfg.family == "hybrid":
        kw.update(ssm_state=16)
    return dataclasses.replace(cfg, **kw)
