"""dbrx-132b [moe] — 16 experts top-4, fine-grained (hf:databricks/dbrx-base).
132B total params: bf16 params + bf16 moments.
"""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=10752, vocab_size=100352,
    num_experts=16, experts_per_token=4,
    param_dtype=torch.bfloat16, moment_dtype=torch.bfloat16,
)
