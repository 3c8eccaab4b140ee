"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 (hf:Qwen/Qwen3-30B-A3B
scaled per the assignment).  235B total / 22B active; bf16 params+moments."""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
    d_ff=1536, vocab_size=151936,
    num_experts=128, experts_per_token=8,
    param_dtype=torch.bfloat16, moment_dtype=torch.bfloat16,
)
