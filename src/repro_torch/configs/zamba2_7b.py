"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks
(arXiv:2411.15242).  81 mamba layers; one shared GQA+SwiGLU block applied
after every 6th layer (13 applications, weights reused)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000, ssm_state=64, shared_attn_every=6,
)
