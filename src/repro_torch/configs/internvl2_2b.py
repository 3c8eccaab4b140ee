"""internvl2-2b [vlm] — InternViT + InternLM2 backbone (arXiv:2404.16821).
The InternViT frontend is a stub: 256 precomputed patch embeddings per
sample (prefix_len) are prepended to the text tokens.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=8192, vocab_size=92553, prefix_len=256,
)
