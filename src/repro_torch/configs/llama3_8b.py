"""llama3-8b [dense] — GQA, 128k vocab (arXiv:2407.21783)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256, rope_theta=500000.0,
)
