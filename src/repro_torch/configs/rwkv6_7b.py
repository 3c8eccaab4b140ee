"""rwkv6-7b [ssm] — Finch, data-dependent decay, attention-free
(arXiv:2404.05892).  64 heads of dim 64."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    num_layers=32, d_model=4096, num_heads=64, num_kv_heads=64,
    d_ff=14336, vocab_size=65536,
)
