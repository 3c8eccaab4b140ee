"""minicpm-2b [dense] — WSD schedule, llama-like (arXiv:2404.06395)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
    d_ff=5760, vocab_size=122753, lr_schedule="wsd",
)
