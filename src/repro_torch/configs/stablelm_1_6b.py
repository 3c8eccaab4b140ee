"""stablelm-1.6b [dense] (hf:stabilityai/stablelm-2-1_6b)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=5632, vocab_size=100352,
)
