"""command-r-plus-104b [dense] — GQA, no-bias (hf:CohereForAI/c4ai-command-r-v01).
104B params: parameters and moments in bf16.
"""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    num_layers=64, d_model=12288, num_heads=96, num_kv_heads=8,
    d_ff=33792, vocab_size=256000,
    param_dtype=torch.bfloat16, moment_dtype=torch.bfloat16,
)
