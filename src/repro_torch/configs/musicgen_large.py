"""musicgen-large [audio] — decoder-only over EnCodec tokens
(arXiv:2306.05284).  The EnCodec tokenizer is the modality stub: inputs
are already audio-token ids (vocab 2048); no embedding prefix is needed.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=2048,
)
