"""Serving: prefill into a KV cache, then batched greedy decode."""
from .decode import (decode_attention, greedy_generate, init_cache,  # noqa: F401
                     make_prefill, make_serve_step)
