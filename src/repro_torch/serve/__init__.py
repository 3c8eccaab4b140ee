"""Serving: prefill into a KV cache, then batched greedy decode."""
from .decode import (abstract_cache, cache_shardings, cache_specs,  # noqa: F401
                     decode_attention, greedy_generate, init_cache, make_prefill,
                     make_serve_step, serve_input_specs, sharded_decode_attention)
