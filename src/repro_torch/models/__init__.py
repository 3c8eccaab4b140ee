"""The LM stack's models: config, building blocks, the dense and MoE transformer,
rwkv6 and zamba2 on the chunked linear recurrence."""
from .api import (FAMILIES, forward, init_params, module_for,  # noqa: F401
                  param_count, params_from_reference)
from .common import SHAPES, ModelConfig, ShapeConfig  # noqa: F401
