"""The LM stack's models: config, building blocks, the dense and MoE transformer,
rwkv6 and zamba2 on the chunked linear recurrence."""
from .api import (FAMILIES, abstract_params, forward, gather_params,  # noqa: F401
                  init_params, module_for, param_count, param_shardings, params_from_reference,
                  shard_params)
from .common import (DEFAULT_RULES, SHAPES, LogicalRules, ModelConfig,  # noqa: F401
                     Sharding, ShapeConfig)
