"""Training: the optimizer, the train step with chunked cross-entropy, the
synthetic data pipeline and the checkpoint manager (the counterpart of
``repro/train``; its dry-run helpers ``abstract_state``, ``state_shardings``
and ``batch_specs`` wait for the sharding work)."""
from .checkpoint import CheckpointManager  # noqa: F401
from .data import DataConfig, PrefetchLoader, SyntheticLM  # noqa: F401
from .optimizer import OptimizerConfig, adamw_update, lr_at  # noqa: F401
from .step import (TrainState, chunked_cross_entropy, init_state,  # noqa: F401
                   make_train_step, state_from_reference, state_template)
