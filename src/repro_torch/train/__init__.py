"""Training: the optimizer, the train step with chunked cross-entropy, the
synthetic data pipeline and the checkpoint manager (the counterpart of
``repro/train``), with the sharding helpers ``abstract_state``,
``state_shardings`` and ``batch_specs``."""
from .checkpoint import CheckpointManager  # noqa: F401
from .data import DataConfig, PrefetchLoader, SyntheticLM  # noqa: F401
from .optimizer import OptimizerConfig, adamw_update, lr_at  # noqa: F401
from .step import (TrainState, abstract_state, batch_specs,  # noqa: F401
                   chunked_cross_entropy, init_state, make_train_step, state_from_reference,
                   state_shardings, state_template)
