"""Elastic training: gradient compression and the rescale / fault-tolerant
trainer (the counterpart of ``repro/elastic``)."""
from .compression import make_compressor  # noqa: F401
from .rescale import ElasticTrainer, RescalePlan  # noqa: F401
