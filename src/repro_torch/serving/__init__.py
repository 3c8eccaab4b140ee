"""Carbon-aware serving tier: SLO-bounded request routing across precision
tiers with a quality credit ledger (the interactive-traffic counterpart of
the batch suspend/resume engine — see ``serving/engine.py``).  Host numpy
over per-slot demand vectors, bit-identical to the JAX package's."""
from .engine import (MaterializedServing, ServeCase,  # noqa: F401
                     simulate_serving, simulate_serving_many)
from .policies import (ServeFlexPolicy, ServeGreedyPolicy,  # noqa: F401
                       ServeStaticPolicy, ServeWindow, relieve_capacity)
from .tiers import (CreditLedger, PrecisionTier, ServingConfig,  # noqa: F401
                    SloModel, derive_tiers, mix_for_quality)
