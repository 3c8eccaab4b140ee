"""repro_torch.experiment — the declarative experiment API.

- ``registry``   — ``register_policy`` / ``PolicySpec`` / ``make_policy``:
                   the single-region and DAG policies behind deferred constructors
                   that receive runtime context (knowledge base, mean
                   length) from the driver;
- ``Scenario``   — a declarative experiment point (region, trace family,
                   capacity, seed, weeks, queue scaling) with
                   ``materialize()`` resolving to (cluster, ci, jobs,
                   hist/eval splits);
- ``run``        — the continuous-learning driver (§4.2): weekly oracle
                   replay into a rolling KnowledgeBase on the device,
                   policy construction via the registry, evaluation
                   through ``simulate_many``.

Quickstart::

    from repro_torch.experiment import Scenario, run

    print(run(Scenario(region="california", capacity=40)).table())
"""
from . import registry  # noqa: F401
from .driver import (DEFAULT_DAG_POLICIES, DEFAULT_POLICIES,  # noqa: F401
                     ExperimentResult, prepare_context, run)
from .registry import (PolicyContext, PolicySpec, available_policies,  # noqa: F401
                       check_scenario_policies, make_policy, register_policy)
from .scenario import WEEK, MaterializedScenario, Scenario  # noqa: F401
