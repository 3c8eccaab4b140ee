"""repro_torch.experiment — the declarative experiment API.

- ``registry``   — ``register_policy`` / ``PolicySpec`` / ``make_policy``:
                   the single-region, MPC, geo, DAG and serving policies
                   behind deferred constructors that receive runtime
                   context (knowledge base, job history, mean length,
                   oracle backend) from the driver;
- ``Scenario``   — a declarative experiment point (region or regions,
                   trace family, capacity, seed, weeks, queue scaling,
                   fault process, carbon-feed outage, serving workload) with
                   ``materialize()`` resolving to (cluster, ci, jobs,
                   hist/eval splits);
- ``run``        — the continuous-learning driver (§4.2): weekly oracle
                   replay into a rolling KnowledgeBase on the device,
                   policy construction via the registry, evaluation
                   through ``simulate_many``;
- ``Sweep``      — cartesian (regions x seeds x faults x forecasts x
                   policies) grids dispatched as one ``simulate_many``
                   batch, aggregated by ``SweepResult`` (savings vs a named
                   baseline, dispersion, JSON + CSV export); serving grids
                   (``Scenario(serving=...)``) dispatch through the
                   request-serving engine instead;
- ``OracleGap``  — the forecast-error harness: per-cell savings-gap-to-
                   oracle under a forecast-error ladder (``sigma_ladder``)
                   and the degradation curve per policy.

Quickstart::

    from repro_torch.experiment import Scenario, Sweep, run

    print(run(Scenario(region="california", capacity=40)).table())

    sweep = Sweep(base=Scenario(capacity=40),
                  regions=["california", "ontario"], seeds=[1, 2],
                  policies=["carbon-agnostic", "wait-awhile", "carbonflex",
                            "oracle"])
    print(sweep.run().table())
"""
from . import registry  # noqa: F401
from .driver import (DEFAULT_DAG_POLICIES, DEFAULT_GEO_POLICIES,  # noqa: F401
                     DEFAULT_POLICIES, DEFAULT_SERVE_POLICIES,
                     ExperimentResult, prepare_context, run)
from .oracle_gap import (DEFAULT_GAP_POLICIES, OracleGap,  # noqa: F401
                         OracleGapResult, sigma_ladder)
from .registry import (PolicyContext, PolicySpec, available_policies,  # noqa: F401
                       check_scenario_policies, make_policy, register_policy)
from repro_torch.serving import ServingConfig  # noqa: F401  (scenario convenience)

from .scenario import WEEK, MaterializedScenario, Scenario  # noqa: F401
from .sweep import Sweep, SweepResult  # noqa: F401
