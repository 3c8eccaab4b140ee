"""Policy registry: names -> deferred policy constructors.

The single-region policies of the paper's evaluation (§6.1, §6.7), the
receding-horizon MPC variants, the geo-distributed family, the
precedence-aware DAG family and the request-serving family register here.
Construction is *deferred*: a builder receives a :class:`PolicyContext`
carrying the runtime objects policies need — the learned
:class:`KnowledgeBase` for CarbonFlex, the completed-job history for the
MPC warm start, the mean historical length the paper grants every
baseline, the oracle backend — so drivers resolve ``"carbonflex"`` to a
ready instance instead of hand-wiring each constructor.

Register additional policies with :func:`register_policy`::

    @register_policy("my-policy", description="...")
    def _build(ctx: PolicyContext) -> Policy:
        return MyPolicy(...)
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import baselines
from repro_torch.core.carbon import CarbonService, MultiRegionCarbonService
from repro_torch.core.dag import DagCapPolicy, DagCarbonPolicy, DagFcfsPolicy
from repro_torch.core.geo import GeoFlexPolicy, GeoGreedyPolicy, GeoStaticPolicy
from repro_torch.core.knowledge import KnowledgeBase
from repro_torch.core.mpc import MPCConfig
from repro_torch.core.policy import (CarbonFlexMPCPolicy, CarbonFlexPolicy,
                                     CarbonFlexScalePolicy,
                                     EstimatedOraclePolicy, OraclePolicy,
                                     Policy)
from repro_torch.core.types import ClusterConfig, GeoCluster, Job
from repro_torch.serving import (ServeFlexPolicy, ServeGreedyPolicy,
                                 ServeStaticPolicy)


@dataclasses.dataclass
class PolicyContext:
    """Runtime context handed to deferred policy builders."""

    cluster: ClusterConfig
    ci: CarbonService
    history: list[Job] = dataclasses.field(default_factory=list)
    mean_length: float = 4.0
    utilization: float = 0.5
    kb: KnowledgeBase | None = None
    backend: str = "numpy"           # oracle backend for oracle/learning
    device: str | torch.device = "cuda"   # where backend="device" runs
    # quantile the `*-robust` policy variants threshold on (configurable
    # per experiment; 0.7 = mildly conservative upper band)
    forecast_quantile: float = 0.7
    # Geo-scenario context (None for single-region scenarios).
    mci: MultiRegionCarbonService | None = None
    geo: GeoCluster | None = None
    # MPC execution-phase knobs (Scenario.mpc); None = tuned defaults.
    mpc: MPCConfig | None = None

    def require_kb(self) -> KnowledgeBase:
        if self.kb is None:
            raise ValueError("policy requires a learned KnowledgeBase; "
                             "the driver must run the learning phase first")
        return self.kb


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """A registered policy: display name, builder, and the context it needs
    (drivers use the flags to decide what to prepare)."""

    name: str
    builder: Callable[[PolicyContext], Policy]
    needs_kb: bool = False
    needs_history: bool = False
    geo: bool = False                # runs on GeoCluster scenarios only
    dag: bool = False                # runs on Scenario(dag=...) only
    serve: bool = False              # runs on Scenario(serving=...) only
    description: str = ""


REGISTRY: dict[str, PolicySpec] = {}


def register_policy(name: str, *, needs_kb: bool = False,
                    needs_history: bool = False, geo: bool = False,
                    dag: bool = False, serve: bool = False,
                    description: str = ""):
    """Decorator registering a ``PolicyContext -> Policy`` builder.

    ``geo=True`` marks a policy implementing the ``GeoPolicy`` protocol:
    it runs only on scenarios with a ``regions`` axis.  ``dag=True`` marks
    a precedence-aware policy: it runs only on ``Scenario(dag=...)``
    workloads.  ``serve=True`` marks a request-serving policy
    (``repro_torch.serving``): it runs only on ``Scenario(serving=...)``
    workloads.  ``run()`` and the sweep reject mixing scenario kinds and
    policy families (:func:`check_scenario_policies`)."""

    def deco(builder: Callable[[PolicyContext], Policy]):
        if name in REGISTRY:
            raise ValueError(f"policy {name!r} is already registered")
        REGISTRY[name] = PolicySpec(name=name, builder=builder,
                                    needs_kb=needs_kb,
                                    needs_history=needs_history,
                                    geo=geo, dag=dag, serve=serve,
                                    description=description)
        return builder

    return deco


def get_spec(name: str) -> PolicySpec:
    try:
        return REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown policy {name!r}; registered policies: "
                         f"{', '.join(sorted(REGISTRY))}") from None


def make_policy(name: str, ctx: PolicyContext) -> Policy:
    """Construct a fresh policy instance (policies are stateful — one
    instance per simulation case)."""
    return get_spec(name).builder(ctx)


def available_policies() -> tuple[str, ...]:
    return tuple(REGISTRY)


def needs_kb(names) -> bool:
    return any(get_spec(n).needs_kb for n in names)


def check_scenario_policies(names, is_geo: bool = False,
                            is_dag: bool = False,
                            is_serving: bool = False) -> None:
    """Reject policies whose family does not match the scenario kind
    (single-region batch / geo / DAG / serving are mutually exclusive
    workload axes)."""
    for n in names:
        spec = get_spec(n)
        if spec.serve and not is_serving:
            raise ValueError(
                f"policy {n!r} routes interactive requests; give the "
                f"Scenario a serving workload (serving=ServingConfig())")
        if not spec.serve and is_serving:
            raise ValueError(
                f"policy {n!r} schedules batch jobs; a serving scenario "
                f"runs the serve policy family (serve-static/serve-greedy/"
                f"serve-flex) — drop Scenario.serving for batch studies")
        if spec.geo and not is_geo:
            raise ValueError(
                f"policy {n!r} is geo-distributed; give the Scenario a "
                f"regions axis (e.g. regions=('california', 'ontario'))")
        if not spec.geo and is_geo:
            raise ValueError(
                f"policy {n!r} is single-region; a geo scenario runs geo "
                f"policies (e.g. geo-static/geo-greedy/geo-flex) — drop "
                f"Scenario.regions for single-region studies")
        if spec.dag and not is_dag:
            raise ValueError(
                f"policy {n!r} is precedence-aware; give the Scenario a "
                f"DAG workload (e.g. dag=DagConfig())")
        if not spec.dag and is_dag:
            raise ValueError(
                f"policy {n!r} assumes independent jobs; a DAG scenario "
                f"runs the dag policy family (dag-fcfs/dag-carbon/dag-cap) "
                f"— drop Scenario.dag for independent-job studies")


# --- the single-region §6 policies -------------------------------------------


@register_policy("carbon-agnostic",
                 description="status quo: FCFS, run immediately, no elasticity")
def _carbon_agnostic(ctx: PolicyContext) -> Policy:
    return baselines.CarbonAgnosticPolicy()


@register_policy("gaia",
                 description="GAIA lowest-CI-window start-time selection")
def _gaia(ctx: PolicyContext) -> Policy:
    return baselines.GaiaPolicy(mean_length=ctx.mean_length)


@register_policy("wait-awhile",
                 description="suspend/resume on the 30th-percentile CI threshold")
def _wait_awhile(ctx: PolicyContext) -> Policy:
    return baselines.WaitAwhilePolicy()


@register_policy("wait-awhile-robust",
                 description="wait-awhile thresholding on a conservative "
                             "forecast quantile instead of the point "
                             "forecast (forecast-error robust)")
def _wait_awhile_robust(ctx: PolicyContext) -> Policy:
    return baselines.RobustWaitAwhilePolicy(quantile=ctx.forecast_quantile)


@register_policy("carbonscaler",
                 description="per-job elastic CarbonScaler plans, cluster-reconciled")
def _carbonscaler(ctx: PolicyContext) -> Policy:
    return baselines.CarbonScalerPolicy(mean_length=ctx.mean_length)


@register_policy("vcc", description="Google VCC capacity shaping, FCFS")
def _vcc(ctx: PolicyContext) -> Policy:
    return baselines.VCCPolicy(utilization=ctx.utilization)


@register_policy("vcc-scaling",
                 description="VCC capacity shaping + elastic filling")
def _vcc_scaling(ctx: PolicyContext) -> Policy:
    return baselines.VCCPolicy(scaling=True, utilization=ctx.utilization)


@register_policy("carbonflex", needs_kb=True,
                 description="CarbonFlex KNN execution phase (Algorithms 2+3)")
def _carbonflex(ctx: PolicyContext) -> Policy:
    return CarbonFlexPolicy(ctx.require_kb())


@register_policy("carbonflex-robust", needs_kb=True,
                 description="carbonflex with Table-2 forecast features "
                             "computed on a conservative forecast quantile "
                             "(forecast-error robust)")
def _carbonflex_robust(ctx: PolicyContext) -> Policy:
    return CarbonFlexPolicy(ctx.require_kb(),
                            forecast_quantile=ctx.forecast_quantile,
                            name="carbonflex-robust")


@register_policy("carbonflex-mpc", needs_kb=True, needs_history=True,
                 description="receding-horizon execution phase: run each "
                             "job in its estimated-need cheapest forecast "
                             "slots (beyond paper; core/mpc.py)")
def _carbonflex_mpc(ctx: PolicyContext) -> Policy:
    cfg = ctx.mpc or MPCConfig()
    if cfg.horizon == 0:
        # no look-ahead degenerates to the KNN execution phase exactly
        return CarbonFlexPolicy(ctx.require_kb(), name="carbonflex-mpc")
    pol = CarbonFlexMPCPolicy(cfg=cfg)
    if ctx.history:
        pol.warm_start(ctx.history)
    return pol


@register_policy("carbonflex-scale", needs_kb=True, needs_history=True,
                 description="carbonflex-mpc + CarbonScaler marginal-"
                             "capacity scale-up in clean forecast windows "
                             "(rho learned from the KB's oracle curve)")
def _carbonflex_scale(ctx: PolicyContext) -> Policy:
    cfg = ctx.mpc or MPCConfig()
    pol = CarbonFlexScalePolicy(cfg=cfg, kb=ctx.require_kb())
    if ctx.history:
        pol.warm_start(ctx.history)
    return pol


@register_policy("oracle",
                 description="Algorithm 1 with full future knowledge (upper bound)")
def _oracle(ctx: PolicyContext) -> Policy:
    return OraclePolicy(backend=ctx.backend, device=ctx.device)


@register_policy("oracle-estimated", needs_history=True,
                 description="Algorithm 1 with perfect CI but learned "
                             "per-queue length estimates — separates "
                             "timing skill from length clairvoyance")
def _oracle_estimated(ctx: PolicyContext) -> Policy:
    cfg = ctx.mpc or MPCConfig()
    pol = EstimatedOraclePolicy(cfg=cfg, backend=ctx.backend,
                                device=ctx.device)
    if ctx.history:
        pol.warm_start(ctx.history)
    return pol


# --- geo-distributed policies ------------------------------------------------


@register_policy("geo-static", geo=True,
                 description="jobs pinned to their arrival region, FCFS "
                             "(the spatial status quo)")
def _geo_static(ctx: PolicyContext) -> Policy:
    return GeoStaticPolicy()


@register_policy("geo-greedy", geo=True,
                 description="admit each job to the currently cleanest "
                             "region with free capacity; sticky placement")
def _geo_greedy(ctx: PolicyContext) -> Policy:
    return GeoGreedyPolicy()


@register_policy("geo-flex", geo=True,
                 description="per-region CI-rank suspend/resume + "
                             "suspend-migrate-resume when the forecast gap "
                             "beats the migration carbon cost")
def _geo_flex(ctx: PolicyContext) -> Policy:
    return GeoFlexPolicy()


# --- precedence-aware DAG policies -------------------------------------------


@register_policy("dag-fcfs", dag=True,
                 description="precedence-only baseline: FCFS over ready "
                             "tasks, no carbon awareness")
def _dag_fcfs(ctx: PolicyContext) -> Policy:
    return DagFcfsPolicy()


@register_policy("dag-carbon", dag=True,
                 description="CarbonFlex-style CI-rank suspend/resume "
                             "applied per ready task (the per-job carbon "
                             "scheduler on DAG structure)")
def _dag_carbon(ctx: PolicyContext) -> Policy:
    return DagCarbonPolicy()


@register_policy("dag-cap", dag=True,
                 description="PCAPS-style criticality: critical-path tasks "
                             "exempt from suspension, slack tasks deferred "
                             "into clean windows")
def _dag_cap(ctx: PolicyContext) -> Policy:
    return DagCapPolicy()


# --- request-serving policies (repro_torch.serving) ---------------------------


@register_policy("serve-static", serve=True,
                 description="all requests on the full-precision tier "
                             "(the serving status quo)")
def _serve_static(ctx: PolicyContext):
    return ServeStaticPolicy()


@register_policy("serve-greedy", serve=True,
                 description="current-CI percentile threshold: degrade "
                             "above p70 of the day-ahead forecast, repay "
                             "below p30, ledger-bounded")
def _serve_greedy(ctx: PolicyContext):
    return ServeGreedyPolicy()


@register_policy("serve-flex", serve=True,
                 description="forecast-aware-global: CI trend + demand "
                             "forecast + quantile look-ahead + emissions "
                             "budget, weighted and ledger-scaled")
def _serve_flex(ctx: PolicyContext):
    return ServeFlexPolicy(quantile=ctx.forecast_quantile)
