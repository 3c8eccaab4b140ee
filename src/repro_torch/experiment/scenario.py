"""Declarative scenario description for CarbonFlex runs.

A ``Scenario`` names what the paper's sweeps vary — region (or a tuple of
regions for a geo-distributed cluster), trace family, capacity, seed,
learning/evaluation span, queue scaling, workload elasticity, distribution
shift, a DAG workload, fault injection, carbon-feed outages, a serving
workload, the forecast model, the MPC knobs — and
``materialize()`` resolves it into the concrete ``(cluster, ci, jobs,
hist/eval splits)``, plus the ``GeoCluster`` / ``MultiRegionCarbonService``
pair of a geo scenario.

Materialization is cached on the instance: repeated calls return the *same*
job-list objects.
"""
from __future__ import annotations

import dataclasses
import json

from repro_torch.core.carbon import (REGIONS, CarbonService,
                                     MultiRegionCarbonService)
from repro_torch.core.faults import (CarbonDataOutage, FaultProcess,
                                     fault_from_dict, fault_to_dict,
                                     outage_from_dict, outage_to_dict)
from repro_torch.core.forecast import (ForecastModel, forecast_from_dict,
                                       forecast_to_dict)
from repro_torch.core.mpc import MPCConfig
from repro_torch.core.types import (ClusterConfig, GeoCluster, Job,
                                    MigrationModel, QueueConfig, default_queues)
from repro_torch.serving import MaterializedServing, ServingConfig
from repro_torch.traces import (DagConfig, TraceSpec, dag_mean_task_length,
                               expected_request_rate, generate_dag_trace,
                               generate_request_demand, generate_trace,
                               mean_length)

WEEK = 24 * 7
# CI margin past the nominal trace so run-to-completion overruns stay
# on real (not padded) carbon data.
CI_MARGIN_HOURS = 24 * 30


@dataclasses.dataclass
class MaterializedScenario:
    """Concrete world resolved from a :class:`Scenario`."""

    scenario: "Scenario"
    cluster: ClusterConfig
    ci: CarbonService
    spec: TraceSpec
    jobs: list[Job]              # full trace (learning + evaluation weeks)
    hist: list[Job]              # arrivals in the learning weeks
    eval_jobs: list[Job]         # arrivals in the evaluation weeks
    t0: int                      # first evaluation slot
    mean_length: float
    # Geo-scenario extras (None for single-region scenarios).  ``ci`` then
    # aliases the first region's service, anchoring single-region
    # comparisons; ``cluster`` keeps the aggregate total capacity.
    mci: MultiRegionCarbonService | None = None
    geo: GeoCluster | None = None
    # Serving-scenario extras (None for batch scenarios): the serving
    # config + realized demand / expected-rate curves; the job lists are
    # then empty (interactive requests are never materialized per-request).
    serving: MaterializedServing | None = None

    @property
    def is_geo(self) -> bool:
        return self.geo is not None

    @property
    def is_serving(self) -> bool:
        return self.serving is not None

    def eval_week(self, w: int) -> list[Job]:
        """Arrivals of evaluation week ``w`` (0-based)."""
        lo = self.t0 + w * WEEK
        return [j for j in self.eval_jobs if lo <= j.arrival < lo + WEEK]


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One point of the paper's experiment space.

    ``seed`` drives both the CI trace (``seed``) and the workload trace
    (``seed + 1``), so a single integer reproduces the whole world.
    ``eval_shift`` regenerates the evaluation weeks from a +/-shifted
    length/rate distribution (the Fig. 13 learning/execution mismatch)
    while the learning weeks keep the unshifted trace.  ``engine`` picks
    the slot simulator: ``"vector"`` (default), the ``"scalar"`` reference
    loop, or ``"scan"``, the slot loop on the device
    (``core/scan_engine.py``), all bit-identical.

    A non-``None`` ``dag`` (:class:`repro_torch.traces.DagConfig`) makes the
    workload precedence-aware: the trace generator emits whole DAG jobs
    (chains / map-reduce stages / random layered DAGs) expanded to tasks
    with ``Job.deps`` edges, the engines gate each task until its
    predecessors complete, and the ``dag-*`` policy family applies.
    ``DagConfig(independent=True)`` generates the same tasks with the
    edges stripped — the independent-task upper-bound twin.

    A non-empty ``regions`` tuple turns the scenario geo-distributed:
    ``capacity`` is split evenly across the regions (remainder to the
    first), aligned per-region CI traces are synthesized from the same
    seed, and ``materialize()`` additionally yields the ``GeoCluster`` /
    ``MultiRegionCarbonService`` pair the geo policies run on (``region``
    is then ignored).  ``migration`` overrides the default
    :class:`MigrationModel` cost knobs.

    ``faults`` injects a fault process into every batch run, and
    ``ci_outage`` stale/gap windows into the carbon feed the policies read
    (accounting stays on the true trace).  A non-``None`` ``serving``
    (:class:`repro_torch.serving.ServingConfig`) makes it a request-serving
    world run by the ``serve-*`` policies.

    The fields are the JAX package's, in its order, so positional and
    keyword calls bind alike in both packages.
    """

    region: str = "south-australia"
    regions: tuple[str, ...] = ()
    migration: MigrationModel | None = None
    dag: DagConfig | None = None        # DAG workload (precedence gating)
    # Forecast model policies see (core/forecast.py); None = PerfectForecast.
    forecast: ForecastModel | None = None
    family: str = "azure"
    capacity: int = 60
    utilization: float = 0.5
    learn_weeks: int = 3
    eval_weeks: int = 1
    seed: int = 7
    elasticity: str = "mix"          # "mix" | "high" | "moderate" | "low" | "none"
    mode: str = "cpu"                # "cpu" | "gpu"
    delay_scale: float = 1.0         # queue-slack scaling (Section 6.1 queues)
    length_scale: float = 1.0
    rate_scale: float = 1.0
    delay_override: int | None = None   # uniform slack d (Fig. 9 / Fig. 14)
    eval_shift: float = 0.0             # Fig. 13 distribution shift
    # Fault process injected into every run of the scenario (core/faults.py):
    # IidFaults (the historical FaultModel), CorrelatedFaults, or
    # PreemptionFaults.
    faults: FaultProcess | None = None
    # Carbon-feed outage injection (core/faults.py): the policies' CI view
    # goes stale/ffilled during outage windows while accounting stays true.
    ci_outage: CarbonDataOutage | None = None
    # Serving workload (repro_torch.serving): a non-None ServingConfig turns
    # the scenario into an interactive request-serving world — per-slot
    # demand vectors routed across precision tiers by the serve-* policy
    # family instead of batch jobs.  Serving composes with `forecast` and
    # `ci_outage` but not with `dag`, `regions`, or `faults`.
    serving: ServingConfig | None = None
    engine: str = "vector"
    # Receding-horizon execution-phase knobs (core/mpc.py); None = defaults.
    mpc: MPCConfig | None = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "regions", tuple(self.regions))
        if self.region not in REGIONS:
            raise ValueError(f"unknown region {self.region!r}; available "
                             f"regions: {', '.join(sorted(REGIONS))}")
        for r in self.regions:
            if r not in REGIONS:
                raise ValueError(f"unknown region {r!r}; available "
                                 f"regions: {', '.join(sorted(REGIONS))}")
        if self.regions and len(self.regions) < 2:
            raise ValueError("a geo scenario needs >= 2 regions; use "
                             "`region=` for single-region studies")
        if self.dag is not None and self.regions:
            raise ValueError("DAG scenarios are single-region (the geo "
                             "engines do not gate precedence yet); drop "
                             "either `dag` or `regions`")
        if self.serving is not None:
            if self.dag is not None:
                raise ValueError(
                    "serving scenarios carry no batch workload — a DAG has "
                    "nothing to schedule there; drop either `serving` or "
                    "`dag`")
            if self.regions:
                raise ValueError(
                    "serving scenarios are single-region (the serving "
                    "engine does not route across regions yet); drop "
                    "either `serving` or `regions`")
            if self.faults is not None:
                raise ValueError(
                    "serving scenarios do not take a batch fault process "
                    "(requests are never suspended or evicted); carbon-"
                    "feed outages via `ci_outage` are supported")
        if self.learn_weeks < 1 or self.eval_weeks < 1:
            raise ValueError("learn_weeks and eval_weeks must be >= 1")
        if self.engine not in ("scalar", "vector", "scan"):
            raise ValueError(f"unknown engine {self.engine!r}; choose "
                             "'scalar', 'vector', or 'scan'")

    @property
    def is_geo(self) -> bool:
        return bool(self.regions)

    @property
    def is_dag(self) -> bool:
        return self.dag is not None

    @property
    def is_serving(self) -> bool:
        return self.serving is not None

    # --- derived geometry ---------------------------------------------------

    @property
    def hours(self) -> int:
        return WEEK * (self.learn_weeks + self.eval_weeks)

    @property
    def t0(self) -> int:
        return WEEK * self.learn_weeks

    def learn_offsets(self) -> tuple[int, ...]:
        """Replay offsets for the initial learning phase: one per
        historical week (§5 'Continuous Learning')."""
        return tuple(WEEK * i for i in range(self.learn_weeks))

    def queues(self) -> tuple[QueueConfig, ...]:
        if self.delay_override is not None:
            return tuple(
                QueueConfig(q.name, max(self.delay_override, 0), q.max_length)
                for q in default_queues())
        return tuple(default_queues(self.delay_scale))

    def trace_spec(self, shifted: bool = False) -> TraceSpec:
        shift = self.eval_shift if shifted else 0.0
        return TraceSpec(
            family=self.family, hours=self.hours, capacity=self.capacity,
            utilization=self.utilization,
            seed=self.seed + 1 + (99 if shifted else 0),
            elasticity=self.elasticity, mode=self.mode,
            length_scale=self.length_scale * (1 + shift),
            rate_scale=self.rate_scale * (1 + shift))

    # --- materialization ----------------------------------------------------

    def materialize(self) -> MaterializedScenario:
        """Resolve to concrete (cluster, ci, jobs, splits); cached, so the
        same ``Scenario`` instance always yields the same job lists."""
        cached = self.__dict__.get("_materialized")
        if cached is not None:
            return cached
        cluster = ClusterConfig(capacity=self.capacity, queues=self.queues())
        mci = geo = None
        if self.is_geo:
            mci = MultiRegionCarbonService.synthetic(
                self.regions, self.hours + CI_MARGIN_HOURS, seed=self.seed,
                model=self.forecast, outage=self.ci_outage)
            geo = GeoCluster.split(self.capacity, self.regions,
                                   queues=self.queues(),
                                   migration=self.migration)
            ci = mci.service(0)
        else:
            ci = CarbonService.synthetic(self.region,
                                         self.hours + CI_MARGIN_HOURS,
                                         seed=self.seed, model=self.forecast,
                                         outage=self.ci_outage)
        spec = self.trace_spec()
        if self.serving is not None:
            # Serving worlds have no job trace: the workload is the
            # per-slot demand vector (seed + 2 keeps the request stream
            # independent of the CI trace (seed) and the batch-job stream
            # (seed + 1)); `rate` extends a day past the nominal span so
            # policy look-ahead near the window end stays on real data.
            sv = self.serving
            demand = generate_request_demand(
                self.hours, sv.requests_per_day, seed=self.seed + 2,
                diurnal=sv.diurnal, weekly=sv.weekly,
                peak_hour=sv.peak_hour, burst_rate=sv.burst_rate,
                burst_mult=sv.burst_mult,
                burst_mean_slots=sv.burst_mean_slots)
            rate = expected_request_rate(
                self.hours + 24, sv.requests_per_day, diurnal=sv.diurnal,
                weekly=sv.weekly, peak_hour=sv.peak_hour)
            mat = MaterializedScenario(
                scenario=self, cluster=cluster, ci=ci, spec=spec,
                jobs=[], hist=[], eval_jobs=[], t0=self.t0,
                mean_length=0.0,
                serving=MaterializedServing(config=sv, demand=demand,
                                            rate=rate))
            object.__setattr__(self, "_materialized", mat)
            return mat

        def _gen(s: TraceSpec) -> list[Job]:
            if self.dag is not None:
                return generate_dag_trace(s, self.dag, cluster.queues)
            return generate_trace(s, cluster.queues)

        jobs = _gen(spec)
        t0 = self.t0
        # Arrival-based splits keep DAGs whole: every task of a DAG
        # arrives at the DAG's slot (gating releases it later).
        hist = [j for j in jobs if j.arrival < t0]
        if self.eval_shift:
            shifted = _gen(self.trace_spec(shifted=True))
            eval_jobs = [j for j in shifted if t0 <= j.arrival < self.hours]
            jobs = hist + eval_jobs
        else:
            eval_jobs = [j for j in jobs if t0 <= j.arrival < self.hours]
        mat = MaterializedScenario(
            scenario=self, cluster=cluster, ci=ci, spec=spec, jobs=jobs,
            hist=hist, eval_jobs=eval_jobs, t0=t0,
            mean_length=(dag_mean_task_length(self.dag, self.length_scale)
                         if self.dag is not None else mean_length(spec)),
            mci=mci, geo=geo)
        object.__setattr__(self, "_materialized", mat)
        return mat

    # --- serialization ------------------------------------------------------

    def to_dict(self) -> dict:
        """JSON-safe payload, the JAX package's keys in its order."""
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        d["regions"] = list(self.regions)
        d["faults"] = fault_to_dict(self.faults)
        d["ci_outage"] = outage_to_dict(self.ci_outage)
        if self.migration is not None:
            d["migration"] = dataclasses.asdict(self.migration)
        if self.dag is not None:
            d["dag"] = {**dataclasses.asdict(self.dag),
                        "shapes": list(self.dag.shapes)}
        d["forecast"] = forecast_to_dict(self.forecast)
        if self.serving is not None:
            d["serving"] = dataclasses.asdict(self.serving)
        if self.mpc is not None:
            d["mpc"] = self.mpc.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Scenario":
        """Inverse of :meth:`to_dict`."""
        d = dict(d)
        d["regions"] = tuple(d.get("regions", ()))
        if d.get("faults"):
            d["faults"] = fault_from_dict(d["faults"])
        else:
            d.pop("faults", None)
        if d.get("ci_outage"):
            d["ci_outage"] = outage_from_dict(d["ci_outage"])
        else:
            d.pop("ci_outage", None)
        if not d.get("mpc"):
            d.pop("mpc", None)
        if d.get("migration"):
            d["migration"] = MigrationModel(**d["migration"])
        if d.get("dag"):
            d["dag"] = DagConfig(**d["dag"])
        if d.get("forecast"):
            d["forecast"] = forecast_from_dict(d["forecast"])
        if d.get("serving"):
            d["serving"] = ServingConfig(**d["serving"])
        if d.get("mpc"):
            d["mpc"] = MPCConfig.from_dict(d["mpc"])
        return cls(**d)

    def to_json(self, indent: int | None = None) -> str:
        """JSON form of :meth:`to_dict` (round-trips every fault kind)."""
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, payload: str) -> "Scenario":
        """Inverse of :meth:`to_json`; unknown fault kinds raise a
        ``ValueError`` naming the registered kinds."""
        return cls.from_dict(json.loads(payload))
