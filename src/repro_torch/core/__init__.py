"""CarbonFlex core: the paper's contribution as a composable library.

- ``oracle.solve``                 — Algorithm 1 (offline optimal)
- ``knowledge.KnowledgeBase``      — Table-2 state -> (m, rho) case base,
                                     its case matrix on the device
- ``provisioning.provision``       — Algorithm 2 (phi)
- ``scheduling.schedule``          — Algorithm 3 (psi)
- ``policy.CarbonFlexPolicy``      — the runtime resource manager
- ``mpc.CarbonFlexMPCPolicy``      — receding-horizon execution planner
                                     (+ ``CarbonFlexScalePolicy`` marginal-
                                     capacity scale-up, ``oracle-estimated``
                                     oracle on learned lengths)
- ``policy.learn_window``          — the continuous-learning phase
- ``simulator.simulate``           — the CarbonFlex-Simulator engine
                                     (vectorised; ``engine="scalar"`` for
                                     the reference path)
- ``simulator.simulate_many``      — batched sweeps through the engines
- ``scan_engine``                  — ``engine="scan"``: the slot loop on the
                                     device, DAG gating through a CUDA kernel
- ``geo``                          — geo-distributed placement policies
                                     (``geo-static``/``geo-greedy``/
                                     ``geo-flex``) over ``GeoCluster`` +
                                     ``MultiRegionCarbonService`` worlds
- ``dag``                          — DAG workloads, criticality and the
                                     dag-fcfs/dag-carbon/dag-cap policies
- ``baselines``                    — §6 baselines (agnostic/GAIA/WaitAwhile/
                                     CarbonScaler/VCC)
- ``forecast``                     — pluggable carbon-forecast models
                                     (perfect / persistence / noisy AR(1)
                                     / quantile ensemble) behind
                                     ``CarbonService.forecast``, plus the
                                     quantile view robust policies use
- ``faults``                       — resilience layer: pluggable fault
                                     processes (iid stragglers, correlated
                                     failure-domain outages, preemption
                                     with checkpoint/restore) and
                                     carbon-feed outage injection with a
                                     degraded policy-side CI view
- ``policy.Policy``                — the protocol every policy implements
"""
from . import baselines, carbon, dag, emissions, faults, forecast, geo, knowledge, mpc, oracle, policy, profiles, provisioning, scan_engine, scheduling, simulator, types  # noqa: F401
from .carbon import CarbonService, MultiRegionCarbonService, synthesize_trace  # noqa: F401
from .dag import (DagCapPolicy, DagCarbonPolicy, DagFcfsPolicy, DagSpec,  # noqa: F401
                  TaskNode, criticality_from_jobs, expand_dags)
from .faults import (CarbonDataOutage, CorrelatedFaults, FaultProcess,  # noqa: F401
                     IidFaults, PreemptionFaults, fault_from_dict,
                     fault_label, fault_to_dict, outage_from_dict,
                     outage_to_dict)
from .forecast import (ForecastModel, NoisyForecast, PerfectForecast,  # noqa: F401
                       PersistenceForecast, QuantileForecast,
                       StaticNoiseForecast, forecast_from_dict,
                       forecast_label, forecast_to_dict)
from .geo import GeoFlexPolicy, GeoGreedyPolicy, GeoPolicy, GeoStaticPolicy  # noqa: F401
from .knowledge import KnowledgeBase  # noqa: F401
from .mpc import (CarbonFlexMPCPolicy, CarbonFlexScalePolicy,  # noqa: F401
                  EstimatedOraclePolicy, MPCConfig)
from .policy import (CarbonFlexPolicy, LearnOutcome, OraclePolicy, Policy,  # noqa: F401
                     learn_window)
from .simulator import FaultModel, SimCase, simulate, simulate_many  # noqa: F401
from .types import (ClusterConfig, GeoCluster, Job, MigrationModel,  # noqa: F401
                    QueueConfig, ResilienceMetrics, SimResult)
