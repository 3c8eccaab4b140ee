"""CarbonFlex core, single-region slice: the paper's contribution as a
composable library.

- ``oracle.solve``                 — Algorithm 1 (offline optimal)
- ``knowledge.KnowledgeBase``      — Table-2 state -> (m, rho) case base,
                                     its case matrix on the device
- ``provisioning.provision``       — Algorithm 2 (phi)
- ``scheduling.schedule``          — Algorithm 3 (psi)
- ``policy.CarbonFlexPolicy``      — the runtime resource manager
- ``policy.learn_window``          — the continuous-learning phase
- ``simulator.simulate``           — the CarbonFlex-Simulator engine
                                     (vectorised; ``engine="scalar"`` for
                                     the reference path)
- ``simulator.simulate_many``      — batched sweeps through the engines
- ``scan_engine``                  — ``engine="scan"``: the slot loop on the
                                     device, DAG gating through a CUDA kernel
- ``dag``                          — DAG workloads, criticality and the
                                     dag-fcfs/dag-carbon/dag-cap policies
- ``baselines``                    — §6 baselines (agnostic/GAIA/WaitAwhile/
                                     CarbonScaler/VCC)
- ``policy.Policy``                — the protocol every policy implements
"""
from . import baselines, carbon, dag, emissions, forecast, knowledge, oracle, policy, profiles, provisioning, scan_engine, scheduling, simulator, types  # noqa: F401
from .carbon import CarbonService, synthesize_trace  # noqa: F401
from .knowledge import KnowledgeBase  # noqa: F401
from .policy import (CarbonFlexPolicy, LearnOutcome, OraclePolicy, Policy,  # noqa: F401
                     learn_window)
from .simulator import SimCase, simulate, simulate_many  # noqa: F401
from .types import ClusterConfig, Job, QueueConfig, SimResult  # noqa: F401
