"""The reference's ten examples on the port (the counterparts of the JAX
package's ``examples/``), each run as ``python -m repro_torch.examples.<name>``:

- ``quickstart``            — CarbonFlex end to end on a synthetic cluster;
- ``cluster_sim_year``      — weeks of operation with continuous re-learning;
- ``dag_quickstart``        — precedence-constrained (DAG) jobs;
- ``geo_quickstart``        — shifting load across regions;
- ``forecast_quickstart``   — robustness to carbon-forecast error;
- ``resilience_quickstart`` — faults and a stale carbon feed;
- ``serving_quickstart``    — request routing across precision tiers;
- ``telemetry_quickstart``  — decision traces, attribution, phase profiles;
- ``serve_elastic``         — batched LM decode with a KV cache;
- ``train_carbon_aware``    — CarbonFlex's hourly plan driving
                              ``ElasticTrainer``: the paper's whole loop on a
                              real model.

Each keeps the reference example's arguments, defaults and printed lines and
adds ``--device`` (default ``"cuda"``), passed to every entry point it calls:
without a CUDA device it raises unless given ``--device cpu``.  Each
``main(argv=None)`` returns what it printed: the study's result object, a
dict of them, or the trainer's result.
"""
