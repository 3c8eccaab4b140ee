"""The PyTorch port builds the same world as the JAX package.

``Scenario.materialize()`` of ``repro_torch`` must give job lists equal
field for field and CI traces, forecasts and Table-2 CI features equal
bit for bit to ``repro``'s, from the same seed: both draw every random
number from the same numpy ``Generator`` streams.
"""
import dataclasses

import numpy as np
import pytest

from repro.experiment import Scenario as RefScenario
from repro_torch.core.carbon import synthesize_trace
from repro_torch.core.faults import IidFaults
from repro_torch.experiment import Scenario, ServingConfig
from repro.core.carbon import synthesize_trace as ref_synthesize_trace

SCENARIOS = {
    # tests/test_golden_sweep.py's base scenario
    "golden": dict(capacity=8, learn_weeks=1, family="alibaba", seed=101),
    # examples/quickstart.py --tiny
    "quickstart-tiny": dict(region="south-australia", capacity=10,
                            learn_weeks=1, seed=1),
    # the branches the two above leave out: class elasticity, GPU power,
    # uniform slack, the Fig. 13 shifted evaluation weeks
    "shifted": dict(region="california", family="surf", capacity=12,
                    learn_weeks=2, eval_weeks=2, seed=5, elasticity="low",
                    mode="gpu", delay_override=3, eval_shift=0.2),
    "rigid": dict(region="poland", capacity=6, learn_weeks=1, seed=9,
                  elasticity="none", delay_scale=0.5),
}


def _assert_jobs_equal(ref_jobs, jobs):
    assert len(ref_jobs) == len(jobs) > 0
    for rj, j in zip(ref_jobs, jobs):
        assert rj.deps == ()
        for f in dataclasses.fields(j):
            a, b = getattr(rj, f.name), getattr(j, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            else:
                assert type(a) is type(b) and a == b, (f.name, a, b)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_materialize_matches_reference(name):
    ref = RefScenario(**SCENARIOS[name]).materialize()
    mat = Scenario(**SCENARIOS[name]).materialize()
    assert dataclasses.asdict(mat.cluster) == dataclasses.asdict(ref.cluster)
    assert (mat.t0, mat.mean_length) == (ref.t0, ref.mean_length)
    assert dataclasses.asdict(mat.spec) == dataclasses.asdict(ref.spec)
    _assert_jobs_equal(ref.jobs, mat.jobs)
    _assert_jobs_equal(ref.hist, mat.hist)
    _assert_jobs_equal(ref.eval_jobs, mat.eval_jobs)
    for w in range(mat.scenario.eval_weeks):
        _assert_jobs_equal(ref.eval_week(w), mat.eval_week(w))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_ci_trace_and_forecast_features_bit_equal(name):
    ref = RefScenario(**SCENARIOS[name]).materialize().ci
    ci = Scenario(**SCENARIOS[name]).materialize().ci
    assert ci.trace.dtype == ref.trace.dtype
    np.testing.assert_array_equal(ci.trace, ref.trace)
    assert ci.degraded() is ci
    # every slot, past the trace end included (the padded forecast)
    for t in list(range(0, len(ci), 7)) + [len(ci) - 1]:
        np.testing.assert_array_equal(ci.forecast(t), ref.forecast(t))
        np.testing.assert_array_equal(ci.forecast(t, 60), ref.forecast(t, 60))
        np.testing.assert_array_equal(ci.forecast_extended(t, 50),
                                      ref.forecast_extended(t, 50))
        np.testing.assert_array_equal(ci.forecast_quantile(t, 30, q=0.7),
                                      ref.forecast_quantile(t, 30, q=0.7))
        assert ci.ci(t) == ref.ci(t)
        assert ci.gradient(t) == ref.gradient(t)
        assert ci.rank(t) == ref.rank(t)
        assert ci.percentile_threshold(t, 30.0) == \
            ref.percentile_threshold(t, 30.0)
    np.testing.assert_array_equal(ci.forecast(len(ci) + 5),
                                  ref.forecast(len(ci) + 5))


@pytest.mark.parametrize("region", ["south-australia", "sweden", "texas"])
def test_synthesize_trace_bit_equal(region):
    np.testing.assert_array_equal(synthesize_trace(region, 500, seed=3),
                                  ref_synthesize_trace(region, 500, seed=3))


def test_scenario_rejects_what_the_slice_lacks():
    with pytest.raises(ValueError, match="unknown region"):
        Scenario(region="nowhere")
    with pytest.raises(ValueError, match="engine"):
        Scenario(engine="jit")             # "scan" is ported (DAG slice)
    with pytest.raises(ValueError, match="ci_outage"):
        Scenario(serving=ServingConfig(), faults=IidFaults(failure_rate=0.01))


# --------------------------------------------------------------------------
# elasticity="tpu": LM-training jobs whose profiles come from dry-run cells
# under ``results/dryrun_opt`` of the working directory, one architecture
# draw per job, the parametric mix where a cell is missing

TPU_ARCHS = ["stablelm-1.6b", "minicpm-2b", "internvl2-2b", "llama3-8b", "rwkv6-7b",
             "zamba2-7b", "musicgen-large", "dbrx-132b", "qwen3-moe-235b-a22b",
             "command-r-plus-104b"]


@pytest.fixture
def tpu_world(tmp_path, monkeypatch):
    """A fresh working directory and both packages' profile caches empty;
    ``plant(archs)`` writes reference-format train_4k cells for ``archs``."""
    import json

    from repro.traces import workloads as ref_workloads
    from repro_torch.traces import workloads

    for cache in (ref_workloads._TPU_PROFILE_CACHE, workloads._TPU_PROFILE_CACHE):
        cache.clear()
    monkeypatch.chdir(tmp_path)

    def plant(archs):
        d = tmp_path / "results" / "dryrun_opt"
        d.mkdir(parents=True, exist_ok=True)
        for i, arch in enumerate(archs):
            # per-device FLOPs and bytes of a 16x16 cell, scaled per arch
            cell = {"chips": 256, "params_active": 1_000_000_000 * (i + 1),
                    "hlo_stats": {"flops": 3.1e13 * (i + 2) ** 1.5,
                                  "hbm_bytes": 5.3e11 * (i + 3)}}
            (d / f"{arch}__train_4k__16x16.json").write_text(json.dumps(cell))

    yield plant
    for cache in (ref_workloads._TPU_PROFILE_CACHE, workloads._TPU_PROFILE_CACHE):
        cache.clear()


@pytest.mark.parametrize("planted", [(), ("llama3-8b", "dbrx-132b", "zamba2-7b", "minicpm-2b")],
                         ids=["no-cells", "some-cells"])
@pytest.mark.parametrize("mode", ["cpu", "gpu"])
def test_tpu_trace_matches_reference(tpu_world, planted, mode):
    from repro.traces import TraceSpec as RefTraceSpec
    from repro.traces import generate_trace as ref_generate_trace
    from repro_torch.traces import TraceSpec, generate_trace

    tpu_world(planted)
    kw = dict(elasticity="tpu", capacity=40, seed=4, mode=mode, k_max=12)
    ref_jobs = ref_generate_trace(RefTraceSpec(**kw))
    jobs = generate_trace(TraceSpec(**kw))
    _assert_jobs_equal(ref_jobs, jobs)
    archs = {j.arch for j in jobs}
    assert archs & set(TPU_ARCHS) == set(planted)
    assert archs - set(TPU_ARCHS)              # the fallback's Table-3 draws
    # a second trace reads the cache (or the missing files again) alike
    _assert_jobs_equal(ref_generate_trace(RefTraceSpec(**dict(kw, seed=5))),
                       generate_trace(TraceSpec(**dict(kw, seed=5))))


def test_tpu_scenario_matches_reference(tpu_world):
    from repro.experiment import run as ref_run
    from repro_torch.experiment import run

    tpu_world(TPU_ARCHS)
    sc = dict(elasticity="tpu", region="south-australia", capacity=10, learn_weeks=1,
              seed=1)
    ref = RefScenario(**sc).materialize()
    mat = Scenario(**sc).materialize()
    _assert_jobs_equal(ref.jobs, mat.jobs)
    _assert_jobs_equal(ref.eval_jobs, mat.eval_jobs)
    assert {j.arch for j in mat.jobs} <= set(TPU_ARCHS)
    names = ["carbon-agnostic", "carbonflex"]
    want = ref_run(RefScenario(**sc), names)
    got = run(Scenario(**sc), names, device="cpu")
    assert got.kb_size == want.kb_size > 0
    for name in names:
        for a, b in zip(want.weekly[name], got.weekly[name], strict=True):
            assert (b.carbon_g, b.energy_kwh) == (a.carbon_g, a.energy_kwh)
            np.testing.assert_array_equal(b.violations, a.violations)
            np.testing.assert_array_equal(b.wait_slots, a.wait_slots)
            assert [(s.provisioned, s.used) for s in b.slots] == \
                [(s.provisioned, s.used) for s in a.slots]
        assert got.savings(name) == want.savings(name)
