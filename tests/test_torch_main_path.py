"""The single-region CarbonFlex loop of the PyTorch port, end to end,
against the JAX package.

``repro_torch.experiment.run`` on the CPU must reproduce
``repro.experiment.run`` on the vector engine for every policy of the
slice: carbon, energy, violations and waits equal (rtol 1e-12 on the
floats; they agree bit for bit), and the per-slot provisioned capacity
``m_t`` identical.  The port's own vector and scalar engines agree bit for
bit.  Without a CUDA device, ``run()`` with its default device raises.
"""
import numpy as np
import pytest
import torch

from repro.experiment import Scenario as RefScenario
from repro.experiment import run as ref_run
from repro.experiment.registry import available_policies as ref_available_policies
from repro_torch.experiment import Scenario, available_policies, run

POLICIES = ("carbon-agnostic", "gaia", "wait-awhile", "wait-awhile-robust",
            "carbonscaler", "vcc", "vcc-scaling", "carbonflex",
            "carbonflex-robust", "oracle")
# two evaluation weeks, so the driver's continuous re-learning runs too
SCENARIO = dict(capacity=8, learn_weeks=1, family="alibaba", seed=101,
                eval_weeks=2)


@pytest.fixture(scope="module")
def results():
    ref = ref_run(RefScenario(**SCENARIO), POLICIES)
    vec = run(Scenario(**SCENARIO), POLICIES, device="cpu")
    sca = run(Scenario(**SCENARIO, engine="scalar"), POLICIES, device="cpu")
    return ref, vec, sca


def test_registry_covers_the_slice():
    # the single-region policies, the MPC family, the geo family, the DAG
    # family and the serve family: every policy of the reference's registry
    assert set(available_policies()) == set(POLICIES) | {
        "carbonflex-mpc", "carbonflex-scale", "oracle-estimated",
        "geo-static", "geo-greedy", "geo-flex",
        "dag-fcfs", "dag-carbon", "dag-cap",
        "serve-static", "serve-greedy", "serve-flex"} == set(ref_available_policies())


@pytest.mark.parametrize("policy", POLICIES)
def test_run_matches_reference(results, policy):
    ref, port, _ = results
    assert port.kb_size == ref.kb_size > 0
    assert len(port.weekly[policy]) == len(ref.weekly[policy]) == 2
    for a, b in zip(ref.weekly[policy], port.weekly[policy]):
        np.testing.assert_allclose(b.carbon_g, a.carbon_g, rtol=1e-12)
        np.testing.assert_allclose(b.energy_kwh, a.energy_kwh, rtol=1e-12)
        np.testing.assert_array_equal(b.violations, a.violations)
        np.testing.assert_array_equal(b.wait_slots, a.wait_slots)
        np.testing.assert_array_equal(b.completion, a.completion)
        assert [s.provisioned for s in b.slots] == \
            [s.provisioned for s in a.slots]
        assert [s.used for s in b.slots] == [s.used for s in a.slots]
    assert port.savings(policy) == ref.savings(policy)


@pytest.mark.parametrize("policy", POLICIES)
def test_vector_and_scalar_engines_bit_identical(results, policy):
    _, vec, sca = results
    for a, b in zip(vec.weekly[policy], sca.weekly[policy]):
        assert a.carbon_g == b.carbon_g and a.energy_kwh == b.energy_kwh
        np.testing.assert_array_equal(a.violations, b.violations)
        np.testing.assert_array_equal(a.wait_slots, b.wait_slots)
        np.testing.assert_array_equal(a.completion, b.completion)
        assert [vars(s) for s in a.slots] == [vars(s) for s in b.slots]


def test_quickstart_tiny_table_matches_reference():
    """``examples/quickstart.py --tiny`` minus its MPC policy: the same
    savings table, character for character."""
    sc = dict(region="south-australia", capacity=10, learn_weeks=1, seed=1)
    names = ["carbon-agnostic", "wait-awhile", "carbonflex", "oracle"]
    ref = ref_run(RefScenario(**sc), names)
    port = run(Scenario(**sc), names, device="cpu")
    assert port.table() == ref.table()
    assert port.metrics() == ref.metrics()
    assert port.runtime_s >= port.learn_s + port.execute_s > 0


def test_unknown_policy_raises_before_work():
    with pytest.raises(ValueError, match="registered policies"):
        run(Scenario(**SCENARIO), ["serve-turbo"], device="cpu")
    with pytest.raises(ValueError, match="serving workload"):
        run(Scenario(**SCENARIO), ["serve-flex"], device="cpu")
    with pytest.raises(ValueError, match="geo-distributed"):
        run(Scenario(**SCENARIO), ["geo-flex"], device="cpu")


def test_run_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        run(Scenario(**SCENARIO), ["carbon-agnostic"])
