"""The port's ``Sweep`` against the checked-in golden fixtures and the JAX
package.

The four batch fixtures of ``tests/data/`` (the plain grid, the DAG grid,
the forecast-axis grid and the MPC grid) are rebuilt with the port's
``Sweep`` exactly as ``tests/test_golden_sweep.py`` builds them and must
reproduce the files byte for byte on the port's vector, scalar and scan
engines (``device="cpu"``).  The scan leg includes the check the
reference's ``test_golden_sweeps_byte_identical_with_scan_engine`` makes,
which cannot run on this tree (the reference scan engine does not import).
``Scenario.to_json`` equals the reference's; ``SweepResult`` round-trips
through JSON, and its CSV, summary and table equal the reference's on the
same rows; the axes the port has no layer for raise.
"""
import dataclasses
import os

import pytest

from repro.core.forecast import NoisyForecast as RefNoisyForecast
from repro.core.forecast import QuantileForecast as RefQuantileForecast
from repro.core.mpc import MPCConfig as RefMPCConfig
from repro.experiment import Scenario as RefScenario
from repro.experiment.sweep import SweepResult as RefSweepResult
from repro.traces import DagConfig as RefDagConfig
from repro_torch.core import scan_engine
from repro_torch.core.forecast import NoisyForecast, QuantileForecast
from repro_torch.core.mpc import MPCConfig
from repro_torch.core.faults import CarbonDataOutage, CorrelatedFaults
from repro_torch.experiment import Scenario, ServingConfig, Sweep, SweepResult
from repro_torch.traces import DagConfig

DATA = os.path.join(os.path.dirname(__file__), "data")
BASE = dict(capacity=8, learn_weeks=1, family="alibaba", seed=101)


def golden(name: str) -> Sweep:
    """``tests/test_golden_sweep.py``'s four batch grids, on the CPU."""
    if name == "golden_sweep":
        return Sweep(base=Scenario(**BASE), regions=["california", "ontario"],
                     seeds=[11, 12], policies=["carbon-agnostic", "gaia", "wait-awhile"],
                     device="cpu")
    if name == "golden_sweep_dag":
        return Sweep(base=Scenario(dag=DagConfig(width=3, depth=3), **BASE),
                     seeds=[11, 12], policies=["dag-fcfs", "dag-carbon", "dag-cap"],
                     device="cpu")
    if name == "golden_sweep_forecast":
        return Sweep(base=Scenario(**BASE), seeds=[11],
                     policies=["carbon-agnostic", "wait-awhile", "wait-awhile-robust"],
                     forecasts=[None, NoisyForecast(sigma=0.3, seed=5),
                                QuantileForecast(sigma=0.2, seed=5, members=7)],
                     device="cpu")
    return Sweep(base=Scenario(**BASE, engine="scan", mpc=MPCConfig(scale_rho=0.3)),
                 seeds=[11, 12],
                 policies=["carbon-agnostic", "carbonflex-mpc", "carbonflex-scale",
                           "oracle-estimated"], device="cpu")


FIXTURES = ["golden_sweep", "golden_sweep_dag", "golden_sweep_forecast",
            "golden_sweep_mpc"]


def fixture_text(name):
    with open(os.path.join(DATA, f"{name}.json")) as f:
        return f.read()


@pytest.mark.parametrize("engine", ["vector", "scalar", "scan"])
@pytest.mark.parametrize("name", FIXTURES)
def test_golden_fixture_byte_for_byte(name, engine):
    sw = golden(name)
    sw = dataclasses.replace(sw, base=dataclasses.replace(sw.base, engine=engine))
    scan_engine.reset_stats()
    assert sw.run().to_json() + "\n" == fixture_text(name)
    if engine == "scan":
        # only gaia's cells and oracle-estimated's leave the device loop
        assert scan_engine.stats["delegated"] == {"golden_sweep": 4,
                                                  "golden_sweep_mpc": 2}.get(name, 0)
        assert scan_engine.stats["steps"] > 0
        if name == "golden_sweep_mpc":
            assert scan_engine.stats["fill_steps"] > 0


def scenario_pairs():
    yield Scenario(), RefScenario()
    yield (Scenario(dag=DagConfig(width=3, depth=3), **BASE),
           RefScenario(dag=RefDagConfig(width=3, depth=3), **BASE))
    yield (Scenario(forecast=QuantileForecast(sigma=0.2, seed=5, members=7), **BASE),
           RefScenario(forecast=RefQuantileForecast(sigma=0.2, seed=5, members=7), **BASE))
    yield (Scenario(engine="scan", mpc=MPCConfig(scale_rho=0.3),
                    forecast=NoisyForecast(sigma=0.1), **BASE),
           RefScenario(engine="scan", mpc=RefMPCConfig(scale_rho=0.3),
                       forecast=RefNoisyForecast(sigma=0.1), **BASE))


@pytest.mark.parametrize("i", range(4), ids=["plain", "dag", "forecast", "mpc"])
def test_scenario_json_equals_the_reference(i):
    port, ref = list(scenario_pairs())[i]
    assert port.to_json() == ref.to_json()
    assert port.to_json(indent=2) == ref.to_json(indent=2)
    back = Scenario.from_json(port.to_json())
    assert back == port and back.to_json() == port.to_json()


@pytest.mark.parametrize("name", FIXTURES)
def test_sweep_result_round_trip_csv_and_summary(name):
    text = fixture_text(name)
    port, ref = SweepResult.from_json(text), RefSweepResult.from_json(text)
    assert port.to_json() + "\n" == text
    assert SweepResult.from_json(port.to_json()).rows() == port.rows()
    assert port.to_csv() == ref.to_csv()
    assert port.summary() == ref.summary()
    assert port.table() == ref.table()


def test_scenarios_and_labels_follow_the_reference():
    sw = golden("golden_sweep_forecast")
    scs = sw.scenarios()
    assert [(s.region, s.seed, s.forecast) for s in scs] == \
        [("south-australia", 11, f) for f in sw.forecasts]
    assert sw.effective_baseline() == "carbon-agnostic"
    assert golden("golden_sweep_dag").effective_baseline() == "dag-fcfs"
    assert golden("golden_sweep_dag")._policy_names()[0] == "dag-fcfs"
    sw2 = Sweep(base=Scenario(**BASE), policies=["wait-awhile"], device="cpu")
    assert sw2._policy_names() == ("carbon-agnostic", "wait-awhile")


def test_unported_axes_raise():
    """Every axis of the reference's ``Sweep`` builds in the port (this test
    once pinned the telemetry raise): telemetry records each cell under its
    label, and the fault axis, a base with a feed outage and a serving base
    build as in the reference."""
    from repro_torch.telemetry import MemoryRecorder, Telemetry

    tel = Telemetry(recorder=MemoryRecorder())
    res = Sweep(base=Scenario(**BASE), policies=["wait-awhile"], telemetry=tel,
                device="cpu").run()
    assert {e.run for e in tel.recorder.events} == {
        f"south-australia/s101/none/{p}" for p in ("carbon-agnostic", "wait-awhile")}
    assert len(res.rows()) == 2
    fm = CorrelatedFaults(rate=0.06, seed=2)
    sw = Sweep(base=Scenario(**BASE), faults=[None, fm],
               policies=["carbon-agnostic"], device="cpu")
    assert sw.fault_axis() == (None, fm)
    assert Sweep(base=Scenario(**BASE, faults=fm)).fault_axis() == (fm,)
    assert Sweep(base=Scenario(ci_outage=CarbonDataOutage())).scenarios()[0] \
        .ci_outage == CarbonDataOutage()
    assert Sweep(base=Scenario(serving=ServingConfig())).effective_baseline() \
        == "serve-static"


def test_fault_axis_of_none_is_labelled_none():
    sw = Sweep(base=Scenario(**BASE), faults=[None], policies=["carbon-agnostic"],
               device="cpu")
    rows = sw.run().rows()
    assert [r["fault"] for r in rows] == ["none"]


def test_sweep_defaults_to_cuda_and_raises_without_it():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Sweep(base=Scenario(**BASE), policies=["carbon-agnostic"]).run()
