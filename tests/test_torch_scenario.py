"""The port's ``Scenario`` takes the reference's fields in the reference's
order: positional and keyword calls bind the same names in both packages,
and the fields of the ported forecast, MPC, geo, fault, feed-outage and
serving layers reach the world and the serialization, byte for byte the
reference's JSON."""
import dataclasses

import pytest

from repro.core.faults import CarbonDataOutage as RefCarbonDataOutage
from repro.core.faults import PreemptionFaults as RefPreemptionFaults
from repro.core.forecast import NoisyForecast as RefNoisyForecast
from repro.core.mpc import MPCConfig as RefMPCConfig
from repro.core.types import MigrationModel as RefMigrationModel
from repro.experiment import Scenario as RefScenario
from repro.serving import ServingConfig as RefServingConfig
from repro_torch.core.faults import CarbonDataOutage, PreemptionFaults
from repro_torch.core.forecast import NoisyForecast
from repro_torch.core.mpc import MPCConfig
from repro_torch.core.types import MigrationModel
from repro_torch.experiment import Scenario, ServingConfig

# The fields whose layers the eleventh slice ported (faults, feed outages,
# serving); each used to raise when set.
FORMERLY_UNPORTED = ("faults", "ci_outage", "serving")
PORTED = {"faults": (PreemptionFaults(rate=0.03, checkpoint_every=6, seed=5),
                     RefPreemptionFaults(rate=0.03, checkpoint_every=6, seed=5)),
          "ci_outage": (CarbonDataOutage(rate=0.05, seed=9, windows=((3, 7),)),
                        RefCarbonDataOutage(rate=0.05, seed=9, windows=((3, 7),))),
          "serving": (ServingConfig(requests_per_day=3e5, servers=16),
                      RefServingConfig(requests_per_day=3e5, servers=16)),
          "forecast": (NoisyForecast(sigma=0.2, seed=3),
                       RefNoisyForecast(sigma=0.2, seed=3)),
          "mpc": (MPCConfig(horizon=24, scale_rho=0.3),
                  RefMPCConfig(horizon=24, scale_rho=0.3)),
          "regions": (("south-australia", "california"),
                      ("south-australia", "california")),
          "migration": (MigrationModel(base_slots=2, energy_kwh_per_gb=0.07),
                        RefMigrationModel(base_slots=2, energy_kwh_per_gb=0.07))}


def test_field_names_in_the_reference_order():
    assert [f.name for f in dataclasses.fields(Scenario)] == \
        [f.name for f in dataclasses.fields(RefScenario)]


def test_defaults_equal_the_reference():
    ref, port = RefScenario(), Scenario()
    for f in dataclasses.fields(Scenario):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name


@pytest.mark.parametrize("args", [
    ("california",),
    ("california", ()),
    ("poland", (), None, None, None, "alibaba", 12, 0.4, 2, 3, 5, "low", "gpu",
     0.5, 1.5, 0.8, 3, 0.1),
])
def test_positional_call_binds_the_same_names(args):
    ref, port = RefScenario(*args), Scenario(*args)
    for f in dataclasses.fields(Scenario):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    kw = {f.name: getattr(port, f.name) for f in dataclasses.fields(Scenario)}
    assert Scenario(**kw) == port


def test_region_then_family_positionally_is_refused_in_both():
    """``Scenario("california", "alibaba")`` is a geo call in both packages
    (``regions="alibaba"``, refused as an unknown region); it must not
    quietly set ``family``."""
    with pytest.raises(ValueError) as ref:
        RefScenario("california", "alibaba")
    with pytest.raises(ValueError) as port:
        Scenario("california", "alibaba")
    assert str(port.value) == str(ref.value)
    assert Scenario("california", family="alibaba").family == "alibaba"


@pytest.mark.parametrize("name", sorted(FORMERLY_UNPORTED))
def test_setting_an_unported_field_raises(name):
    """None of the reference's fields is unported any more: setting each of
    the last three builds the reference's scenario, and a wrong value is
    refused as the reference refuses it."""
    port_value, ref_value = PORTED[name]
    assert Scenario(**{name: port_value}).to_json() == \
        RefScenario(**{name: ref_value}).to_json()
    if name == "serving":
        with pytest.raises(ValueError, match="ci_outage"):
            Scenario(serving=port_value, faults=PORTED["faults"][0])


def test_empty_regions_is_the_default():
    assert Scenario(regions=[]).regions == ()


@pytest.mark.parametrize("name", sorted(PORTED))
def test_ported_field_reaches_the_world_and_the_payload(name):
    port_value, ref_value = PORTED[name]
    port = Scenario(capacity=8, learn_weeks=1, **{name: port_value})
    ref = RefScenario(capacity=8, learn_weeks=1, **{name: ref_value})
    assert port.to_json() == ref.to_json()
    assert Scenario.from_json(port.to_json()) == port
    if name == "forecast":
        assert port.materialize().ci.model is port_value
        assert (port.materialize().ci.forecast(30)
                == ref.materialize().ci.forecast(30)).all()
    if name == "regions":
        assert port.materialize().geo.regions == ref.materialize().geo.regions
        assert (port.materialize().mci.ci_vec(30)
                == ref.materialize().mci.ci_vec(30)).all()
    if name == "migration":
        assert Scenario.from_json(port.to_json()).migration == port_value
    if name == "faults":
        assert port.materialize().eval_jobs and port.faults is port_value
    if name == "ci_outage":
        mat = port.materialize()
        assert mat.ci.outage is port_value
        assert [mat.ci.degraded().staleness(t) for t in range(12)] == \
            [ref.materialize().ci.degraded().staleness(t) for t in range(12)]
    if name == "serving":
        assert (port.materialize().serving.demand
                == ref.materialize().serving.demand).all()


@pytest.mark.parametrize("name", sorted(FORMERLY_UNPORTED))
def test_payload_setting_an_unported_field_raises(name):
    """The reference's payload of each formerly unported field reads back
    into the port's value; an unknown fault or outage kind raises the
    reference's error."""
    port_value, ref_value = PORTED[name]
    payload = RefScenario(**{name: ref_value}).to_dict()
    assert Scenario.from_dict(payload) == Scenario(**{name: port_value})
    if name != "serving":
        bad = Scenario().to_dict()
        bad[name] = {"kind": "x"}
        with pytest.raises(ValueError, match="kind"):
            Scenario.from_dict(bad)
