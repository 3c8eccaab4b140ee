"""The port's forecast models (``core/forecast.py``) and the forecast model
of ``CarbonService``, against the JAX package.

Every RNG stream is numpy and seeded as the reference seeds it, so each
model's ``predict`` and ``quantile`` must equal the reference's exactly over
seeds, query slots and horizons; the dict round trip and the sweep labels
equal; ``CarbonService(model=...)``'s forecast features equal; the port's
``model=StaticNoiseForecast(...)`` and its ``forecast_noise`` shim give the
reference's deprecated knob's output, and ``CarbonService``'s fields follow
the reference's order and defaults.  Last, the
scan engine's perfect-forecast fast path reads the service's forecast
model: a noisy-forecast scenario under ``wait-awhile`` on the scan engine
equals the vector engine.
"""
import contextlib
import dataclasses
import json
import warnings

import numpy as np
import pytest

from repro.core import forecast as ref_fc
from repro.core.carbon import CarbonService as RefCarbonService
from repro_torch.core import forecast as fc
from repro_torch.core import scan_engine
from repro_torch.core.carbon import CarbonService, synthesize_trace
from repro_torch.experiment import Scenario, run

MODELS = [
    ("PerfectForecast", {}),
    ("PersistenceForecast", {}),
    ("PersistenceForecast", {"period": 7}),
    ("NoisyForecast", {}),
    ("NoisyForecast", {"sigma": 0.3, "phi": 0.5, "seed": 5, "floor": 20.0}),
    ("QuantileForecast", {"sigma": 0.2, "seed": 5, "members": 7}),
    ("QuantileForecast", {"members": 2, "phi": 0.0}),
    ("StaticNoiseForecast", {"sigma": 0.15, "seed": 3}),
]
IDS = [f"{name}{kw}" for name, kw in MODELS]


def pair(name, kw):
    return getattr(fc, name)(**kw), getattr(ref_fc, name)(**kw)


@pytest.fixture(scope="module")
def traces():
    return [synthesize_trace("south-australia", 24 * 9, seed=1),
            synthesize_trace("poland", 24 * 3, seed=4)[:50]]


@pytest.mark.parametrize("name,kw", MODELS, ids=IDS)
def test_predict_and_quantile_equal_the_reference(traces, name, kw):
    port, ref = pair(name, kw)
    for trace in traces:
        for t in (0, 1, 23, 49, len(trace) - 3, len(trace) + 5):
            for h in (1, 24, 48):
                np.testing.assert_array_equal(port.predict(trace, t, h),
                                              ref.predict(trace, t, h))
                if hasattr(ref, "quantile"):
                    for q in (0.1, 0.5, 0.9):
                        np.testing.assert_array_equal(port.quantile(trace, t, h, q),
                                                      ref.quantile(trace, t, h, q))
                else:
                    assert not hasattr(port, "quantile")


@pytest.mark.parametrize("name,kw", MODELS, ids=IDS)
def test_dict_round_trip_and_labels_equal_the_reference(name, kw):
    port, ref = pair(name, kw)
    d = fc.forecast_to_dict(port)
    assert json.dumps(d) == json.dumps(ref_fc.forecast_to_dict(ref))
    assert fc.forecast_from_dict(d) == port
    assert fc.forecast_label(port) == ref_fc.forecast_label(ref)


def test_labels_disambiguate_as_the_reference():
    axis = [None, fc.NoisyForecast(sigma=0.2), fc.NoisyForecast(sigma=0.2, seed=1),
            fc.NoisyForecast(sigma=0.2), fc.QuantileForecast(sigma=0.2)]
    ref_axis = [None, ref_fc.NoisyForecast(sigma=0.2),
                ref_fc.NoisyForecast(sigma=0.2, seed=1),
                ref_fc.NoisyForecast(sigma=0.2), ref_fc.QuantileForecast(sigma=0.2)]
    assert fc.forecast_labels(axis) == ref_fc.forecast_labels(ref_axis)
    assert fc.forecast_to_dict(None) is None and fc.forecast_from_dict(None) is None
    with pytest.raises(ValueError, match="unknown forecast kind"):
        fc.forecast_from_dict({"kind": "oracle"})
    with pytest.raises(ValueError, match=">= 2 members"):
        fc.QuantileForecast(members=1)


@pytest.mark.parametrize("q", [1e-6, 0.01, 0.02425, 0.3, 0.5, 0.9, 0.99, 1 - 1e-6])
def test_norm_ppf_equals_the_reference(q):
    assert fc._norm_ppf(q) == ref_fc._norm_ppf(q)


def test_memo_is_per_instance():
    """``_memo1`` caches on the model instance: a ``dataclasses.replace``
    of the model draws its own stream and shares no cache."""
    trace = synthesize_trace("germany", 100, seed=2)
    a = fc.NoisyForecast(sigma=0.3, seed=1)
    first = a.predict(trace, 10, 24)
    assert a.predict(trace, 10, 24) is first
    b = dataclasses.replace(a, seed=2)
    assert "_memo" not in b.__dict__
    assert not np.array_equal(b.predict(trace, 10, 24), first)
    np.testing.assert_array_equal(dataclasses.replace(a).predict(trace, 10, 24), first)


@pytest.mark.parametrize("name,kw", MODELS, ids=IDS)
def test_carbon_service_features_equal_the_reference(name, kw):
    port_m, ref_m = pair(name, kw)
    port = CarbonService.synthetic("california", 24 * 10, seed=6, model=port_m)
    ref = RefCarbonService.synthetic("california", 24 * 10, seed=6, model=ref_m)
    assert port.horizon == ref.horizon == 24
    for t in (0, 5, 100, 239):
        np.testing.assert_array_equal(port.forecast(t), ref.forecast(t))
        np.testing.assert_array_equal(port.forecast(t, 7), ref.forecast(t, 7))
        np.testing.assert_array_equal(port.forecast_quantile(t, q=0.8),
                                      ref.forecast_quantile(t, q=0.8))
        np.testing.assert_array_equal(port.forecast_extended(t, 60),
                                      ref.forecast_extended(t, 60))
        assert port.rank(t) == ref.rank(t)
        assert port.percentile_threshold(t, 30) == ref.percentile_threshold(t, 30)
        assert port.gradient(t) == ref.gradient(t)


def test_default_model_is_perfect():
    svc = CarbonService.synthetic("texas", 48, seed=1)
    assert type(svc.model) is fc.PerfectForecast
    np.testing.assert_array_equal(svc.forecast(3), svc.trace[3:27])


def test_static_noise_model_equals_the_reference_noise_knob():
    trace = synthesize_trace("germany", 24 * 5, seed=2)
    port = CarbonService(trace=trace, model=fc.StaticNoiseForecast(sigma=0.2, seed=9))
    with pytest.warns(DeprecationWarning):
        ref = RefCarbonService(trace=trace, forecast_noise=0.2, seed=9)
    for t in (0, 30, 110):
        np.testing.assert_array_equal(port.forecast(t), ref.forecast(t))
        assert port.rank(t) == ref.rank(t)
    with pytest.warns(DeprecationWarning):
        knob = CarbonService(trace=trace, forecast_noise=0.2, seed=9)
    for t in (0, 30, 110):
        np.testing.assert_array_equal(knob.forecast(t), ref.forecast(t))


def _forecasts(svc):
    return [svc.forecast(t) for t in (0, 17, 90)] + [svc.forecast(40, 6)]


@pytest.mark.parametrize("args,kw", [
    ((), {}), ((0.0,), {}), ((0.0, 12), {}), ((0.0, 24, 4), {}),
    ((0.25,), {}), ((0.25, 12, 4), {}), ((), {"forecast_noise": 0.1, "seed": 2}),
    ((), {"horizon": 8, "seed": 3}), ((0.3,), {"horizon": 6, "seed": 11})], ids=str)
def test_carbon_service_fields_follow_the_reference(args, kw):
    """The fields in the reference's order with its defaults: the same
    positional or keyword call builds the same service (``CarbonService(
    trace, 24)`` is a noise sigma of 24 in both), with the deprecated
    knob's warning, its forecasts equal bit for bit; the knob is zeroed
    after use, so ``dataclasses.replace`` round-trips."""
    trace = synthesize_trace("germany", 24 * 6, seed=4)
    noisy = (args[0] if args else kw.get("forecast_noise", 0.0)) > 0
    with pytest.warns(DeprecationWarning) if noisy else _no_warning():
        port = CarbonService(trace, *args, **kw)
    with pytest.warns(DeprecationWarning) if noisy else _no_warning():
        ref = RefCarbonService(trace, *args, **kw)
    names = [f.name for f in dataclasses.fields(RefCarbonService)]
    assert [f.name for f in dataclasses.fields(CarbonService)] == names
    for name in ("forecast_noise", "horizon", "seed"):
        assert getattr(port, name) == getattr(ref, name)
    assert type(port.model).__name__ == type(ref.model).__name__
    for a, b in zip(_forecasts(port), _forecasts(ref)):
        np.testing.assert_array_equal(a, b)
    again = dataclasses.replace(port, horizon=port.horizon)
    assert again.forecast_noise == 0.0 and again.model == port.model
    for a, b in zip(_forecasts(again), _forecasts(ref)):
        np.testing.assert_array_equal(a, b)


@contextlib.contextmanager
def _no_warning():
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        yield


def test_carbon_service_knob_beside_a_model_raises_and_synthetic_keeps_its_seed():
    trace = synthesize_trace("texas", 48, seed=1)
    for cls in (CarbonService, RefCarbonService):
        with pytest.raises(ValueError, match="not both"):
            cls(trace, 0.2, model=fc.PerfectForecast() if cls is CarbonService
                else ref_fc.PerfectForecast())
    with pytest.warns(DeprecationWarning):
        port = CarbonService.synthetic("texas", 72, seed=5, forecast_noise=0.2)
    with pytest.warns(DeprecationWarning):
        ref = RefCarbonService.synthetic("texas", 72, seed=5, forecast_noise=0.2)
    assert port.seed == ref.seed == 5
    for a, b in zip(_forecasts(port), _forecasts(ref)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("model", [fc.NoisyForecast(sigma=0.3, seed=5),
                                   fc.PersistenceForecast()],
                         ids=["noisy", "persistence"])
def test_scan_fast_path_reads_the_forecast_model(model):
    """``wait-awhile``'s eligibility tables on the scan engine come from
    the forecast the policy sees: under a noisy or persistence forecast
    they must equal the vector engine's, not the true trace's."""
    sc = dict(capacity=8, learn_weeks=1, family="alibaba", seed=101, forecast=model)
    names = ["wait-awhile", "wait-awhile-robust"]
    scan_engine.reset_stats()
    scan = run(Scenario(engine="scan", **sc), names, device="cpu")
    assert scan_engine.stats["delegated"] == 0 and scan_engine.stats["steps"] > 0
    vec = run(Scenario(**sc), names, device="cpu")
    perfect = run(Scenario(**{**sc, "forecast": None}), names, device="cpu")
    for name in names:
        (a,), (b,), (p,) = scan.weekly[name], vec.weekly[name], perfect.weekly[name]
        assert a.carbon_g == b.carbon_g and a.energy_kwh == b.energy_kwh
        np.testing.assert_array_equal(a.completion, b.completion)
        assert [vars(x) for x in a.slots] == [vars(y) for y in b.slots]
        assert a.carbon_g != p.carbon_g        # the forecast matters here
