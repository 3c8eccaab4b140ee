"""The port's serving tier (``repro_torch.serving``, ``traces/requests.py``,
the ``serve-*`` policies, ``Scenario(serving=...)``) against the JAX
package, compared exactly:

- the tier table and both quantisation-error replicas, ``mix_for_quality``,
  ``SloModel``, ``CreditLedger``, the request demand and the expected rate;
- each serve policy on the vector and scalar paths, under a perfect and a
  noisy forecast and under a carbon-feed outage, field for field and slot
  for slot;
- ``tests/data/golden_sweep_serving.json`` byte for byte, ``run()`` and a
  serving sweep with ``ci_outage``;
- the rejections' messages.

The serving tier is host numpy (336 slots a cell); nothing here runs on the
device.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from repro.core import CarbonService as RefCarbonService
from repro.core import NoisyForecast as RefNoisyForecast
from repro.core.faults import CarbonDataOutage as RefCarbonDataOutage
from repro.core.faults import IidFaults as RefIidFaults
from repro.experiment import Scenario as RefScenario
from repro.experiment import Sweep as RefSweep
from repro.experiment import run as ref_run
from repro.serving import ServeCase as RefServeCase
from repro.serving import ServingConfig as RefServingConfig
from repro.serving import simulate_serving as ref_simulate_serving
from repro.serving import policies as ref_policies
from repro.serving import tiers as ref_tiers
from repro.traces import DagConfig as RefDagConfig
from repro.traces import expected_request_rate as ref_expected_request_rate
from repro.traces import generate_request_demand as ref_generate_request_demand
from repro_torch.core import CarbonService, NoisyForecast
from repro_torch.core.faults import CarbonDataOutage, IidFaults
from repro_torch.experiment import (DEFAULT_SERVE_POLICIES, Scenario, ServingConfig,
                                    Sweep, run)
from repro_torch.serving import (ServeCase, ServeFlexPolicy, ServeGreedyPolicy,
                                 ServeStaticPolicy, simulate_serving, tiers)
from repro_torch.traces import DagConfig, expected_request_rate, generate_request_demand

WEEK = 24 * 7
TINY = dict(requests_per_day=2e5, servers=12)
FIXTURE = Path(__file__).resolve().parent / "data" / "golden_sweep_serving.json"
POLICIES = {"serve-static": (ServeStaticPolicy, ref_policies.ServeStaticPolicy),
            "serve-greedy": (ServeGreedyPolicy, ref_policies.ServeGreedyPolicy),
            "serve-flex": (ServeFlexPolicy, ref_policies.ServeFlexPolicy)}


# --- the tier model ----------------------------------------------------------------


@pytest.mark.parametrize("n,seed", [(1 << 14, 0), (1000, 3), (1 << 16, 7)])
def test_error_replicas_match_the_reference(n, seed):
    assert tiers._int8_rms_rel_error(n, seed) == ref_tiers._int8_rms_rel_error(n, seed)
    assert tiers._bf16_rms_rel_error(n, seed) == ref_tiers._bf16_rms_rel_error(n, seed)


@pytest.mark.parametrize("kw", [{}, dict(base_energy_kwh_per_kreq=0.7,
                                         base_capacity_per_server=1800.0,
                                         quality_kappa=3.0)])
def test_tier_table_matches_the_reference(kw):
    got = [dataclasses.asdict(t) for t in tiers.derive_tiers(**kw)]
    assert got == [dataclasses.asdict(t) for t in ref_tiers.derive_tiers(**kw)]
    cfg, ref_cfg = ServingConfig(**TINY), RefServingConfig(**TINY)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert [dataclasses.asdict(t) for t in cfg.tiers()] == \
        [dataclasses.asdict(t) for t in ref_cfg.tiers()]
    assert cfg.tiers() is cfg.tiers()          # cached per config


def test_mix_slo_and_ledger_match_the_reference():
    q = np.array([t.quality for t in tiers.derive_tiers()])
    for target in np.linspace(0.9, 1.01, 57):
        np.testing.assert_array_equal(tiers.mix_for_quality(q, float(target)),
                                      ref_tiers.mix_for_quality(q, float(target)))
    util = np.linspace(0.0, 1.3, 131)
    for knee, gamma in ((0.75, 2.0), (0.5, 1.5)):
        np.testing.assert_array_equal(
            tiers.SloModel(knee, gamma).violation_frac(util),
            ref_tiers.SloModel(knee, gamma).violation_frac(util))
    gen = np.random.default_rng(4)
    ledger, ref_ledger = tiers.CreditLedger(gain=2.0), ref_tiers.CreditLedger(gain=2.0)
    for qual in gen.uniform(0.0, 1.0, 300).tolist():
        assert ledger.update(qual, 0.98) == ref_ledger.update(qual, 0.98)
        assert ledger.spend_headroom() == ref_ledger.spend_headroom()
        assert ledger.repay_headroom() == ref_ledger.repay_headroom()


@pytest.mark.parametrize("kw", [
    dict(hours=WEEK * 2, requests_per_day=1.5e6, seed=3),
    dict(hours=500, requests_per_day=2e5, seed=9, burst_rate=0.05, burst_mult=4.0,
         burst_mean_slots=3.0, diurnal=0.3, weekly=0.2, peak_hour=20),
    dict(hours=48, requests_per_day=1e4, seed=1, burst_rate=0.0),
])
def test_request_traces_match_the_reference(kw):
    np.testing.assert_array_equal(generate_request_demand(**kw),
                                  ref_generate_request_demand(**kw))
    rate_kw = {k: v for k, v in kw.items()
               if k in ("hours", "requests_per_day", "diurnal", "weekly", "peak_hour")}
    np.testing.assert_array_equal(expected_request_rate(**rate_kw),
                                  ref_expected_request_rate(**rate_kw))


# --- the engine --------------------------------------------------------------------


def _cases(policy, ci_kind, hours=WEEK * 2, seed=3):
    """(port, reference) cases of ``tests/test_serving.py::_tiny_case``;
    ``ci_kind`` is "perfect", "noisy" or "outage"."""
    trace = np.random.default_rng(seed).uniform(30.0, 700.0, hours + 24)
    out = []
    for case, svc, cfg, noisy, outage, gen, rate, pol in (
            (ServeCase, CarbonService, ServingConfig, NoisyForecast, CarbonDataOutage,
             generate_request_demand, expected_request_rate, POLICIES[policy][0]),
            (RefServeCase, RefCarbonService, RefServingConfig, RefNoisyForecast,
             RefCarbonDataOutage, ref_generate_request_demand,
             ref_expected_request_rate, POLICIES[policy][1])):
        kw = {}
        if ci_kind == "noisy":
            kw["model"] = noisy(sigma=0.3, seed=5)
        if ci_kind == "outage":
            kw["outage"] = outage(rate=0.08, mean_duration=6.0, seed=2)
        c = cfg(**TINY)
        out.append(case(demand=gen(hours, c.requests_per_day, seed=seed + 1),
                        rate=rate(hours + 24, c.requests_per_day),
                        ci=svc(trace=trace.copy(), **kw), config=c, policy=pol(),
                        t0=0, label=policy))
    return out


def assert_served_same(a, b, ctx=""):
    assert (a.policy, a.carbon_g, a.energy_kwh) == (b.policy, b.carbon_g, b.energy_kwh), ctx
    assert a.to_dict() == b.to_dict(), ctx
    for field in ("balance", "utilization", "quality", "violation_frac", "energy",
                  "carbon"):
        np.testing.assert_array_equal(getattr(a.serving, field),
                                      getattr(b.serving, field), err_msg=f"{ctx}: {field}")
    assert a.violation_rate == b.violation_rate, ctx


@pytest.mark.parametrize("ci_kind", ["perfect", "noisy", "outage"])
@pytest.mark.parametrize("engine", ["vector", "scalar"])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_engine_matches_the_reference(policy, engine, ci_kind):
    case, ref_case = _cases(policy, ci_kind)
    got = simulate_serving(case, engine=engine)
    assert_served_same(got, ref_simulate_serving(ref_case, engine="vector"),
                       f"{policy}/{engine}/{ci_kind}")
    assert sum(got.serving.tier_requests) == pytest.approx(float(case.demand.sum()),
                                                           rel=1e-9)


def test_engine_rejections_match_the_reference():
    class Bad:
        name = "bad"

        def on_window_start(self, w):
            self.n = len(w.tiers)

        def decide(self, t, demand, balance, cum_carbon_g, cum_requests):
            return np.full(self.n, 0.9)

    case, ref_case = _cases("serve-static", "perfect", hours=48)
    msgs = []
    for sim, c in ((simulate_serving, case), (ref_simulate_serving, ref_case)):
        with pytest.raises(ValueError) as bad:
            sim(dataclasses.replace(c, policy=Bad()))
        with pytest.raises(ValueError) as unknown:
            sim(c, engine="jax")
        msgs.append((str(bad.value), str(unknown.value)))
    assert msgs[0] == msgs[1]
    short = []
    for case_cls, svc, cfg, pol in ((ServeCase, CarbonService, ServingConfig,
                                     ServeStaticPolicy),
                                    (RefServeCase, RefCarbonService, RefServingConfig,
                                     ref_policies.ServeStaticPolicy)):
        with pytest.raises(ValueError) as e:
            case_cls(demand=np.ones(10_000), rate=np.ones(10_024),
                     ci=svc(trace=np.full(100, 300.0)), config=cfg(), policy=pol())
        short.append(str(e.value))
    assert short[0] == short[1]


def test_telemetry_is_not_ported():
    """The telemetry argument and field the JAX package takes: accepted, and
    they record the reference's events (this test once pinned their raise;
    ``tests/test_torch_telemetry.py`` holds the streams in full)."""
    import repro.telemetry as rt
    import repro_torch.telemetry as pt

    case, ref = _cases("serve-flex", "outage", hours=96)
    got = []
    for sim, c, pkg in ((simulate_serving, case, pt),
                        (ref_simulate_serving, ref, rt)):
        tel = pkg.Telemetry(recorder=pkg.MemoryRecorder(), run_label="s")
        sim(c, telemetry=tel)
        tel2 = pkg.Telemetry(recorder=pkg.MemoryRecorder(), run_label="s")
        sim(dataclasses.replace(c, telemetry=tel2))
        got.append(([tuple(e) for e in tel.recorder.events],
                    [tuple(e) for e in tel2.recorder.events]))
    assert got[0] == got[1]
    assert got[0][0] == got[0][1]
    assert {e[1] for e in got[0][0]} >= {"forecast-read"}


# --- Scenario, run and Sweep ------------------------------------------------------


def test_golden_serving_sweep_byte_for_byte():
    """``tests/test_golden_sweep.py::golden_serving_sweep`` on the port."""
    sw = Sweep(base=Scenario(serving=ServingConfig(requests_per_day=2e5, servers=12),
                             learn_weeks=1, eval_weeks=1, seed=101),
               seeds=[11, 12], policies=["serve-static", "serve-greedy", "serve-flex"],
               device="cpu")
    res = sw.run()
    assert res.to_json() + "\n" == FIXTURE.read_text()
    assert res.baseline == "serve-static"
    header = res.to_csv().splitlines()[0].split(",")
    assert "serving.violation_rate" in header and "serving.tier_requests" in header


@pytest.mark.parametrize("outage", [False, True], ids=["fresh", "ci_outage"])
def test_run_matches_the_reference(outage):
    kw = dict(learn_weeks=1, eval_weeks=2, seed=7)
    port = Scenario(serving=ServingConfig(**TINY), **kw,
                    ci_outage=CarbonDataOutage(rate=0.05, seed=3) if outage else None)
    ref = RefScenario(serving=RefServingConfig(**TINY), **kw,
                      ci_outage=RefCarbonDataOutage(rate=0.05, seed=3) if outage else None)
    assert port.to_json() == ref.to_json()
    assert Scenario.from_json(port.to_json()) == port
    got, want = run(port, device="cpu"), ref_run(ref)
    assert got.policies == DEFAULT_SERVE_POLICIES == want.policies
    for name in got.policies:
        for a, b in zip(got.weekly[name], want.weekly[name]):
            assert_served_same(a, b, name)
        assert got.savings(name) == want.savings(name)
        assert got.violation_rate(name) == want.violation_rate(name)
        assert got.quality_mean(name) == want.quality_mean(name)
    assert got.metrics() == want.metrics()
    mat = port.materialize()
    assert mat.is_serving and mat.jobs == [] and mat.eval_jobs == []
    assert mat.serving.rate.shape == (port.hours + 24,)


def test_serving_sweep_with_outage_and_forecasts_matches_the_reference():
    def grid(scenario, sweep, cfg, outage, noisy, **kw):
        return sweep(base=scenario(serving=cfg(**TINY), learn_weeks=1, eval_weeks=1,
                                   seed=7, ci_outage=outage(rate=0.06, seed=4)),
                     seeds=[3, 4], policies=["serve-greedy", "serve-flex"],
                     forecasts=[None, noisy(sigma=0.3, seed=5)], **kw)

    got = grid(Scenario, Sweep, ServingConfig, CarbonDataOutage, NoisyForecast,
               device="cpu").run()
    want = grid(RefScenario, RefSweep, RefServingConfig, RefCarbonDataOutage,
                RefNoisyForecast).run()
    assert got.to_json() == want.to_json()
    assert got.to_csv() == want.to_csv()


def _err(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("which", ["dag", "regions", "faults"])
def test_scenario_rejections_match_the_reference(which):
    port = {"dag": dict(dag=DagConfig()), "regions": dict(regions=("california", "ontario")),
            "faults": dict(faults=IidFaults(failure_rate=0.01))}[which]
    ref = {"dag": dict(dag=RefDagConfig()), "regions": dict(regions=("california", "ontario")),
           "faults": dict(faults=RefIidFaults(failure_rate=0.01))}[which]
    assert _err(lambda: Scenario(serving=ServingConfig(**TINY), **port)) == \
        _err(lambda: RefScenario(serving=RefServingConfig(**TINY), **ref))


def test_policy_family_and_fault_axis_rejections_match_the_reference():
    assert _err(lambda: run(Scenario(), ["serve-flex"], device="cpu")) == \
        _err(lambda: ref_run(RefScenario(), ["serve-flex"]))
    assert _err(lambda: run(Scenario(serving=ServingConfig(**TINY)), ["carbon-agnostic"],
                            device="cpu")) == \
        _err(lambda: ref_run(RefScenario(serving=RefServingConfig(**TINY)),
                             ["carbon-agnostic"]))
    assert _err(lambda: Sweep(base=Scenario(serving=ServingConfig(**TINY), learn_weeks=1),
                              policies=DEFAULT_SERVE_POLICIES,
                              faults=[IidFaults(failure_rate=0.01)], device="cpu").run()) == \
        _err(lambda: RefSweep(base=RefScenario(serving=RefServingConfig(**TINY),
                                               learn_weeks=1),
                              policies=DEFAULT_SERVE_POLICIES,
                              faults=[RefIidFaults(failure_rate=0.01)]).run())
    for bad in (dict(requests_per_day=0), dict(servers=0), dict(quality_target=1.5),
                dict(ledger_gain=0.0)):
        assert _err(lambda: ServingConfig(**bad)) == _err(lambda: RefServingConfig(**bad))
    payload = json.loads(Scenario(serving=ServingConfig(**TINY)).to_json())
    assert Scenario.from_dict(payload).serving == ServingConfig(**TINY)
