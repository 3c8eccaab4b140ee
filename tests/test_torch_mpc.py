"""The receding-horizon execution phase (``core/mpc.py``) of the port,
against the JAX package.

``MPCConfig`` validates and serializes as the reference does.  The MPC
family — ``carbonflex-mpc``, ``carbonflex-scale`` (with genuinely scaled
cells: ``scale_rho=0.3``) and ``oracle-estimated`` — through
``repro_torch.experiment.run`` on the port's scalar, vector and scan
engines (the scan engine on the CPU, the MPC kinds native) must equal
``repro.experiment.run`` on the vector engine bit for bit, under the
perfect forecast and a noisy one, over two evaluation weeks (so the
driver's warm start runs).  ``MPCConfig(horizon=0)`` builds plain
carbonflex.  ``oracle-estimated`` with ``backend="device"`` on the CPU (the
greedy kernel's plain version) equals ``backend="numpy"``.
"""
import dataclasses

import numpy as np
import pytest

from repro.core.forecast import NoisyForecast as RefNoisyForecast
from repro.core.mpc import MPCConfig as RefMPCConfig
from repro.experiment import Scenario as RefScenario
from repro.experiment import run as ref_run
from repro_torch.core import scan_engine
from repro_torch.core.forecast import NoisyForecast
from repro_torch.core.mpc import (CarbonFlexMPCPolicy, CarbonFlexScalePolicy,
                                  MPCConfig)
from repro_torch.core.policy import CarbonFlexPolicy
from repro_torch.experiment import PolicyContext, Scenario, make_policy, run
from repro_torch.experiment.registry import get_spec

MPC = ("carbonflex-mpc", "carbonflex-scale", "oracle-estimated")
SCENARIO = dict(capacity=8, learn_weeks=1, family="alibaba", seed=101, eval_weeks=2)
FORECASTS = {"perfect": (None, None),
             "noisy": (NoisyForecast(sigma=0.3, seed=5),
                       RefNoisyForecast(sigma=0.3, seed=5))}


def _identical(a, b, ctx):
    assert a.policy == b.policy, ctx
    assert a.carbon_g == b.carbon_g and a.energy_kwh == b.energy_kwh, ctx
    np.testing.assert_array_equal(a.completion, b.completion, err_msg=ctx)
    np.testing.assert_array_equal(a.wait_slots, b.wait_slots, err_msg=ctx)
    np.testing.assert_array_equal(a.violations, b.violations, err_msg=ctx)
    assert [(s.slot, s.ci, s.provisioned, s.used, s.energy_kwh, s.carbon_g,
             s.running, s.queued) for s in a.slots] == \
        [(s.slot, s.ci, s.provisioned, s.used, s.energy_kwh, s.carbon_g,
          s.running, s.queued) for s in b.slots], ctx


@pytest.fixture(scope="module", params=sorted(FORECASTS))
def runs(request):
    port_fc, ref_fc = FORECASTS[request.param]
    ref = ref_run(RefScenario(**SCENARIO, forecast=ref_fc,
                              mpc=RefMPCConfig(scale_rho=0.3)), MPC)
    out = {}
    for engine in ("vector", "scalar", "scan"):
        scan_engine.reset_stats()
        out[engine] = run(Scenario(**SCENARIO, forecast=port_fc, engine=engine,
                                   mpc=MPCConfig(scale_rho=0.3)), MPC, device="cpu")
        out[engine + "_stats"] = dict(scan_engine.stats)
    return request.param, ref, out


@pytest.mark.parametrize("engine", ["vector", "scalar", "scan"])
@pytest.mark.parametrize("policy", MPC)
def test_mpc_family_equals_the_reference(runs, engine, policy):
    label, ref, out = runs
    port = out[engine]
    assert len(port.weekly[policy]) == len(ref.weekly[policy]) == 2
    for w, (a, b) in enumerate(zip(port.weekly[policy], ref.weekly[policy])):
        _identical(a, b, f"{label} {engine} {policy} week {w}")
    assert port.savings(policy) == ref.savings(policy)
    assert port.mean_wait(policy) == ref.mean_wait(policy)
    assert port.violation_rate(policy) == ref.violation_rate(policy)


def test_scan_runs_the_mpc_kinds_natively(runs):
    _, _, out = runs
    stats = out["scan_stats"]
    # two weeks x oracle-estimated delegate; the two MPC kinds run natively,
    # carbonflex-scale through the variable-k fill every step
    assert stats["delegated"] == 2
    assert 0 < stats["fill_steps"] < stats["steps"]


def test_scaled_cells_exist(runs):
    """``scale_rho=0.3`` licenses scale-up on this workload: some slots of
    carbonflex-scale use more servers than carbonflex-mpc's k_min fill
    could."""
    _, _, out = runs
    scaled = out["vector"].weekly["carbonflex-scale"]
    plain = out["vector"].weekly["carbonflex-mpc"]
    assert any(a.energy_kwh != b.energy_kwh for a, b in zip(scaled, plain))


def test_native_kinds():
    assert scan_engine.native_kind(CarbonFlexScalePolicy()) == "mpc-scale"
    assert scan_engine.native_kind(CarbonFlexMPCPolicy()) == "mpc"


@pytest.mark.parametrize("kw", [dict(horizon=-1), dict(replan_every=0),
                                dict(max_done=0), dict(clean_frac=1.5),
                                dict(clean_frac=-0.1)])
def test_config_validation_equals_the_reference(kw):
    with pytest.raises(ValueError) as ref_err:
        RefMPCConfig(**kw)
    with pytest.raises(ValueError) as port_err:
        MPCConfig(**kw)
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("kw", [{}, dict(horizon=24, scale_rho=0.3),
                                dict(percentile=50.0, history_cap=16, clean_frac=0.0)])
def test_config_round_trip_equals_the_reference(kw):
    port, ref = MPCConfig(**kw), RefMPCConfig(**kw)
    assert port.to_dict() == ref.to_dict()
    assert list(port.to_dict()) == list(ref.to_dict())
    assert MPCConfig.from_dict(port.to_dict()) == port


def test_horizon_zero_builds_plain_carbonflex():
    sc = dict(SCENARIO, eval_weeks=1)
    zero = run(Scenario(**sc, mpc=MPCConfig(horizon=0)),
               ["carbonflex", "carbonflex-mpc"], device="cpu")
    (a,), (b,) = zero.weekly["carbonflex"], zero.weekly["carbonflex-mpc"]
    assert b.policy == "carbonflex-mpc"
    _identical(dataclasses.replace(a, policy="carbonflex-mpc"), b, "horizon 0")
    mat = Scenario(**sc, mpc=MPCConfig(horizon=0)).materialize()
    ctx = PolicyContext(cluster=mat.cluster, ci=mat.ci, kb=object(),
                        mpc=MPCConfig(horizon=0))
    assert type(make_policy("carbonflex-mpc", ctx)) is CarbonFlexPolicy
    with pytest.raises(ValueError, match="horizon >= 1"):
        CarbonFlexMPCPolicy(cfg=MPCConfig(horizon=0))


def test_registry_flags_equal_the_reference():
    from repro.experiment.registry import get_spec as ref_get_spec
    for name in MPC:
        port, ref = get_spec(name), ref_get_spec(name)
        assert (port.needs_kb, port.needs_history, port.dag) == \
            (ref.needs_kb, ref.needs_history, ref.dag)


def test_estimated_oracle_device_backend_on_the_cpu_equals_numpy():
    sc = Scenario(**dict(SCENARIO, eval_weeks=1))
    numpy_res = run(sc, ["oracle-estimated"], device="cpu", backend="numpy")
    device_res = run(sc, ["oracle-estimated"], device="cpu", backend="device")
    (a,), (b,) = numpy_res.weekly["oracle-estimated"], device_res.weekly["oracle-estimated"]
    _identical(a, b, "oracle-estimated device vs numpy")
