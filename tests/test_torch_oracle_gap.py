"""The port's oracle-gap harness (``repro_torch/experiment/oracle_gap.py``)
against the JAX package's.

At a tiny base (capacity 8, one learning week) the port's
``OracleGap(engine="vector", device="cpu")`` gives the reference's
``OracleGap(engine="vector")`` rows and JSON byte for byte, gap
attributions included; the port's scan engine (the harness's default)
gives the same bytes; the result round-trips through JSON; ``main()``
prints the reference's report.  The reference's default ``engine="scan"``
cannot run on this tree, so its vector engine is the yardstick.
"""
import sys

import pytest

from repro.core.forecast import QuantileForecast as RefQuantileForecast
from repro.core.forecast import forecast_labels as ref_forecast_labels
from repro.experiment import OracleGap as RefOracleGap
from repro.experiment import Scenario as RefScenario
from repro.experiment import sigma_ladder as ref_sigma_ladder
from repro.experiment.oracle_gap import OracleGapResult as RefOracleGapResult
from repro.experiment.oracle_gap import main as ref_main
from repro_torch.core import scan_engine
from repro_torch.core.forecast import QuantileForecast, forecast_labels
from repro_torch.experiment import (DEFAULT_GAP_POLICIES, OracleGap,
                                    OracleGapResult, Scenario, sigma_ladder)
from repro_torch.experiment import oracle_gap

BASE = dict(capacity=8, learn_weeks=1, family="alibaba", seed=101)

_CACHE: dict = {}


def gaps(engine: str, sigmas=(0.0, 0.2), kind: str = "noisy"):
    """The port's and the reference's harness on the tiny base (the
    reference always on its vector engine), run once per argument set."""
    key = (engine, sigmas, kind)
    if key not in _CACHE:
        scan_engine.reset_stats()
        port = OracleGap(base=Scenario(**BASE), seeds=(11,),
                         forecasts=sigma_ladder(sigmas, kind=kind),
                         engine=engine, device="cpu").run()
        ref = RefOracleGap(base=RefScenario(**BASE), seeds=(11,),
                           forecasts=ref_sigma_ladder(sigmas, kind=kind),
                           engine="vector").run()
        _CACHE[key] = (port, ref, dict(scan_engine.stats))
    return _CACHE[key]


def test_defaults_follow_the_reference():
    og, ref = OracleGap(), RefOracleGap()
    assert DEFAULT_GAP_POLICIES == tuple(og.policies) == tuple(ref.policies)
    assert og.engine == ref.engine == "scan"
    assert (og.baseline, og.backend, og.forecast_quantile, og.include_estimated) == \
        (ref.baseline, ref.backend, ref.forecast_quantile, ref.include_estimated)
    assert og.device == "cuda"
    names = og.sweep().policies
    assert names[-2:] == ("oracle", "oracle-estimated")
    assert tuple(names) == tuple(ref.sweep().policies)
    assert og.sweep().device == "cuda"
    assert OracleGap(device="cpu").sweep().device == "cpu"


@pytest.mark.parametrize("kind", ["noisy", "quantile"])
def test_sigma_ladder_equals_the_reference(kind):
    port = sigma_ladder((0.0, 0.1, 0.4), kind=kind, seed=3)
    ref = ref_sigma_ladder((0.0, 0.1, 0.4), kind=kind, seed=3)
    assert port[0] is None and ref[0] is None
    assert forecast_labels(port) == ref_forecast_labels(ref)
    assert [(m.sigma, m.seed) for m in port[1:]] == [(m.sigma, m.seed) for m in ref[1:]]
    if kind == "quantile":
        assert isinstance(port[1], QuantileForecast)
        assert isinstance(ref[1], RefQuantileForecast)
    with pytest.raises(ValueError, match="kind"):
        sigma_ladder(kind="gaussian")


@pytest.mark.parametrize("engine", ["vector", "scalar", "scan"])
def test_rows_and_json_equal_the_reference(engine):
    port, ref, stats = gaps(engine)
    assert port.rows() == ref.rows()
    assert port.to_json() == ref.to_json()
    assert port.table() == ref.table()
    assert port.forecast_order == ref.forecast_order == ["perfect", "noisy(s=0.2)"]
    rows = port.rows()
    assert len(rows) == 2 * (len(DEFAULT_GAP_POLICIES) + 2)   # + baseline, est.
    assert all("gap_attribution_pp" in r for r in rows
               if r["policy"] != "carbon-agnostic")
    if engine == "scan":
        # the threshold and MPC kinds ran on the slot loop; the oracles and
        # carbonflex delegated on their policy
        assert stats["steps"] > 0
        assert stats["delegated"] > 0 and stats["telemetry_delegated"] == 0


def test_quantile_ladder_equals_the_reference():
    port, ref, _ = gaps("scan", (0.0, 0.3), "quantile")
    assert port.to_json() == ref.to_json()


def test_aggregates_equal_the_reference():
    port, ref, _ = gaps("scan")
    assert port.summary() == ref.summary()
    assert port.policies() == ref.policies()
    for pol in port.policies():
        assert port.degradation_curve(pol) == ref.degradation_curve(pol)
    assert port.perfect_gap("carbonflex") == ref.perfect_gap("carbonflex")
    s = port.summary()["perfect"]["wait-awhile"]
    assert "gap_attribution_mean_pp" in s and "est_gap_mean_pp" in s
    for r in port.rows():
        att = r.get("gap_attribution_pp")
        if att:
            assert abs(sum(att.values()) - r["gap_pp"]) < 0.02   # rounding only


def test_from_json_round_trips():
    port, ref, _ = gaps("scan")
    back = OracleGapResult.from_json(port.to_json())
    assert back.to_json() == port.to_json()
    assert back.rows() == port.rows() and back.baseline == port.baseline
    assert back.summary() == port.summary()
    assert RefOracleGapResult.from_json(port.to_json()).to_json() == port.to_json()
    assert OracleGapResult.from_json(ref.to_json()).table() == ref.table()


def test_main_prints_the_reference_report(monkeypatch, capsys, tmp_path):
    """``python -m repro_torch.experiment.oracle_gap --smoke`` on the CPU
    against the reference's CLI on its vector engine: the same lines, the
    same JSON file."""
    out, rout = tmp_path / "port.json", tmp_path / "ref.json"
    monkeypatch.setattr(sys, "argv", ["oracle_gap", "--smoke", "--device", "cpu",
                                      "--out", str(out)])
    oracle_gap.main()
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["oracle_gap", "--smoke", "--engine", "vector",
                                      "--out", str(rout)])
    ref_main()
    want = capsys.readouterr().out
    drop = ("wrote ",)
    assert [ln for ln in got.splitlines() if not ln.startswith(drop)] == \
        [ln for ln in want.splitlines() if not ln.startswith(drop)]
    assert out.read_text() == rout.read_text()
    assert "gap attribution[carbonflex-mpc]" in got
