"""The port's eight batch examples (``repro_torch.examples``) against the
JAX package's ``examples/``, on the CPU.

Each reference example is run from its file (``runpy``, ``sys.argv`` set,
stdout captured) at its CI settings (``--tiny``; ``cluster_sim_year`` at
``--weeks 1 --capacity 10``), with the reference's ``run`` and
``Sweep.run`` wrapped to keep what they return; the port's example runs as
``main([..., "--device", "cpu"])``.  Held:

- the printed text, character for character.  The one exception is
  telemetry's phase table (wall seconds and their shares), whose lines are
  dropped on both sides;
- the returned studies: ``table()`` and ``metrics()`` of a ``run()``,
  ``to_json()`` of a sweep (byte for byte), telemetry's attributions
  field for field, dag's stretch figures.

``forecast_quickstart``: the reference example fails on this tree (its
``OracleGap`` defaults to ``engine="scan"``, which reaches the ``enable_x64``
import that jax 0.9 removed).  So the test runs the reference example with
``OracleGap`` defaulting to ``engine="vector"``, and the port's example on
its own default ``engine="scan"`` (the slot loop's CPU path), and holds the
two as above.
"""
import contextlib
import dataclasses
import io
import os
import re
import runpy
import sys
from unittest import mock

import pytest
import torch

import repro.experiment as ref_experiment
from repro.experiment import sweep as ref_sweep
from repro_torch.examples import (cluster_sim_year, dag_quickstart, forecast_quickstart,
                                  geo_quickstart, quickstart, resilience_quickstart,
                                  serving_quickstart, telemetry_quickstart)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples")
TINY = ["--tiny"]
ARGS = {"quickstart": TINY, "dag_quickstart": TINY, "geo_quickstart": TINY,
        "forecast_quickstart": TINY, "resilience_quickstart": TINY,
        "serving_quickstart": TINY, "telemetry_quickstart": TINY,
        "cluster_sim_year": ["--weeks", "1", "--capacity", "10"]}
PORT = {"quickstart": quickstart, "dag_quickstart": dag_quickstart,
        "geo_quickstart": geo_quickstart, "forecast_quickstart": forecast_quickstart,
        "resilience_quickstart": resilience_quickstart,
        "serving_quickstart": serving_quickstart,
        "telemetry_quickstart": telemetry_quickstart, "cluster_sim_year": cluster_sim_year}
# telemetry's phase table: a phase, its wall seconds, share and brackets
PHASE_LINE = re.compile(r"^\s+(learn|provision|decide|execute)\s+[\d.]+\s+[\d.]+%")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@dataclasses.dataclass
class _VectorGap(ref_experiment.OracleGap):
    """The reference's study on its vector engine, which runs on this tree."""
    engine: str = "vector"


def _run_reference(name: str):
    """The reference example's stdout and the studies its ``run`` and
    ``Sweep.run`` calls returned, in call order."""
    got = []

    def keep(fn):
        def wrapper(*a, **kw):
            out = fn(*a, **kw)
            got.append(out)
            return out
        return wrapper

    patches = [mock.patch.object(ref_experiment, "run", keep(ref_experiment.run)),
               mock.patch.object(ref_sweep.Sweep, "run", keep(ref_sweep.Sweep.run)),
               mock.patch.object(ref_experiment, "OracleGap", _VectorGap)]
    out = io.StringIO()
    argv = sys.argv
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        stack.enter_context(contextlib.redirect_stdout(out))
        sys.argv = [name + ".py"] + ARGS[name]
        try:
            runpy.run_path(os.path.join(EXAMPLES, name + ".py"), run_name="__main__")
        finally:
            sys.argv = argv
    return out.getvalue(), got


def _run_port(name: str):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = PORT[name].main(ARGS[name] + ["--device", "cpu"])
    return out.getvalue(), res


_CACHE = {}


def _pair(name):
    if name not in _CACHE:
        _CACHE[name] = _run_reference(name), _run_port(name)
    return _CACHE[name]


def _lines(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if not PHASE_LINE.match(ln)]


@pytest.mark.parametrize("name", sorted(ARGS))
def test_printed_text_matches_reference(name):
    (ref_text, _), (port_text, _) = _pair(name)
    assert ref_text.strip(), name
    assert _lines(port_text) == _lines(ref_text)
    if name == "telemetry_quickstart":          # the phase table is there, dropped
        assert len(port_text.splitlines()) - len(_lines(port_text)) == 4


@pytest.mark.parametrize("name", ["quickstart", "cluster_sim_year", "serving_quickstart"])
def test_run_studies_match_reference(name):
    (_, (ref,)), (_, port) = _pair(name)
    assert port.table() == ref.table()
    assert port.metrics() == ref.metrics()
    assert port.kb_size == ref.kb_size
    if name == "serving_quickstart":
        assert [port.quality_mean(p) for p in port.policies] == \
            [ref.quality_mean(p) for p in ref.policies]


def test_quickstart_has_the_five_policies():
    (_, (ref,)), (_, port) = _pair("quickstart")
    assert list(port.policies) == list(ref.policies) == [
        "carbon-agnostic", "wait-awhile", "carbonflex", "carbonflex-mpc", "oracle"]
    assert port.savings("carbonflex-mpc") == ref.savings("carbonflex-mpc") > 0


@pytest.mark.parametrize("name,key", [("dag_quickstart", "sweep"), ("dag_quickstart", "twin"),
                                      ("geo_quickstart", None),
                                      ("resilience_quickstart", "faults"),
                                      ("resilience_quickstart", "outage"),
                                      ("telemetry_quickstart", "sweep")])
def test_sweep_studies_match_reference(name, key):
    (_, refs), (_, port) = _pair(name)
    order = {"sweep": 0, "twin": 1, "faults": 0, "outage": 1, None: 0}
    ref = refs[order[key]]
    got = port if key is None else port[key]
    assert got.to_json() == ref.to_json()
    assert got.table() == ref.table()


def test_dag_stretch_matches_reference():
    """The per-pipeline stretch, recomputed from the reference's own
    ``pipeline_stretch`` on the reference's simulation of each policy."""
    from repro.core import simulate
    from repro.experiment import DEFAULT_DAG_POLICIES, Scenario, make_policy, prepare_context
    from repro.traces import DagConfig

    ref_mod = runpy.run_path(os.path.join(EXAMPLES, "dag_quickstart.py"))
    _, (_, port) = _pair("dag_quickstart")
    mat = Scenario(dag=DagConfig(width=4, depth=3), capacity=12, learn_weeks=1,
                   seed=1).materialize()
    ctx = prepare_context(mat, DEFAULT_DAG_POLICIES)
    for name in DEFAULT_DAG_POLICIES:
        res = simulate(mat.eval_jobs, mat.ci, mat.cluster, make_policy(name, ctx),
                       t0=mat.t0, horizon=24 * 7)
        assert port["stretch"][name] == ref_mod["pipeline_stretch"](res, mat.eval_jobs)


def test_telemetry_attributions_match_reference():
    (_, (ref,)), (_, port) = _pair("telemetry_quickstart")
    got = port["sweep"].attributions()
    want = ref.attributions()
    assert [a.table() for a in got] == [a.table() for a in want]
    for a, b in zip(got, want):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert port["label"] == "south-australia/s7/none/carbonflex"
    assert port["telemetry"].recorder.counts(run=port["label"])["admit"] > 0


def test_forecast_study_matches_reference_on_the_vector_engine():
    """The port's study on its scan engine against the reference's study on
    its vector engine (``OracleGap(..., engine="vector")``)."""
    (_, (ref_sweep_res,)), (_, port) = _pair("forecast_quickstart")
    assert port.table()
    assert port.to_json() == _reference_gap().to_json()
    for pol in ("carbonflex", "carbonflex-robust"):
        assert port.degradation_curve(pol) == _reference_gap().degradation_curve(pol)
    assert ref_sweep_res.rows()          # the reference's sweep ran on its vector engine


_GAP = []


def _reference_gap():
    if not _GAP:
        from repro.experiment import Scenario, sigma_ladder

        base = Scenario(capacity=8, learn_weeks=1, family="alibaba", seed=11)
        _GAP.append(ref_experiment.OracleGap(base=base, seeds=[11],
                                             forecasts=sigma_ladder([0.0, 0.2]),
                                             engine="vector").run())
    return _GAP[0]


@pytest.mark.parametrize("name", sorted(ARGS))
def test_example_raises_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        PORT[name].main(ARGS[name])
