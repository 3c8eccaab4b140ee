"""The port's MPC knob tuner against the reference's ``scripts/tune_policy.py``.

The reference script is loaded with ``importlib`` (its ``__main__`` is
guarded).  Its ``tune`` runs its cases on the scan engine, which cannot
import on this tree, so the test runs the script's own ``tune`` with every
``SimCase`` on ``repro``'s vector engine (bit-identical to its scan engine
by the reference's contract) and holds the port's ``tune`` on the port's
scan engine to it: the returned gap dict float for float and the printed
lines character for character.
"""
import contextlib
import dataclasses
import importlib.util
import io
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.core import scan_engine
from repro_torch.experiment import tune_policy

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(scope="module")
def reference():
    spec = importlib.util.spec_from_file_location(
        "reference_tune_policy", os.path.join(ROOT, "scripts", "tune_policy.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sim_case = mod.SimCase
    mod.SimCase = lambda **kw: sim_case(**dict(kw, engine="vector"))
    return mod


def _printed(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


@pytest.mark.parametrize("scale", [False, True])
def test_default_grid_matches_reference(scale, reference):
    got = [dataclasses.asdict(c) for c in tune_policy.default_grid(scale)]
    want = [dataclasses.asdict(c) for c in reference.default_grid(scale)]
    assert got == want
    assert len(got) == (54 if scale else 18)
    assert tune_policy.REFS == reference.REFS


@pytest.mark.parametrize("scale", [False, True], ids=["quick", "quick-scale"])
def test_tune_on_the_scan_engine_matches_reference(scale, reference):
    policy = "carbonflex-scale" if scale else "carbonflex-mpc"
    kw = dict(policy=policy, seed=1, scale=scale, capacity=20, learn_weeks=1)
    scan_engine.reset_stats()
    got, got_lines = _printed(lambda: tune_policy.tune(
        grid=tune_policy.quick_grid(), device="cpu", **kw))
    stats = dict(scan_engine.stats)
    ref_grid = [reference.MPCConfig(horizon=h, percentile=p)
                for h in (24, 48) for p in (75.0, 85.0)]
    want, want_lines = _printed(lambda: reference.tune(grid=ref_grid, **kw))
    assert got == want
    assert got_lines == want_lines
    assert list(got)[:3] == list(tune_policy.REFS) and len(got) == 7
    assert got["oracle"] == 0.0
    # the scan engine ran the grid: carbonflex and the oracle delegated
    assert stats["delegated"] == 2 and stats["steps"] > 0
    assert (stats["fill_steps"] > 0) == scale


def test_quick_grid_is_the_reference_scripts():
    assert [(c.horizon, c.percentile) for c in tune_policy.quick_grid()] == \
        [(24, 75.0), (24, 85.0), (48, 75.0), (48, 85.0)]


def test_tune_cli_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.experiment.tune_policy", "--quick",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "[carbonflex-mpc | south-australia seed=1 cap=20]" in out.stdout
    assert "-> best: " in out.stdout


def test_tune_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune_policy.tune(grid=tune_policy.quick_grid(), capacity=20, learn_weeks=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune_policy.main(["--quick"])
