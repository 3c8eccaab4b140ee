"""Import hygiene of the PyTorch port: importing ``repro_torch`` and every
submodule loads neither JAX nor anything of the JAX package ``repro``."""
import os
import subprocess
import sys

_SCRIPT = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.startswith("jax") or m == "repro" or m.startswith("repro."))
print(len(names), ",".join(bad))
"""


def test_repro_torch_imports_neither_jax_nor_repro():
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    out = subprocess.run([sys.executable, "-c", _SCRIPT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1) if " " in out.stdout.strip() \
        else (out.stdout.strip(), "")
    assert int(count) >= 20, out.stdout
    assert bad == "", f"repro_torch loaded {bad}"


_DRYRUN_SCRIPT = r"""
import sys
import repro_torch.launch.dryrun, repro_torch.launch.op_analysis, repro_torch.launch.mesh
import repro_torch.core.profiles, repro_torch.traces.workloads
bad = sorted(m for m in sys.modules
             if m.startswith("jax") or m == "repro" or m.startswith("repro."))
print(",".join(bad), "XLA_FLAGS" in __import__("os").environ)
"""


def test_dryrun_modules_import_neither_jax_nor_repro():
    """The dry-run, its op counter and mesh, the roofline profiles and the
    "tpu" trace branch: no JAX, no ``repro``, no XLA flag set at import."""
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _DRYRUN_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False"], out.stdout
