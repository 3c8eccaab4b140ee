"""The port's LM serving slice against the JAX package's, on the CPU.

Both packages run the same reduced configs (``configs.reduced``) on the
same weights: the reference's ``init_params`` draws them, and
``params_from_reference`` carries them across as numpy arrays.  Logits
agree within rtol = atol = 1e-4 in fp32 under both attention backends
(the port's "flash" against the reference's "pallas", "chunked" against
"xla"), and greedy decoding picks the same tokens.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.launch.mesh import make_mesh
from repro.models import LogicalRules
from repro.models import api as japi
from repro.models import common as jcommon
from repro.models import transformer as jtransformer
from repro.serve import make_prefill as jmake_prefill
from repro.serve import make_serve_step as jmake_serve_step
from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import api, common
from repro_torch.serve import init_cache, make_prefill, make_serve_step

ARCHS = ["llama3-8b", "stablelm-1.6b", "minicpm-2b", "qwen3-moe-235b-a22b", "dbrx-132b"]
BACKENDS = [("flash", "pallas"), ("chunked", "xla")]
TOL = 1e-4
B, P, MAX, STEPS = 2, 10, 16, 4


@pytest.fixture(scope="module")
def rules():
    return LogicalRules(make_mesh((1, 1), ("data", "model")))


def _pair(arch, backend=("flash", "pallas")):
    cfg = dataclasses.replace(configs.reduced(configs.ARCHS[arch]),
                              attention_backend=backend[0])
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.ARCHS[arch]),
                               attention_backend=backend[1])
    return cfg, jcfg


_WEIGHTS = {}


def _weights(arch):
    """The reference's weights of the reduced arch, and the port's copy."""
    if arch not in _WEIGHTS:
        cfg, jcfg = _pair(arch)
        jparams = japi.init_params(jcfg, jax.random.key(0))
        tree = jax.tree.map(np.asarray, jparams)
        _WEIGHTS[arch] = (jparams, api.params_from_reference(cfg, tree, device="cpu"))
    return _WEIGHTS[arch]


def _tokens(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n))


@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: b[0])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch, backend, rules):
    cfg, jcfg = _pair(arch, backend)
    jparams, params = _weights(arch)
    toks = _tokens(cfg, P)
    want = japi.forward(jparams, jnp.asarray(toks, jnp.int32), jcfg, rules)
    fa.reset_launches()
    got = api.forward(params, torch.from_numpy(toks), cfg)
    assert fa.launches["gqa_flash"] == 0            # CPU: the plain version
    assert got.shape == (B, P, cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: b[0])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match_reference(arch, backend, rules):
    cfg, jcfg = _pair(arch, backend)
    jparams, params = _weights(arch)
    toks = _tokens(cfg, P, seed=1)
    jlogits, jcache = jax.jit(jmake_prefill(jcfg, rules, MAX))(
        jparams, jnp.asarray(toks, jnp.int32))
    jstep = jax.jit(jmake_serve_step(jcfg, rules))
    logits, cache = make_prefill(cfg, MAX)(params, torch.from_numpy(toks))
    step = make_serve_step(cfg)
    assert cache["length"] == int(jcache["length"]) == P
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=TOL, atol=TOL)
    for _ in range(STEPS):
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=TOL, atol=TOL)
        tok = torch.argmax(logits, dim=-1)
        jtok = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        logits, cache = step(params, cache, tok)
        jlogits, jcache = jstep(jparams, jcache, jtok)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=TOL, atol=TOL)
    assert cache["length"] == int(jcache["length"]) == P + STEPS


@pytest.mark.parametrize("arch", ["llama3-8b", "minicpm-2b", "qwen3-moe-235b-a22b"])
def test_prefill_then_decode_matches_pure_decode(arch):
    """As the reference's tests/test_serve.py: a prefilled cache and one
    built token by token give the same logits (MoE at capacity factor 8,
    where neither path drops a token)."""
    cfg, _ = _pair(arch)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    params = api.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, P + 4))
    step = make_serve_step(cfg)
    logits, cache = make_prefill(cfg, MAX)(params, toks[:, :P])
    for t in range(P, P + 4):
        logits, cache = step(params, cache, toks[:, t])
    cache_b = init_cache(cfg, B, MAX, device="cpu")
    for t in range(P + 4):
        logits_b, cache_b = step(params, cache_b, toks[:, t])
    np.testing.assert_allclose(logits.numpy(), logits_b.numpy(), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_configs_and_param_counts_match_reference(arch):
    cfg, jcfg = configs.ARCHS[arch], jconfigs.ARCHS[arch]
    plain = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
             if not f.name.endswith("dtype") and f.name != "attention_backend"}
    jplain = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
              if not f.name.endswith("dtype") and f.name != "attention_backend"}
    assert plain == jplain
    for name in ("param_dtype", "compute_dtype", "moment_dtype"):
        assert str(getattr(cfg, name)).split(".")[-1] == \
            jnp.dtype(getattr(jcfg, name)).name
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert (cfg.resolved_head_dim, cfg.q_per_kv) == (jcfg.resolved_head_dim,
                                                      jcfg.q_per_kv)
    assert api.param_count(cfg) == japi.param_count(jcfg)
    red, jred = configs.reduced(cfg), jconfigs.reduced(jcfg)
    assert (red.num_layers, red.d_model, red.num_heads, red.num_kv_heads,
            red.vocab_size, red.attention_chunk) == \
        (jred.num_layers, jred.d_model, jred.num_heads, jred.num_kv_heads,
         jred.vocab_size, jred.attention_chunk)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_and_init_rules(arch):
    cfg, jcfg = _pair(arch)
    _, params = _weights(arch)
    shapes = jtransformer.param_shapes(jcfg)
    flat = dict(api._walk_flat(params))
    assert {p: tuple(t.shape) for p, t in flat.items()} == \
        {p: tuple(s) for p, s in api._walk_flat(shapes)}
    assert all(t.dtype == torch.float32 for t in flat.values())
    init = dict(api._walk_flat(api.init_params(cfg, seed=3, device="cpu")))
    assert {p: t.shape for p, t in init.items()} == {p: t.shape for p, t in flat.items()}
    for path, t in init.items():
        if path[-1].startswith("ln"):
            assert torch.equal(t, torch.ones_like(t))
        else:       # dense_init: std 1/sqrt(shape[max(ndim - 2, 0)])
            fan_in = t.shape[max(t.dim() - 2, 0)]
            assert abs(t.std().item() * np.sqrt(fan_in) - 1) < 0.1, path
    # storage dtypes at full width: matrices in compute dtype, norms in param dtype
    full = configs.ARCHS[arch]
    assert api._storage_dtype(full, "wq") == torch.bfloat16
    assert api._storage_dtype(full, "ln1") == (torch.bfloat16 if full.num_experts
                                               else torch.float32)


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 4, 32)).astype(np.float32)
    scale = rng.normal(size=(32,)).astype(np.float32)
    pos = np.arange(7)
    np.testing.assert_allclose(
        common.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5).numpy(),
        np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        common.rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0).numpy(),
        np.asarray(jcommon.rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)),
        rtol=1e-5, atol=1e-5)


def test_serve_cli_runs_reduced_on_cpu():
    root = os.path.join(os.path.dirname(__file__), "..")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(os.path.join(root, "src")))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve", "--reduced", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=root)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "prefill" in out.stdout and "tok/s" in out.stdout


def test_serve_cli_runs_moe_reduced_on_cpu():
    root = os.path.join(os.path.dirname(__file__), "..")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(os.path.join(root, "src")))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve", "--arch", "qwen3-moe-235b-a22b",
         "--reduced", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=root)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "arch qwen3-moe-235b-a22b-smoke" in out.stdout and "tok/s" in out.stdout


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = configs.reduced(configs.ARCHS["llama3-8b"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, 1, 8)
    from repro_torch.serve.__main__ import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--reduced"])
