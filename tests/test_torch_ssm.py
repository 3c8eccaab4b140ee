"""The port's rwkv6 and zamba2 families and their chunked linear recurrence
against the JAX package's, on the CPU.

Inputs come from numpy seeds and go through both packages; weights are the
reference's ``init_params`` carried across by ``params_from_reference``.
Tolerances:

- the recurrence engine: rtol 1e-4, atol 1e-5, the reference's own
  (``tests/test_models.py``): fp32 sums of products with exp(+-cum)
  factors, taken in another order;
- the blocks, forward and serving of both families: rtol 1e-4 and an atol
  of 1e-4 times the reference output's largest magnitude where that
  exceeds 1, in fp32.  Under the reference init the blocks' outputs reach
  ~5e3 (rwkv6's time mix on unit inputs) and ~46 (zamba2's shared block),
  and fp32 products added in another order by XLA and by torch differ by
  ~1e-6 of that (7.6e-3 at 5.1e3; 1.3e-4 at 46), most where an output
  element is small beside its row;
- serving properties of the port alone (decode against the forward's last
  position, prefill-then-decode against pure decode): 2e-3, the
  reference's (``tests/test_models.py``, ``tests/test_serve.py``).
Greedy tokens are equal.
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
from repro.models import rwkv6 as jrwkv6
from repro.models import ssm as jssm
from repro.models import zamba2 as jzamba2
from repro.serve import init_cache as jinit_cache
from repro.serve import make_prefill as jmake_prefill
from repro.serve import make_serve_step as jmake_serve_step
from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import api, common, rwkv6, ssm, zamba2
from repro_torch.serve import init_cache, make_prefill, make_serve_step

ARCHS = ["rwkv6-7b", "zamba2-7b"]
BACKENDS = [("flash", "pallas"), ("chunked", "xla")]
RTOL, ATOL = 1e-4, 1e-5          # the recurrence engine
TOL = 1e-4                       # the blocks, forward and serving
PROP_TOL = 2e-3                  # the port's serving properties
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


def _close(got, want, tol):
    """Elementwise within rtol ``tol`` and an atol of ``tol`` times the
    reference's largest magnitude where that exceeds 1."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _engine_close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _layer(tree, li):
    return {k: v[li] for k, v in tree.items()}


# --- the chunked linear recurrence --------------------------------------------

def _recurrence_inputs(s, rwkv, state, seed, b=2, h=2, dk=4, dv=4):
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(size=(b, s, h, dk)).astype(np.float32) * 0.5 for _ in range(2))
    v = rng.normal(size=(b, s, h, dv)).astype(np.float32) * 0.5
    logw = -rng.uniform(0.01, 1.5, (b, s, h, dk if rwkv else 1)).astype(np.float32)
    u = rng.normal(size=(h, dk)).astype(np.float32) * 0.5 if rwkv else None
    s0 = rng.normal(size=(b, h, dk, dv)).astype(np.float32) if state else None
    return q, k, v, logw, u, s0


@pytest.mark.parametrize("state", [False, True], ids=["zero-state", "initial-state"])
@pytest.mark.parametrize("rwkv", [True, False], ids=["rwkv6", "ssd"])
@pytest.mark.parametrize("s,chunk", [(1, 8), (13, 4), (40, 16), (64, 16)])
def test_chunked_linear_attention_matches_reference(s, chunk, rwkv, state):
    """Both branches, S a multiple of the chunk or not, from a zero or a
    given state: the port against the reference's function and the
    sequential oracle, outputs and final states."""
    q, k, v, logw, u, s0 = _recurrence_inputs(s, rwkv, state, seed=s + chunk)
    tu = None if u is None else _t(u)
    ts0 = None if s0 is None else _t(s0)
    y, st = ssm.chunked_linear_attention(_t(q), _t(k), _t(v), _t(logw), u=tu, chunk=chunk,
                                         initial_state=ts0, return_state=True)
    jy, jst = jssm.chunked_linear_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(logw),
        u=None if u is None else jnp.asarray(u), chunk=chunk,
        initial_state=None if s0 is None else jnp.asarray(s0), return_state=True)
    assert y.shape == (2, s, 2, 4) and y.dtype == torch.float32
    _engine_close(y, jy)
    _engine_close(st, jst)
    ry, rst = ssm.reference_scan(_t(q), _t(k), _t(v), _t(logw), u=tu, initial_state=ts0)
    _engine_close(y, ry)
    _engine_close(st, rst)
    # without return_state: the same outputs
    y2 = ssm.chunked_linear_attention(_t(q), _t(k), _t(v), _t(logw), u=tu, chunk=chunk,
                                      initial_state=ts0)
    assert torch.equal(y, y2)


@pytest.mark.parametrize("rwkv", [True, False], ids=["rwkv6", "ssd"])
def test_recurrence_step_and_scan_match_reference(rwkv):
    q, k, v, logw, u, s0 = _recurrence_inputs(9, rwkv, True, seed=3)
    tu = None if u is None else _t(u)
    ju = None if u is None else jnp.asarray(u)
    y, st = ssm.recurrence_step(_t(q[:, 0]), _t(k[:, 0]), _t(v[:, 0]), _t(logw[:, 0]),
                                _t(s0), u=tu)
    jy, jst = jssm.recurrence_step(jnp.asarray(q[:, 0]), jnp.asarray(k[:, 0]),
                                   jnp.asarray(v[:, 0]), jnp.asarray(logw[:, 0]),
                                   jnp.asarray(s0), u=ju)
    _engine_close(y, jy)
    _engine_close(st, jst)
    y, st = ssm.reference_scan(_t(q), _t(k), _t(v), _t(logw), u=tu, initial_state=_t(s0))
    jy, jst = jssm.reference_scan(*(jnp.asarray(a) for a in (q, k, v, logw)), u=ju,
                                  initial_state=jnp.asarray(s0))
    _engine_close(y, jy)
    _engine_close(st, jst)


@pytest.mark.parametrize("rwkv", [True, False], ids=["rwkv6", "ssd"])
def test_chunk_decay_overflow_is_reproduced(rwkv):
    """A chunk whose cumulative decay passes fp32's exp limit (here 90 in one
    channel of one row and head): k * exp(-cum) overflows to inf in the
    reference's chunked form, and the port gives non-finite outputs at the
    same places, the rest equal; the sequential oracle stays finite.  Full
    width rwkv6 under the reference init reaches such chunks (PERF.md)."""
    rng = np.random.default_rng(0)
    b, s, h, dk, dv = 2, 16, 2, 3, 2
    q, k = (rng.normal(size=(b, s, h, dk)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(b, s, h, dv)).astype(np.float32)
    logw = np.full((b, s, h, dk), -0.1, np.float32)
    logw[0, 8:11, 1, 2] = -30.0
    u = rng.normal(size=(h, dk)).astype(np.float32) if rwkv else None
    tu = None if u is None else _t(u)
    y, st = ssm.chunked_linear_attention(_t(q), _t(k), _t(v), _t(logw), u=tu, chunk=16,
                                         return_state=True)
    jy, jst = jssm.chunked_linear_attention(
        *(jnp.asarray(a) for a in (q, k, v, logw)), u=None if u is None else jnp.asarray(u),
        chunk=16, return_state=True)
    jy = np.asarray(jy)
    finite = np.isfinite(jy)
    # only row 0, head 1, from the overflowing positions on
    assert not finite[0, 10:, 1].all()
    assert finite[1].all() and finite[0, :, 0].all() and finite[0, :10].all()
    np.testing.assert_array_equal(torch.isfinite(y).numpy(), finite)
    _engine_close(y.numpy()[finite], jy[finite])
    _engine_close(st, jst)
    ry, _ = ssm.reference_scan(_t(q), _t(k), _t(v), _t(logw), u=tu)
    assert torch.isfinite(ry).all()


def test_chunked_keeps_the_input_dtype_and_runs_fp32_inside():
    q, k, v, logw, u, _ = _recurrence_inputs(20, True, False, seed=5)
    args = [_t(a).to(torch.bfloat16) for a in (q, k, v)] + [_t(logw)]
    y, st = ssm.chunked_linear_attention(*args, u=_t(u), chunk=8, return_state=True)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    want, _ = ssm.chunked_linear_attention(*(a.float() for a in args), u=_t(u), chunk=8,
                                           return_state=True)
    assert torch.equal(y, want.to(torch.bfloat16))


# --- rwkv6 ----------------------------------------------------------------------

def _x(cfg, s=P, seed=0):
    return np.random.default_rng(seed).normal(size=(B, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("carry", [False, True], ids=["fresh", "carried"])
def test_rwkv6_time_mix_matches_reference(carry, rules):
    cfg, jcfg = _pair("rwkv6-7b")
    jparams, params = _weights("rwkv6-7b")
    x = _x(cfg, s=19)
    rng = np.random.default_rng(7)
    kw, jkw = {}, {}
    if carry:
        state = rng.normal(size=(B, rwkv6.num_heads(cfg), 64, 64)).astype(np.float32)
        prev = rng.normal(size=(B, cfg.d_model)).astype(np.float32)
        kw = dict(state=_t(state), prev_tok=_t(prev), return_state=True)
        jkw = dict(state=jnp.asarray(state), prev_tok=jnp.asarray(prev), return_state=True)
    for li in range(cfg.num_layers):
        got = rwkv6.time_mix(_t(x), common.layer(params["layers"], li), cfg, **kw)
        want = jrwkv6.time_mix(jnp.asarray(x), _layer(jparams["layers"], li), jcfg, rules,
                               **jkw)
        if carry:
            _close(got[0], want[0], TOL)
            _close(got[1], want[1], TOL)
        else:
            _close(got, want, TOL)


def test_rwkv6_channel_mix_and_shift_match_reference():
    cfg, jcfg = _pair("rwkv6-7b")
    jparams, params = _weights("rwkv6-7b")
    x = _x(cfg, s=7, seed=2)
    prev = np.random.default_rng(3).normal(size=(B, cfg.d_model)).astype(np.float32)
    for li in range(cfg.num_layers):
        lp, jlp = common.layer(params["layers"], li), _layer(jparams["layers"], li)
        _close(rwkv6.channel_mix(_t(x), lp, cfg),
               jrwkv6.channel_mix(jnp.asarray(x), jlp, jcfg), TOL)
        _close(rwkv6.channel_mix(_t(x), lp, cfg, prev_tok=_t(prev)),
               jrwkv6.channel_mix(jnp.asarray(x), jlp, jcfg, prev_tok=jnp.asarray(prev)), TOL)
    for p in (None, prev):
        np.testing.assert_array_equal(
            rwkv6._shift(_t(x), None if p is None else _t(p)).numpy(),
            np.asarray(jrwkv6._shift(jnp.asarray(x), None if p is None else jnp.asarray(p))))


# --- zamba2 ---------------------------------------------------------------------

def test_zamba2_causal_conv_with_carry_matches_reference():
    cfg, _ = _pair("zamba2-7b")
    di, _, _ = zamba2.dims(cfg)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, 9, di)).astype(np.float32)
    w = rng.normal(size=(zamba2.CONV_WIDTH, di)).astype(np.float32)
    carry = rng.normal(size=(B, zamba2.CONV_WIDTH - 1, di)).astype(np.float32)
    for c in (None, carry):
        got, got_c = zamba2._causal_conv(_t(x), _t(w), None if c is None else _t(c))
        want, want_c = jzamba2._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                            None if c is None else jnp.asarray(c))
        _close(got, want, 1e-6)
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    # one token at a time with the carry equals the whole sequence
    c, outs = None, []
    for t in range(x.shape[1]):
        o, c = zamba2._causal_conv(_t(x[:, t:t + 1]), _t(w), c)
        outs.append(o)
    _close(torch.cat(outs, dim=1), zamba2._causal_conv(_t(x), _t(w))[0].numpy(), 1e-6)


@pytest.mark.parametrize("carry", [False, True], ids=["fresh", "carried"])
def test_zamba2_mamba_block_matches_reference(carry, rules):
    cfg, jcfg = _pair("zamba2-7b")
    jparams, params = _weights("zamba2-7b")
    di, H, N = zamba2.dims(cfg)
    x = _x(cfg, s=21, seed=5)
    rng = np.random.default_rng(8)
    kw, jkw = {}, {}
    if carry:
        state = rng.normal(size=(B, H, N, zamba2.MAMBA_HEAD)).astype(np.float32)
        conv = rng.normal(size=(B, zamba2.CONV_WIDTH - 1, di)).astype(np.float32)
        kw = dict(state=_t(state), conv_carry=_t(conv), return_state=True)
        jkw = dict(state=jnp.asarray(state), conv_carry=jnp.asarray(conv),
                   return_state=True)
    for li in range(cfg.num_layers):
        got = zamba2.mamba_block(_t(x), common.layer(params["layers"], li), cfg, **kw)
        want = jzamba2.mamba_block(jnp.asarray(x), _layer(jparams["layers"], li), jcfg,
                                   rules, **jkw)
        for g, w in zip(got, want) if carry else [(got, want)]:
            _close(g, w, TOL)


@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: b[0])
def test_zamba2_shared_block_matches_reference(backend, rules):
    cfg, jcfg = _pair("zamba2-7b", backend)
    jparams, params = _weights("zamba2-7b")
    x = _x(cfg, s=12, seed=6)
    pos = np.arange(12)
    fa.reset_launches()
    got = zamba2.shared_block(_t(x), params["shared"], cfg, _t(pos))
    assert fa.launches["gqa_flash"] == 0            # CPU: the plain version
    want = jzamba2.shared_block(jnp.asarray(x), jparams["shared"], jcfg, rules,
                                jnp.asarray(pos))
    _close(got, want, TOL)


@pytest.mark.parametrize("L,period,G,R", [(7, 3, 2, 1), (81, 6, 13, 3), (6, 6, 1, 0),
                                          (2, 3, 0, 2)])
def test_zamba2_split_groups(L, period, G, R):
    layers = {"a": torch.arange(L * 2).view(L, 2)}
    grouped, rest, g, r = zamba2._split_groups(layers, L, period)
    assert (g, r) == (G, R)
    jg, jr, _, _ = jzamba2._split_groups({"a": jnp.arange(L * 2).reshape(L, 2)}, L, period)
    if G:
        np.testing.assert_array_equal(grouped["a"].numpy(), np.asarray(jg["a"]))
    else:
        assert grouped is None and jg is None
    if R:
        np.testing.assert_array_equal(rest["a"].numpy(), np.asarray(jr["a"]))
    else:
        assert rest is None and jr is None


# --- both families: forward and serving -----------------------------------------

@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: b[0])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch, backend, rules):
    cfg, jcfg = _pair(arch, backend)
    jparams, params = _weights(arch)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, 20))
    want = japi.forward(jparams, jnp.asarray(toks, jnp.int32), jcfg, rules)
    fa.reset_launches()
    got = api.forward(params, torch.from_numpy(toks), cfg)
    assert fa.launches["gqa_flash"] == 0
    assert got.shape == (B, 20, cfg.vocab_size) and got.dtype == torch.float32
    _close(got, want, TOL)
    hidden, head = api.forward(params, torch.from_numpy(toks), cfg, return_hidden=True)
    assert torch.equal(hidden @ head, got)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch):
    cfg, jcfg = _pair(arch)
    cache = init_cache(cfg, 3, 11, device="cpu")
    jcache = jinit_cache(jcfg, 3, 11)
    assert set(cache) == set(jcache)
    for name, want in jcache.items():
        got = cache[name]
        if name == "length":
            assert got == int(want) == 0
            continue
        assert tuple(got.shape) == want.shape, name
        assert str(got.dtype).split(".")[-1] == jnp.dtype(want.dtype).name, name
        assert not got.any()


@pytest.mark.parametrize("backend", BACKENDS, ids=lambda b: b[0])
@pytest.mark.parametrize("arch", ARCHS)
def test_replay_prefill_and_greedy_decode_match_reference(arch, backend, rules):
    cfg, jcfg = _pair(arch, backend)
    jparams, params = _weights(arch)
    tol = TOL
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, P))
    jlogits, jcache = jax.jit(jmake_prefill(jcfg, rules, MAX))(
        jparams, jnp.asarray(toks, jnp.int32))
    jstep = jax.jit(jmake_serve_step(jcfg, rules))
    fa.reset_launches()
    logits, cache = make_prefill(cfg, MAX)(params, torch.from_numpy(toks))
    step = make_serve_step(cfg)
    for _ in range(STEPS):
        _close(logits, jlogits, tol)
        tok = torch.argmax(logits, dim=-1)
        jtok = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        logits, cache = step(params, cache, tok)
        jlogits, jcache = jstep(jparams, jcache, jtok)
    _close(logits, jlogits, tol)
    assert fa.launches["gqa_flash"] == 0
    assert set(cache) == set(jcache)
    for name, want in jcache.items():
        if name == "length":
            assert cache[name] == int(want) == P + STEPS
        else:
            _close(cache[name], want, tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The reference's property (tests/test_models.py) on the port: the
    decode step's logits after S tokens equal the forward's last position."""
    cfg, _ = _pair(arch)
    params = api.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (B, 12)))
    cache = init_cache(cfg, B, 16, device="cpu")
    step = make_serve_step(cfg)
    for t in range(12):
        logits, cache = step(params, cache, toks[:, t])
    full = api.forward(params, toks, cfg)
    _close(logits, full[:, -1].numpy(), PROP_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_pure_decode(arch):
    """As the reference's tests/test_serve.py: a prefilled cache and one
    built token by token give the same logits."""
    cfg, _ = _pair(arch)
    params = api.init_params(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size,
                                                              (B, P + 4)))
    step = make_serve_step(cfg)
    logits, cache = make_prefill(cfg, MAX)(params, toks[:, :P])
    for t in range(P, P + 4):
        logits, cache = step(params, cache, toks[:, t])
    cache_b = init_cache(cfg, B, MAX, device="cpu")
    for t in range(P + 4):
        logits_b, cache_b = step(params, cache_b, toks[:, t])
    _close(logits, logits_b.numpy(), PROP_TOL)


def test_zamba2_decode_refuses_a_full_cache():
    cfg, _ = _pair("zamba2-7b")
    params = api.init_params(cfg, seed=0, device="cpu")
    cache = init_cache(cfg, 1, 2, device="cpu")
    step = make_serve_step(cfg)
    tok = torch.zeros(1, dtype=torch.long)
    for _ in range(2):
        _, cache = step(params, cache, tok)
    with pytest.raises(ValueError, match="cache full"):
        step(params, cache, tok)
    with pytest.raises(ValueError, match="empty prompt"):
        make_prefill(cfg, 4)(params, torch.zeros((1, 0), dtype=torch.long))


# --- parameters -------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_and_init_rules(arch):
    cfg, jcfg = _pair(arch)
    _, params = _weights(arch)
    mod = {"rwkv6-7b": jrwkv6, "zamba2-7b": jzamba2}[arch]
    flat = dict(api._walk_flat(params))
    assert {p: tuple(t.shape) for p, t in flat.items()} == \
        {p: tuple(s) for p, s in api._walk_flat(mod.param_shapes(jcfg))}
    init = dict(api._walk_flat(api.init_params(cfg, seed=3, device="cpu")))
    assert {p: t.shape for p, t in init.items()} == {p: t.shape for p, t in flat.items()}
    jinit = dict(api._walk_flat(japi.init_params(jcfg, jax.random.key(3))))
    for path, t in init.items():
        leaf = path[-1]
        if leaf.startswith("ln") or leaf in api.CONST_LEAVES:
            want = 1.0 if leaf.startswith("ln") else api.CONST_LEAVES[leaf]
            assert torch.equal(t, torch.full_like(t, want)), path
            np.testing.assert_array_equal(np.asarray(jinit[path]), t.numpy())
        else:       # dense_init: std 1/sqrt(shape[max(ndim - 2, 0)])
            fan_in = t.shape[max(t.dim() - 2, 0)]
            assert abs(t.std().item() * np.sqrt(fan_in) - 1) < 0.15, path


@pytest.mark.parametrize("arch", ARCHS)
def test_fp32_leaves_stay_fp32_under_bf16_compute(arch):
    """At full width (bf16 compute) the leaves the reference reads in fp32
    keep their bits: w0, u (rwkv6), a_log, dt_bias (zamba2), the norm
    scales; every other leaf is stored in bf16."""
    cfg, jcfg = _pair(arch)
    cfg = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    jparams, _ = _weights(arch)
    rng = np.random.default_rng(9)
    # values that bf16 cannot hold, for every leaf
    tree = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 0.3 - 1).astype(np.float32),
                        jparams)
    params = api.params_from_reference(cfg, tree, device="cpu")
    fp32 = {"rwkv6-7b": {"w0", "u"}, "zamba2-7b": {"a_log", "dt_bias"}}[arch]
    given = dict(api._walk_flat(tree))
    for path, t in api._walk_flat(params):
        if path[-1] in fp32 or path[-1].startswith("ln"):
            assert t.dtype == torch.float32, path
            np.testing.assert_array_equal(t.numpy(), given[path])
        else:
            assert t.dtype == torch.bfloat16, path
    assert fp32 <= {p[-1] for p, _ in api._walk_flat(params)}
    full = configs.ARCHS[arch]
    assert full.compute_dtype == torch.bfloat16 and full.param_dtype == torch.float32
    for leaf in ("w0", "u", "a_log", "dt_bias", "ln", "ln1"):
        assert api._storage_dtype(full, leaf) == torch.float32
    for leaf in ("mix", "mix_c", "conv", "d_skip", "wr", "in_z", "wq"):
        assert api._storage_dtype(full, leaf) == torch.bfloat16


@pytest.mark.parametrize("arch,count", [("rwkv6-7b", 7_534_415_872),
                                        ("zamba2-7b", 6_749_917_776)])
def test_param_count_full_configs(arch, count):
    assert api.param_count(configs.ARCHS[arch]) == count == \
        japi.param_count(jconfigs.ARCHS[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_reduced_on_cpu(arch):
    root = os.path.join(os.path.dirname(__file__), "..")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(os.path.join(root, "src")))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve", "--arch", arch, "--reduced",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=root)
    assert out.returncode == 0, out.stdout + out.stderr
    assert f"arch {arch}-smoke" in out.stdout and "tok/s" in out.stdout
    assert "0 in prefill, 0 in decode" in out.stdout
