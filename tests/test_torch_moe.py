"""The port's MoE block against the JAX package's, on the CPU.

Weights are the reference's ``init_params`` of the reduced MoE configs
(4 experts, top 2), carried across with ``params_from_reference``; inputs
are drawn with numpy.  Outputs agree within rtol = atol = 1e-5 in fp32,
and the routing (top-k experts, slots, kept pairs, source tokens) is equal
bit for bit to the reference's dispatch expressions on the same router
probabilities, capacity drops and planted ties included.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.launch.mesh import make_mesh
from repro.models import LogicalRules
from repro.models import api as japi
from repro.models import transformer as jtransformer
from repro_torch import configs
from repro_torch.models import api, transformer

ARCHS = ["qwen3-moe-235b-a22b", "dbrx-132b"]
TOL = 1e-5
# (batch, seq): a prefill-like block of tokens, and a decode step (T = B)
SHAPES = [(2, 32), (4, 1), (3, 1)]


@pytest.fixture(scope="module")
def rules():
    return LogicalRules(make_mesh((1, 1), ("data", "model")))


def _pair(arch, cf):
    cfg = dataclasses.replace(configs.reduced(configs.ARCHS[arch]), capacity_factor=cf)
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.ARCHS[arch]),
                               capacity_factor=cf)
    return cfg, jcfg


_WEIGHTS = {}


def _weights(arch):
    """The reference's reduced weights (numpy, stacked by layer), and the
    port's params."""
    if arch not in _WEIGHTS:
        cfg, jcfg = _pair(arch, 1.25)
        tree = jax.tree.map(np.asarray, japi.init_params(jcfg, jax.random.key(0)))
        _WEIGHTS[arch] = (tree, api.params_from_reference(cfg, tree, device="cpu"))
    return _WEIGHTS[arch]


def _layer(tree, li):
    return {k: jnp.asarray(v[li]) for k, v in tree["layers"].items()}


def _x(cfg, b, s, seed=0):
    return np.random.default_rng(seed).normal(size=(b, s, cfg.d_model)).astype(np.float32)


def reference_routing(probs, k, cap):
    """``repro``'s ``moe_block_global`` dispatch, expression for expression,
    on the router probabilities ``probs`` (T, E)."""
    t, e = probs.shape
    gate, eidx = jax.lax.top_k(jnp.asarray(probs), k)
    gate = gate / jnp.maximum(gate.sum(-1, keepdims=True), 1e-9)
    flat_e = eidx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = jnp.searchsorted(sorted_e, sorted_e, side="left")
    ranks = jnp.arange(t * k) - first
    keep = ranks < cap
    slot = jnp.where(keep, sorted_e * cap + ranks, e * cap)
    return dict(gate=gate, eidx=eidx, order=order, slot=slot, keep=keep,
                src_tok=order // k)


def _probs(x, router, dtype=torch.float32):
    xt = torch.from_numpy(x.reshape(-1, x.shape[-1])).to(dtype)
    return torch.softmax((xt @ torch.from_numpy(np.array(router)).to(dtype)).float(), dim=-1)


def assert_same_routing(r, want):
    for name in ("eidx", "order", "slot", "keep", "src_tok"):
        np.testing.assert_array_equal(getattr(r, name).numpy(),
                                      np.asarray(want[name]), err_msg=name)
    np.testing.assert_allclose(r.gate.numpy(), np.asarray(want["gate"]),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"B{s[0]}xS{s[1]}")
@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference(arch, cf, shape, rules):
    cfg, jcfg = _pair(arch, cf)
    tree, params = _weights(arch)
    li = 1
    x = _x(cfg, *shape)
    lp = _layer(tree, li)
    want = np.asarray(jtransformer.moe_block_global(jnp.asarray(x), lp, jcfg, rules))
    want_mesh = np.asarray(jtransformer.moe_block(jnp.asarray(x), lp, jcfg, rules))
    got = transformer.moe_block(torch.from_numpy(x), params["layers"], li, cfg)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), want_mesh, rtol=TOL, atol=TOL)

    # the routing, bit for bit, on the port's router probabilities
    t = shape[0] * shape[1]
    cap = transformer.capacity(cfg, t)
    assert cap == int(np.ceil(t * jcfg.experts_per_token / jcfg.num_experts * cf))
    probs = _probs(x, tree["layers"]["router"][li])
    r = transformer.moe_route(probs, cfg.experts_per_token, cap)
    assert_same_routing(r, reference_routing(probs.numpy(), cfg.experts_per_token, cap))
    dropped = int((~r.keep).sum())
    if cf == 8.0:
        assert dropped == 0
    elif shape == (2, 32):
        assert dropped > 0           # capacity 20 of 64 pairs on 4 experts


@pytest.mark.parametrize("planted", ["two-equal-columns", "all-equal-columns"])
def test_planted_ties_pick_the_reference_experts(planted, rules):
    """Equal router columns give bit-equal probabilities; ``lax.top_k``
    takes the lower expert id first, and so must the port."""
    arch = "qwen3-moe-235b-a22b"
    cfg, jcfg = _pair(arch, 1.25)
    tree, _ = _weights(arch)
    tree = jax.tree.map(np.copy, tree)
    router = tree["layers"]["router"]
    if planted == "two-equal-columns":
        router[:, :, 2] = router[:, :, 1]
    else:
        router[:, :, :] = router[:, :, :1]
    params = api.params_from_reference(cfg, tree, device="cpu")
    li, (b, s) = 0, (2, 32)
    x = _x(cfg, b, s, seed=3)
    probs = _probs(x, router[li])
    np.testing.assert_array_equal(probs[:, 1].numpy(), probs[:, 2].numpy())
    cap = transformer.capacity(cfg, b * s)
    r = transformer.moe_route(probs, cfg.experts_per_token, cap)
    want = reference_routing(probs.numpy(), cfg.experts_per_token, cap)
    assert_same_routing(r, want)
    eidx = r.eidx.numpy()
    if planted == "two-equal-columns":
        # wherever experts 1 and 2 tie inside the top 2, 1 comes first;
        # where they tie for second place, 1 is taken and 2 left out
        both = (eidx == 1).any(1) & (eidx == 2).any(1)
        assert both.any()
        assert (eidx[both] == [1, 2]).all()
        assert not ((eidx == 2).any(1) & ~(eidx == 1).any(1)).any()
    else:
        assert (eidx == [0, 1]).all()
        assert int((~r.keep).sum()) == 2 * (b * s - cap)   # experts 0 and 1 overflow
    got = transformer.moe_block(torch.from_numpy(x), params["layers"], li, cfg)
    ref = jtransformer.moe_block_global(jnp.asarray(x), _layer(tree, li), jcfg, rules)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_is_deterministic(dtype):
    cfg, _ = _pair("qwen3-moe-235b-a22b", 1.25)
    cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    _, params = _weights("qwen3-moe-235b-a22b")
    lp = {k: v.to(dtype) for k, v in params["layers"].items()}
    x = torch.from_numpy(_x(cfg, 2, 32, seed=5)).to(dtype)
    a = transformer.moe_block(x, lp, 2, cfg)
    b = transformer.moe_block(x, lp, 2, cfg)
    assert a.dtype == dtype and torch.equal(a, b)


def test_combine_sums_each_token_in_ascending_expert_order():
    """The combine adds a token's contributions in ascending expert id, the
    order the reference's sorted scatter reaches them: in bf16, where the
    order shows in the bits, it equals that loop written out."""
    gen = torch.Generator().manual_seed(0)
    t, e, k, c, d = 6, 4, 3, 5, 8
    probs = torch.softmax(torch.randn(t, e, generator=gen), dim=-1)
    r = transformer.moe_route(probs, k, c)
    yb = torch.randn(e, c, d, generator=gen).to(torch.bfloat16) * 100
    got = transformer.moe_combine(yb, r)
    ybuf = torch.cat([yb.reshape(e * c, d), yb.new_zeros((1, d))])
    weight = (r.gate.reshape(-1)[r.order] * r.keep).to(torch.bfloat16)
    want = torch.zeros((t, d), dtype=torch.bfloat16)
    for p in range(t * k):              # sorted order, as the scatter-add
        tok = int(r.src_tok[p])
        want[tok] = want[tok] + ybuf[r.slot[p]] * weight[p]
    assert torch.equal(got, want)


def test_capacity_is_the_reference_expression():
    full = configs.ARCHS["qwen3-moe-235b-a22b"]
    assert transformer.capacity(full, 4 * 2048) == 640
    assert transformer.capacity(full, 4) == 1
    dbrx = configs.ARCHS["dbrx-132b"]
    for t in (1, 3, 4, 7, 4096):
        assert transformer.capacity(dbrx, t) == int(np.ceil(t * 4 / 16 * 1.25))
