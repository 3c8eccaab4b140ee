"""The port's training stack against the JAX package's, on the CPU.

Tolerances, each from what fp32 allows here:

- ``lr_at``: the same float32 operations in the same order, within 1 ulp
  of the peak lr (``cos``/``pow`` of two libms differ by an ulp, and
  1 + cos cancels near the cosine's end); ``adamw_update`` without clipping
  within 1 ulp elementwise; with clipping the global norm's sums run in
  another order, and 0.9 m + 0.1 g cancels: within 4 ulp of each leaf's
  largest magnitude.
- ``SyntheticLM`` / ``PrefetchLoader``: the same numpy draws, equal bit for
  bit.
- A train step of each family (dense, GQA with a prefix, MoE, SSM, hybrid)
  from the reference's weights, on both of the port's attention backends,
  against the reference's jitted step with ``attention_backend="xla"``.
  Both gradients sit ~5e-4 (relative L2) from a float64 evaluation on these
  random reduced models, so: loss rtol 1e-5; grad_norm rtol 2e-3; lr 1
  ulp; every leaf's update (new minus old params) within 5e-2 relative L2
  (AdamW's first steps move each weight by about lr times the sign of its
  gradient, so gradients near 0 that differ in sign move the update) and
  the moments m and v within 2e-2.  Three steps run each from the
  reference's own state of that step (the bias corrections, the schedule
  and the moments threaded through), and three chained steps keep the
  losses within 2e-2 (the reduced zamba2 amplifies fp32 noise step by
  step: 0.7 % by step 3; the other families within 5e-5).
- The remat modes give equal bits; the prefix forward's logits within
  rtol = atol = 5e-4 (one of 24,576 logits of order 1 sits 1.1e-4 off: the
  same fp32 noise).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro import train as jtrain
from repro.launch.mesh import make_mesh
from repro.models import LogicalRules
from repro.train import optimizer as joptimizer
from repro_torch import configs, train
from repro_torch.train import optimizer
from repro_torch.train.step import leaves

FAMILIES = ["stablelm-1.6b", "internvl2-2b", "qwen3-moe-235b-a22b", "rwkv6-7b", "zamba2-7b"]
BACKENDS = ["chunked", "flash"]
STEPS = 3
B, SEQ, CE_CHUNK = 2, 16, 8


def _opt(pkg):
    return pkg.OptimizerConfig(lr=3e-4, warmup_steps=1, total_steps=10)


@pytest.fixture(scope="module")
def rules():
    return LogicalRules(make_mesh((1, 1), ("data", "model")))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _state_tree(st):
    return {"params": _np_tree(st.params), "m": _np_tree(st.m), "v": _np_tree(st.v),
            "step": np.asarray(st.step)}


_REF = {}


def _reference(arch, rules):
    """The reference's states 0..STEPS and metrics of its jitted step on
    the reduced arch, and the host batches."""
    if arch not in _REF:
        jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.ARCHS[arch]),
                                   attention_backend="xla")
        state = jtrain.init_state(jcfg, jax.random.key(0))
        step = jax.jit(jtrain.make_train_step(jcfg, rules, _opt(jtrain), ce_chunk=CE_CHUNK))
        src = jtrain.SyntheticLM(jtrain.DataConfig(batch=B, seq_len=SEQ,
                                                   vocab_size=jcfg.vocab_size, seed=1))
        loader = jtrain.PrefetchLoader(src, model_cfg=jcfg)
        batches = [loader._make(i) for i in range(STEPS)]
        loader.close()
        states, metrics = [_state_tree(state)], []
        for hb in batches:
            state, met = step(state, {k: jnp.asarray(v) for k, v in hb.items()})
            states.append(_state_tree(state))
            metrics.append({k: np.float32(v) for k, v in met.items()})
        _REF[arch] = (states, metrics, batches)
    return _REF[arch]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    n = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / n) if n else float(np.abs(a).max())


def _port(arch, backend):
    cfg = dataclasses.replace(configs.reduced(configs.ARCHS[arch]), attention_backend=backend)
    return cfg, train.make_train_step(cfg, _opt(train), ce_chunk=CE_CHUNK)


def _batch(hb):
    return {k: torch.from_numpy(v) for k, v in hb.items()}


def _assert_step_close(got_state, got_met, before, want, want_met, what):
    np.testing.assert_allclose(float(got_met["loss"]), want_met["loss"], rtol=1e-5,
                               err_msg=what)
    np.testing.assert_allclose(float(got_met["grad_norm"]), want_met["grad_norm"], rtol=2e-3,
                               err_msg=what)
    np.testing.assert_array_max_ulp(got_met["lr"].numpy(), want_met["lr"], maxulp=1)
    assert got_state.step == int(want["step"])
    old = dict(leaves(before["params"]))
    for (path, p), (_, wp) in zip(leaves(got_state.params), leaves(want["params"])):
        assert _rel(p.numpy() - old[path], wp - old[path]) <= 5e-2, (what, path)
    for name in ("m", "v"):
        for (path, t), (_, w) in zip(leaves(getattr(got_state, name)), leaves(want[name])):
            assert _rel(t.numpy(), w) <= 2e-2, (what, name, path)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_steps_match_reference(arch, backend, rules):
    states, metrics, batches = _reference(arch, rules)
    cfg, step = _port(arch, backend)
    for k in range(STEPS):               # step k from the reference's state k
        st = train.state_from_reference(cfg, states[k], device="cpu")
        st, met = step(st, _batch(batches[k]))
        _assert_step_close(st, met, states[k], states[k + 1], metrics[k], f"{arch} step {k}")
    st = train.state_from_reference(cfg, states[0], device="cpu")
    for k in range(STEPS):               # chained
        st, met = step(st, _batch(batches[k]))
        np.testing.assert_allclose(float(met["loss"]), metrics[k]["loss"], rtol=2e-2)
        np.testing.assert_array_max_ulp(met["lr"].numpy(), metrics[k]["lr"], maxulp=1)


@pytest.mark.parametrize("arch", ["internvl2-2b", "rwkv6-7b", "zamba2-7b"])
def test_remat_modes_give_equal_bits(arch, rules):
    states, _, batches = _reference(arch, rules)
    out = {}
    for remat in ("none", "full", "dots", "collectives"):
        cfg = dataclasses.replace(configs.reduced(configs.ARCHS[arch]), remat=remat)
        st = train.state_from_reference(cfg, states[0], device="cpu")
        st, met = train.make_train_step(cfg, _opt(train), ce_chunk=CE_CHUNK)(
            st, _batch(batches[0]))
        out[remat] = (met, st)
    met0, st0 = out["none"]
    for remat, (met, st) in out.items():
        assert all(torch.equal(met[k], met0[k]) for k in met0), remat
        for tree in ("params", "m", "v"):
            assert all(torch.equal(a, b) for (_, a), (_, b) in
                       zip(leaves(getattr(st, tree)), leaves(getattr(st0, tree)))), remat


def test_prefix_forward_matches_reference(rules):
    """``prefix_embeds`` is cast and prepended as the reference does."""
    from repro.models import api as japi
    from repro_torch.models import api
    states, _, batches = _reference("internvl2-2b", rules)
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.ARCHS["internvl2-2b"]),
                               attention_backend="xla")
    want = japi.forward(jax.tree.map(jnp.asarray, states[0]["params"]),
                        jnp.asarray(batches[0]["tokens"]), jcfg, rules,
                        prefix_embeds=jnp.asarray(batches[0]["prefix_embeds"]))
    cfg = configs.reduced(configs.ARCHS["internvl2-2b"])
    params = api.params_from_reference(cfg, states[0]["params"], device="cpu")
    with torch.no_grad():
        got = api.forward(params, torch.from_numpy(batches[0]["tokens"]), cfg,
                          prefix_embeds=torch.from_numpy(batches[0]["prefix_embeds"]))
    assert got.shape == (B, SEQ + cfg.prefix_len, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4, atol=5e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small tensor ops: with one intra-op thread they
    run as fast serially and do not thrash when test workers share cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# optimizer, schedules, data


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "const"])
def test_lr_schedules_match_reference(schedule):
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, schedule=schedule)
    steps = np.arange(0, 110, dtype=np.int32)
    want = np.array([joptimizer.lr_at(jnp.int32(s), joptimizer.OptimizerConfig(**kw))
                     for s in steps], dtype=np.float32)
    got = np.array([optimizer.lr_at(int(s), optimizer.OptimizerConfig(**kw)).item()
                    for s in steps], dtype=np.float32)
    _assert_ulps_of_scale(got, want, 1, scale=np.float32(3e-4))


def _assert_ulps_of_scale(got, want, n, scale=None):
    """|got - want| <= n ulp of ``scale`` (default: want's largest magnitude)."""
    want = np.asarray(want)
    scale = np.abs(want).max() if scale is None else scale
    assert np.abs(np.asarray(got) - want).max() <= n * np.spacing(np.float32(scale))


@pytest.mark.parametrize("clip", [1e6, 1.0])
def test_adamw_update_matches_reference(clip):
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": {"c": (3,), "d": (4, 4, 2)}}
    tree = lambda scale: jax.tree.map(  # noqa: E731
        lambda s: (scale * rng.normal(size=s)).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    p, g, m, v = tree(1.0), tree(0.5), tree(0.1), jax.tree.map(np.abs, tree(0.01))
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=20, grad_clip=clip)
    want = joptimizer.adamw_update(*(jax.tree.map(jnp.asarray, t) for t in (p, g, m, v)),
                                   jnp.int32(3), joptimizer.OptimizerConfig(**kw), jnp.float32)
    lists = [[torch.from_numpy(x) for _, x in leaves(t)] for t in (p, g, m, v)]
    got = optimizer.adamw_update(*lists, 3, optimizer.OptimizerConfig(**kw), torch.float32)
    for got_leaves, want_tree in zip(got[:3], want[:3]):
        for a, (_, b) in zip(got_leaves, leaves(_np_tree(want_tree))):
            if clip > 1e3:
                np.testing.assert_array_max_ulp(a.numpy(), b, maxulp=1)
            else:
                _assert_ulps_of_scale(a.numpy(), b, 4)
    np.testing.assert_array_max_ulp(got[3].numpy(), np.asarray(want[3]), maxulp=1)
    np.testing.assert_array_max_ulp(got[4].numpy(), np.asarray(want[4]), maxulp=4)


def test_batches_equal_reference_bit_for_bit():
    jcfg = jconfigs.reduced(jconfigs.ARCHS["internvl2-2b"])
    cfg = configs.reduced(configs.ARCHS["internvl2-2b"])
    kw = dict(batch=3, seq_len=24, vocab_size=cfg.vocab_size, seed=5, prefetch=2)
    want = jtrain.PrefetchLoader(jtrain.SyntheticLM(jtrain.DataConfig(**kw)),
                                 start_step=4, model_cfg=jcfg)
    got = train.PrefetchLoader(train.SyntheticLM(train.DataConfig(**kw)),
                               start_step=4, device="cpu", model_cfg=cfg)
    try:
        for _ in range(3):
            a, b = next(got), next(want)
            assert set(a) == set(b) == {"tokens", "prefix_embeds"}
            for key in a:
                assert a[key].dtype == torch.from_numpy(np.asarray(b[key])).dtype
                np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]))
    finally:
        got.close()
        want.close()
    src = train.SyntheticLM(train.DataConfig(**kw))
    np.testing.assert_array_equal(src.batch_at(11),
                                  jtrain.SyntheticLM(jtrain.DataConfig(**kw)).batch_at(11))


def test_chunked_cross_entropy_chunks_and_pads():
    """Chunking and padding change nothing beyond fp32 sums; pad targets
    (-1) count for nothing."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(2, 21, 16)).astype(np.float32))
    head = torch.from_numpy(rng.normal(size=(16, 40)).astype(np.float32))
    tg = torch.from_numpy(rng.integers(0, 40, (2, 18)))
    tg[1, 10:] = -1
    logits = x[:, 3:20] @ head
    nll = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, tg[:, 1:].clamp(min=0)[..., None])[..., 0]
    valid = tg[:, 1:] >= 0
    want = (nll * valid).sum() / valid.sum()
    for chunk in (1, 4, 17, 64):
        got = train.chunked_cross_entropy(x, head, tg, chunk=chunk, prefix=3)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="prefix_embeds"):
        train.chunked_cross_entropy(x[:, :18], head, tg, prefix=3)


def test_init_state_and_template(rules):
    cfg = configs.reduced(configs.ARCHS["internvl2-2b"])
    st = train.init_state(cfg, seed=0, device="cpu", compression=True)
    tpl = train.state_template(cfg, compression=True)
    for tree in ("params", "m", "v", "ef"):
        a, b = leaves(getattr(st, tree)), leaves(getattr(tpl, tree))
        assert [p for p, _ in a] == [p for p, _ in b]
        assert all(x.shape == y.shape and x.dtype == y.dtype for (_, x), (_, y) in zip(a, b))
    assert st.step == 0 and all(t.dtype == torch.bfloat16 for _, t in leaves(st.ef))
    assert all(t.dtype == cfg.param_dtype for _, t in leaves(st.params))
