"""The port's sharding layer against the JAX package's, on the CPU.

- **Spec trees, in process.**  For each of the ten archs, on the
  reference's ``make_abstract_mesh`` at 16x16, 2x16x16, (2, 2) and (1, 2),
  the port's spec trees equal the reference's ``PartitionSpec`` entries
  entry for entry: params, train state, the decode cache (a 32k cache of
  128 sequences, and one of a single sequence whose batch does not divide)
  and the training batch (``train_4k``; a prefix config's embeddings too).
  minicpm's 36 heads fall back to replication on a 16-way axis in both.
- **Numbers, on ranks.**  One subprocess runs the reference on 4 forced
  host devices and writes one ``.npz``; meanwhile 4 gloo ranks run the
  port (one thread each), each mesh over the first ranks of the one world.
  At meshes (1, 2), (2, 1) and (2, 2), on reduced llama3-8b,
  qwen3-moe-235b-a22b, internvl2-2b (through ``make_train_step`` and
  ``PrefetchLoader``), rwkv6-7b and zamba2-7b, from the same weights:
  forward logits, three chained train steps (loss, grad norm, every
  leaf), prefill and four greedy decode steps (logits and tokens); rwkv6
  and zamba2 on their own tensor-parallel layers, as the transformer
  families, each returning the rank's block of the vocabulary.  And a
  batch of one sequence on (2, 2), which does not divide the batch axes:
  the reference's spec replicates it, and so does the port's (reduced
  llama3-8b and rwkv6-7b, prefill and four decode steps).  And a batch
  of three sequences through reduced qwen3-moe-235b-a22b at (2, 1), at a
  capacity factor under which experts drop tokens: every rank serves the
  whole batch, and its MoE routes the batch's rows, as the reference's
  global dispatch does, not the gathered copies of both ranks (a separate
  reference subprocess on 2 forced host devices, and 2 gloo ranks).
- **The MoE's kept pairs, exactly.**  The reference's expert-parallel
  ``moe_block`` runs on weights that make expert e write a one-hot row e
  weighted by the token's gate (constant SwiGLU on a constant feature),
  so its output shows which (token, expert) pairs it kept; each port
  rank's ``Routing`` keeps the same pairs for its experts and tokens, at
  (1, 2) and at (2, 2), where each data shard's capacity is over its own
  tokens and drops differ from the global dispatch.

Tolerances are the one-device tests' (``tests/test_torch_lm.py``,
``tests/test_torch_ssm.py``, ``tests/test_torch_train.py``):

- forward and decode logits of the transformer families within
  rtol = atol = 5e-4; greedy tokens equal.  rwkv6 and zamba2: rtol 1e-4
  and an atol of 2e-4 times the largest logit, twice the one-device
  test's atol, as the reading needs: reduced zamba2's logits (largest
  4.78) sat 7.4e-4 from the reference at (2, 1) and 5.2e-4 at (1, 2) and
  (2, 2) when the port computed them replicated over ``model``, while the
  reference's own logits move 2.2e-4 between its (1, 2) and (2, 1) meshes.
- The train step from the reference's state: loss rtol 1e-5, grad norm
  2e-3, every leaf's update within 5e-2 relative L2.  The two chained
  steps after it: losses within 2e-2, as the one-device test's chained
  steps; their grad norms and leaves are not held against the reference,
  whose own chained grad norm moves up to 17 % and leaves 0.19 (relative
  L2 of the update) between its meshes on reduced zamba2 (3.6e-2 on
  llama3): fp32 noise that three steps under the reference init amplify.
  Instead every step is held against the port's one-device step from the
  same whole state and batch, at the one-device test's per-step
  tolerances (loss 1e-5, grad norm 2e-3, params' update 5e-2, moments
  2e-2), the one-device step itself being held against the reference's
  in ``tests/test_torch_train.py``.  At (2, 2) the MoE's dispatch is per
  data shard, so its one-device step drops other tokens: that pair is
  held only against the reference.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

ARCHS5 = ["llama3-8b", "qwen3-moe-235b-a22b", "internvl2-2b", "rwkv6-7b", "zamba2-7b"]
MESHES = [(1, 2), (2, 1), (2, 2)]
WORLD = 4
B, S, P, MAX, STEPS, DECODE, CE_CHUNK = 4, 16, 8, 16, 3, 4, 8
# a batch of one sequence, on a mesh whose batch axes it does not divide;
# the reference's serving of it, at (2, 2) where the reference runs it: its
# sequence-sharded decode attention (a shard_map whose in_specs split the
# batch over ``data``) refuses a batch of 1 at (2, 2), so llama3's is taken
# at (1, 2), the same split over ``model``
ONE_ARCHS, ONE_MESH = ["llama3-8b", "rwkv6-7b"], (2, 2)
ONE_REF_MESH = {"llama3-8b": (1, 2), "rwkv6-7b": (2, 2)}
# an MoE batch that the batch axes do not divide: three sequences at (2, 1)
# (``data`` 2), and a capacity factor at which the dispatch drops tokens,
# so routing the 3 rows' or the gathered 6 rows' at their capacity keeps
# different (token, expert) pairs
MOE_ARCH, MOE_BATCH, MOE_MESH, MOE_CAPACITY = "qwen3-moe-235b-a22b", 3, (2, 1), 0.5
# the ranks' join and the reference's wait, in seconds: the ranks alone take
# ~65 s on an 8-core host (~2.5 ms a gloo collective, ~10k of them), and the
# driver's parallel workers share the host
TIMEOUT = 300


def _cfg(pkg, arch):
    from importlib import import_module

    configs = import_module(f"{pkg}.configs")
    return dataclasses.replace(configs.reduced(configs.ARCHS[arch]), attention_backend=(
        "xla" if pkg == "repro" else "chunked"))


def _opt(train):
    return train.OptimizerConfig(lr=3e-4, warmup_steps=1, total_steps=10)


def _key(arch, mesh, what):
    return f"{arch}|{mesh[0]}x{mesh[1]}|{what}"


# ---------------------------------------------------------------------------
# the reference on 4 forced host devices (run as a script in a subprocess)


def _moe_probe(cfg_d, e, rng):
    """A layer input and weights under which expert e's SwiGLU is the
    constant one-hot row e: feature 0 of every token is 1, ``w_gate`` and
    ``w_up`` read it alone into hidden unit 0, ``w_down`` maps that unit to
    output e.  The router reads the other features."""
    d, f = cfg_d
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    x[..., 0] = 1.0
    router = rng.normal(size=(d, e)).astype(np.float32)
    router[0] = 0.0
    router[:, 0] *= 3.0                    # a popular expert: its later pairs drop
    wg = np.zeros((e, d, f), np.float32)
    wu = np.zeros((e, d, f), np.float32)
    wd = np.zeros((e, f, d), np.float32)
    wg[:, 0, 0] = 8.0
    wu[:, 0, 0] = 1.0
    silu8 = 8.0 / (1.0 + np.exp(-8.0))
    for i in range(e):
        wd[i, 0, i] = 1.0 / silu8
    return x, {"router": router, "w_gate": wg, "w_up": wu, "w_down": wd}


def reference_main(inputs: str, out: str, arch: str) -> None:
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={WORLD}"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp

    from repro import train as jtrain
    from repro.launch.mesh import make_mesh
    from repro.models import LogicalRules, api as japi
    from repro.models import transformer as jtf
    from repro.serve.decode import make_prefill, make_serve_step

    data = np.load(inputs)
    res = {}
    for arch in [arch]:
        jcfg = _cfg("repro", arch)
        names = [k.split("|", 2)[2] for k in data.files if k.startswith(f"{arch}|params|")]
        params = {}
        for n in names:
            node = params
            parts = n.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(data[f"{arch}|params|{n}"])
        toks = jnp.asarray(data[f"{arch}|tokens"])
        prefix = (jnp.asarray(data[f"{arch}|prefix"]) if jcfg.prefix_len else None)
        for mesh in MESHES:
            rules = LogicalRules(make_mesh(mesh, ("data", "model")))
            fwd = jax.jit(lambda p, t, pe: japi.forward(p, t, jcfg, rules, prefix_embeds=pe))
            res[_key(arch, mesh, "logits")] = np.asarray(fwd(params, toks, prefix))
            state = jtrain.TrainState(params=params, m=jax.tree.map(jnp.zeros_like, params),
                                      v=jax.tree.map(jnp.zeros_like, params),
                                      step=jnp.zeros((), jnp.int32))
            step = jax.jit(jtrain.make_train_step(jcfg, rules, _opt(jtrain), ce_chunk=CE_CHUNK))
            for i in range(STEPS):
                batch = {"tokens": jnp.asarray(data[f"{arch}|batch{i}|tokens"])}
                if jcfg.prefix_len:
                    batch["prefix_embeds"] = jnp.asarray(data[f"{arch}|batch{i}|prefix_embeds"])
                state, met = step(state, batch)
                res[_key(arch, mesh, f"loss{i}")] = np.float32(met["loss"])
                res[_key(arch, mesh, f"gnorm{i}")] = np.float32(met["grad_norm"])
                if i == 0:
                    for path, leaf in jax.tree_util.tree_flatten_with_path(state.params)[0]:
                        name = "/".join(str(p.key) for p in path)
                        res[_key(arch, mesh, f"trained/{name}")] = np.asarray(leaf)
            if jcfg.prefix_len:
                continue                      # serving takes no prefix
            sparams = jax.tree.map(lambda a: a.astype(jcfg.param_dtype), params)

            def serve_run(prompt):
                logits, cache = jax.jit(make_prefill(jcfg, rules, MAX))(sparams, prompt)
                serve = jax.jit(make_serve_step(jcfg, rules))
                outs, tok, gen = [logits], jnp.argmax(logits, -1), []
                for _ in range(DECODE):
                    gen.append(tok)
                    logits, cache = serve(sparams, cache, tok.astype(jnp.int32))
                    outs.append(logits)
                    tok = jnp.argmax(logits, -1)
                gen.append(tok)
                return (np.stack([np.asarray(o) for o in outs]),
                        np.stack([np.asarray(t) for t in gen]))

            res[_key(arch, mesh, "serve_logits")], res[_key(arch, mesh, "serve_tokens")] = \
                serve_run(toks[:, :P])
            if mesh == ONE_REF_MESH.get(arch):
                res[_key(arch, mesh, "one_logits")], res[_key(arch, mesh, "one_tokens")] = \
                    serve_run(toks[:1, :P])
    jcfg = _cfg("repro", "qwen3-moe-235b-a22b")
    x, w = _moe_probe((jcfg.d_model, jcfg.d_ff), jcfg.num_experts, np.random.default_rng(5))
    for mesh in [(1, 2), (2, 2)] if arch == "qwen3-moe-235b-a22b" else []:
        rules = LogicalRules(make_mesh(mesh, ("data", "model")))
        fn = jax.jit(lambda x_, lp: jtf.moe_block(x_, lp, jcfg, rules))
        res[_key("moe-probe", mesh, "y")] = np.asarray(
            fn(jnp.asarray(x), {k: jnp.asarray(v) for k, v in w.items()}))
    np.savez(out, **res)


def _moe_cfg(pkg):
    return dataclasses.replace(_cfg(pkg, MOE_ARCH), capacity_factor=MOE_CAPACITY)


def moe_serve_reference(inputs: str, out: str) -> None:
    """The reference's prefill and greedy decode of the MoE batch at
    ``MOE_MESH`` on 2 forced host devices."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp

    from repro.launch.mesh import make_mesh
    from repro.models import LogicalRules
    from repro.serve.decode import make_prefill, make_serve_step

    data = np.load(inputs)
    jcfg = _moe_cfg("repro")
    params = {}
    for key in data.files:
        if key.startswith("params|"):
            node = params
            parts = key.split("|", 1)[1].split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = jnp.asarray(data[key]).astype(jcfg.param_dtype)
    rules = LogicalRules(make_mesh(MOE_MESH, ("data", "model")))
    logits, cache = jax.jit(make_prefill(jcfg, rules, MAX))(params, jnp.asarray(data["tokens"]))
    serve = jax.jit(make_serve_step(jcfg, rules))
    outs, tok, gen = [logits], jnp.argmax(logits, -1), []
    for _ in range(DECODE):
        gen.append(tok)
        logits, cache = serve(params, cache, tok.astype(jnp.int32))
        outs.append(logits)
        tok = jnp.argmax(logits, -1)
    gen.append(tok)
    np.savez(out, logits=np.stack([np.asarray(o) for o in outs]),
             tokens=np.stack([np.asarray(t) for t in gen]))


def _moe_serve_rank(rank: int, init: str, inputs: str, out: str) -> None:
    """The port's ``greedy_generate`` of the MoE batch on one of 2 gloo
    ranks: the prompts' ``.sharding`` replicates the batch (3 on ``data``
    2), which the prefill and every decode step read."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
    from repro_torch.launch.mesh import DistMesh, make_mesh
    from repro_torch.models import api
    from repro_torch.models.common import LogicalRules
    from repro_torch.serve.decode import greedy_generate, make_prefill, make_serve_step
    from repro_torch.train.step import unflatten

    data = np.load(inputs)
    cfg = _moe_cfg("repro_torch")
    names = [k.split("|", 1)[1] for k in data.files if k.startswith("params|")]
    tree = unflatten([tuple(n.split("/")) for n in names],
                     [data[f"params|{n}"] for n in names])
    rules = LogicalRules(DistMesh(make_mesh(MOE_MESH, ("data", "model"))))
    params = api.params_from_reference(cfg, tree, device="cpu", rules=rules)
    prompts = torch.from_numpy(data["tokens"]).long()
    prompts.sharding = rules.sharding("batch", dims=(MOE_BATCH,))
    assert prompts.sharding.spec == ()             # 3 on ``data`` 2: replicated
    with torch.no_grad():
        run = greedy_generate(params, prompts, cfg, DECODE, rules)
        # the decode steps' logits, as the reference's loop records them
        prefill, step = make_prefill(cfg, MAX, rules), make_serve_step(cfg, rules)
        logits, cache = prefill(params, prompts)
        outs, tok = [logits], logits.argmax(-1)
        for _ in range(DECODE):
            tok.sharding = prompts.sharding
            logits, cache = step(params, cache, tok)
            outs.append(logits)
            tok = logits.argmax(-1)
    gen = torch.cat([run["tokens"], tok[:, None]], dim=1).T
    np.savez(f"{out}.{rank}.npz", logits=torch.stack(outs).numpy(), tokens=gen.numpy(),
             prefill=run["prefill_logits"].numpy())
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the port on gloo ranks


def _port_rank(rank: int, init: str, inputs: str, out: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=WORLD)
    from repro_torch import distributed as D
    from repro_torch import train
    from repro_torch.launch.mesh import DistMesh, make_mesh
    from repro_torch.models import api, transformer
    from repro_torch.models.common import LogicalRules
    from repro_torch.serve.decode import make_prefill, make_serve_step
    from repro_torch.train.step import gather_whole, leaves, unflatten

    data = np.load(inputs)
    res = {}

    def gathered_batch(t, rules):
        return D.all_gather(t, 0, rules, rules.batch_axes)

    for arch in ARCHS5:
        cfg = _cfg("repro_torch", arch)
        prefix_len = cfg.prefix_len
        names = [k.split("|", 2)[2] for k in data.files if k.startswith(f"{arch}|params|")]
        tree = unflatten([tuple(n.split("/")) for n in names],
                         [data[f"{arch}|params|{n}"] for n in names])
        toks = torch.from_numpy(data[f"{arch}|tokens"]).long()
        for mesh in MESHES:
            rules = LogicalRules(DistMesh(make_mesh(mesh, ("data", "model"))))
            if not rules.mesh.member:
                continue
            first = all(c == 0 for c in rules.coords.values())
            bsh = rules.sharding("batch", dims=(B,))
            params = api.params_from_reference(cfg, tree, device="cpu", master=True,
                                               rules=rules)
            kw = {}
            if prefix_len:
                kw["prefix_embeds"] = bsh.local(torch.from_numpy(data[f"{arch}|prefix"]))
            with torch.no_grad():
                logits = api.forward(params, bsh.local(toks), cfg, rules=rules, **kw)
                if transformer.split(cfg, rules, "", "embed", 0):
                    logits = D.all_gather(logits, 2, rules, "model")
                logits = gathered_batch(logits, rules)
            if first:
                res[_key(arch, mesh, "logits")] = logits.numpy()
            state = train.state_from_reference(cfg, {"params": tree, "m": _zeros(tree),
                                                     "v": _zeros(tree), "step": 0},
                                               device="cpu", rules=rules)
            step = train.make_train_step(cfg, _opt(train), ce_chunk=CE_CHUNK, rules=rules)
            src = train.SyntheticLM(train.DataConfig(batch=B, seq_len=S - prefix_len,
                                                     vocab_size=cfg.vocab_size, seed=1))
            specs = train.batch_specs(cfg, dataclasses.make_dataclass(
                "Shape", ["global_batch", "seq_len"])(B, S), rules)
            loader = train.PrefetchLoader(src, device="cpu", model_cfg=cfg, sharding=specs)
            shards = train.state_shardings(cfg, rules)
            one = train.make_train_step(cfg, _opt(train), ce_chunk=CE_CHUNK)
            for i in range(STEPS):
                batch = next(loader)
                whole = _whole(state, shards)
                state, met = step(state, batch)
                got = _whole(state, shards)
                if first:
                    res[_key(arch, mesh, f"loss{i}")] = float(met["loss"])
                    res[_key(arch, mesh, f"gnorm{i}")] = float(met["grad_norm"])
                    if i == 0:
                        for path, t in leaves(got.params):
                            res[_key(arch, mesh, "trained/" + "/".join(path))] = t.numpy()
                    # the one-device step from the same state and whole batch
                    want, wmet = one(whole, {k: torch.from_numpy(data[f"{arch}|batch{i}|{k}"])
                                             for k in batch})
                    res[_key(arch, mesh, f"one/loss{i}")] = float(wmet["loss"])
                    res[_key(arch, mesh, f"one/gnorm{i}")] = float(wmet["grad_norm"])
                    for name in ("params", "m", "v"):
                        for path, t in leaves(getattr(got, name)):
                            w0 = dict(leaves(getattr(whole, name)))[path]
                            w1 = dict(leaves(getattr(want, name)))[path]
                            k = _key(arch, mesh, f"one{i}/{name}/" + "/".join(path))
                            res[k] = np.float64(_rel(t - w0 if name == "params" else t,
                                                     w1 - w0 if name == "params" else w1))
            loader.close()
            if prefix_len:
                continue
            sparams = api.params_from_reference(cfg, tree, device="cpu", rules=rules)

            @torch.no_grad()
            def serve_run(prompt):
                logits, cache = make_prefill(cfg, MAX, rules)(sparams, prompt)
                serve = make_serve_step(cfg, rules)
                outs, tok, gen = [logits], logits.argmax(-1), []
                for _ in range(DECODE):
                    gen.append(tok)
                    logits, cache = serve(sparams, cache, tok)
                    outs.append(logits)
                    tok = logits.argmax(-1)
                gen.append(tok)
                return torch.stack(outs), torch.stack(gen)

            outs, gen = serve_run(bsh.local(toks[:, :P]))
            outs = D.all_gather(outs, 1, rules, rules.batch_axes)
            gen = D.all_gather(gen, 1, rules, rules.batch_axes)
            if first:
                res[_key(arch, mesh, "serve_logits")] = outs.numpy()
                res[_key(arch, mesh, "serve_tokens")] = gen.numpy()
            if arch in ONE_ARCHS and mesh == ONE_MESH:
                # one sequence: the batch axes' spec falls back, every rank
                # serves the whole batch
                one = rules.sharding("batch", dims=(1,))
                assert one.spec == ()
                outs, gen = serve_run(one.local(toks[:1, :P]))
                res[_key(arch, mesh, f"one_logits{rank}")] = outs.numpy()
                res[_key(arch, mesh, f"one_tokens{rank}")] = gen.numpy()
    cfg = _cfg("repro_torch", "qwen3-moe-235b-a22b")
    x, w = _moe_probe((cfg.d_model, cfg.d_ff), cfg.num_experts, np.random.default_rng(5))
    for mesh in [(1, 2), (2, 2)]:
        rules = LogicalRules(DistMesh(make_mesh(mesh, ("data", "model"))))
        if not rules.mesh.member:
            continue
        lp = {k: rules.sharding(*transformer.param_specs(cfg)["layers"][k][1:],
                                dims=v.shape).local(torch.from_numpy(v))[None]
              for k, v in w.items()}
        routing = []
        xl = rules.sharding("batch", dims=(B,)).local(torch.from_numpy(x))
        with torch.no_grad():
            transformer.moe_block_local(xl, lp, 0, cfg, rules, routing=routing)
        r = routing[0]
        kept = r.keep.clone()
        tok = r.src_tok[kept]
        e0 = rules.coords["model"] * (cfg.num_experts // rules.tp)
        ex = r.eidx.reshape(-1)[r.order][kept]
        t0 = rules.index(rules.batch_axes) * xl.shape[0] * S
        pairs = torch.stack([tok + t0, ex], dim=1)
        assert ((ex >= e0) & (ex < e0 + cfg.num_experts // rules.tp)).all()
        res[_key("moe-probe", mesh, f"pairs{rank}")] = pairs.numpy()
    # every rank's pairs and batch-of-one serving reach the first rank
    # through a file of its own
    np.savez(out + f".{rank}.npz", **{k: v for k, v in res.items()
                                      if "moe-probe" in k or "|one_" in k})
    if rank == 0:
        np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
    dist.barrier()
    dist.destroy_process_group()


def _whole(state, shards):
    """A state of this rank's blocks made whole (every rank takes part)."""
    from repro_torch import train
    from repro_torch.train.step import gather_whole, leaves, unflatten

    def tree(node, sh):
        flat, shd = leaves(node), dict(leaves(sh))
        return unflatten([p for p, _ in flat], [gather_whole(t, shd[p]) for p, t in flat])

    return train.TrainState(params=tree(state.params, shards.params),
                            m=tree(state.m, shards.m), v=tree(state.v, shards.v),
                            step=state.step)


def _zeros(tree):
    return {k: _zeros(v) if isinstance(v, dict) else np.zeros_like(v) for k, v in tree.items()}


def _inputs(path: str) -> None:
    """Weights (the port's init from seed 0, fp32), tokens, prefixes and the
    three training batches of each arch, for both packages."""
    from repro_torch import train
    from repro_torch.models import api
    from repro_torch.train.step import leaves

    out = {}
    rng = np.random.default_rng(0)
    for arch in ARCHS5:
        cfg = _cfg("repro_torch", arch)
        for leaf, t in leaves(api.init_params(cfg, 0, "cpu", master=True)):
            out[f"{arch}|params|{'/'.join(leaf)}"] = t.numpy()
        out[f"{arch}|tokens"] = rng.integers(0, cfg.vocab_size, (B, S - cfg.prefix_len),
                                             dtype=np.int32)
        if cfg.prefix_len:
            out[f"{arch}|prefix"] = rng.normal(0, 0.02, (B, cfg.prefix_len, cfg.d_model)
                                               ).astype(np.float32)
        src = train.SyntheticLM(train.DataConfig(batch=B, seq_len=S - cfg.prefix_len,
                                                 vocab_size=cfg.vocab_size, seed=1))
        loader = train.PrefetchLoader(src, device="cpu", model_cfg=cfg)
        for i in range(STEPS):
            for k, v in loader._make(i).items():
                out[f"{arch}|batch{i}|{k}"] = v
        loader.close()
    np.savez(path, **out)


def spawn(fn, nprocs: int, args: tuple, timeout: float = TIMEOUT) -> None:
    """``fn(rank, *args)`` in ``nprocs`` spawned processes, joined within
    ``timeout`` seconds: a rank that raises or hangs fails the caller and
    every rank is stopped."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks did not finish within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


@pytest.fixture(scope="module")
def results():
    """(reference results, port results): the reference's subprocess and
    the port's ranks run at the same time."""
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs.npz")
        _inputs(inputs)
        ref_out = os.path.join(tmp, "reference.npz")
        env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
                   JAX_PLATFORMS="cpu")
        procs = []
        try:
            for arch in ARCHS5:
                log = open(os.path.join(tmp, f"{arch}.log"), "w+")
                procs.append((subprocess.Popen(
                    [sys.executable, __file__, "--reference", inputs, f"{ref_out}.{arch}.npz",
                     arch], env=env, stdout=log, stderr=subprocess.STDOUT), log))
            port_out = os.path.join(tmp, "port.npz")
            spawn(_port_rank, WORLD, ("file://" + os.path.join(tmp, "rdzv"), inputs, port_out))
            deadline = time.monotonic() + TIMEOUT
            for proc, _ in procs:
                proc.wait(timeout=max(deadline - time.monotonic(), 1))
        finally:
            for proc, log in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.seek(0)
                text = log.read()
                log.close()
                assert proc.returncode == 0, text[-3000:]
        ref = {}
        for arch in ARCHS5:
            ref.update(np.load(f"{ref_out}.{arch}.npz"))
        port = dict(np.load(port_out))
        for r in range(WORLD):
            port.update(np.load(port_out + f".{r}.npz"))
        init = {k: v for k, v in np.load(inputs).items() if "|params|" in k}
    return ref, port, init


@pytest.fixture(scope="module")
def moe_batch():
    """(reference's serving, each port rank's) of the MoE batch of three
    at (2, 1), from the port's init (seed 0) and numpy prompts."""
    from repro_torch.models import api
    from repro_torch.train.step import leaves

    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs.npz")
        cfg = _moe_cfg("repro_torch")
        np.savez(inputs, tokens=np.random.default_rng(7).integers(
            0, cfg.vocab_size, (MOE_BATCH, P), dtype=np.int32),
            **{"params|" + "/".join(leaf): t.numpy()
               for leaf, t in leaves(api.init_params(cfg, 0, "cpu", master=True))})
        ref_out = os.path.join(tmp, "reference.npz")
        env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
                   JAX_PLATFORMS="cpu")
        with open(os.path.join(tmp, "reference.log"), "w+") as log:
            proc = subprocess.Popen([sys.executable, __file__, "--moe-reference", inputs,
                                     ref_out], env=env, stdout=log, stderr=subprocess.STDOUT)
            try:
                port_out = os.path.join(tmp, "port")
                spawn(_moe_serve_rank, 2, ("file://" + os.path.join(tmp, "rdzv"), inputs,
                                           port_out))
                proc.wait(timeout=TIMEOUT)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.seek(0)
                text = log.read()
            assert proc.returncode == 0, text[-3000:]
        ref = dict(np.load(ref_out))
        port = [dict(np.load(f"{port_out}.{r}.npz")) for r in range(2)]
    return ref, port


def test_moe_serves_an_undivided_batch_as_reference(moe_batch):
    """Three sequences through reduced qwen3-moe at (2, 1), capacity factor
    0.5: each rank's prefill and four greedy decode steps give the
    reference's logits and tokens (``greedy_generate`` carrying the
    prompts' split to the decode tokens, as the hand-driven steps do)."""
    ref, port = moe_batch
    assert ref["logits"].shape == (DECODE + 1, MOE_BATCH, _moe_cfg("repro_torch").vocab_size)
    for r, got in enumerate(port):
        _close(got["logits"], ref["logits"], 5e-4, 5e-4, f"rank {r} logits")
        np.testing.assert_array_equal(got["prefill"], got["logits"][0])
        np.testing.assert_array_equal(got["tokens"], ref["tokens"], err_msg=f"rank {r}")


# ---------------------------------------------------------------------------
# spec trees, in process

SPEC_MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
               ((2, 2), ("data", "model")), ((1, 2), ("data", "model"))]
ALL_ARCHS = ["internvl2-2b", "command-r-plus-104b", "minicpm-2b", "llama3-8b",
             "stablelm-1.6b", "musicgen-large", "zamba2-7b", "rwkv6-7b", "dbrx-132b",
             "qwen3-moe-235b-a22b"]


def _ref_specs(tree):
    import jax

    return {"/".join(str(p.key) for p in path): tuple(leaf.spec if hasattr(leaf, "spec")
                                                        else leaf.sharding.spec)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: hasattr(x, "spec") or hasattr(x, "sharding"))[0]}


def _port_specs(tree):
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix + (k,))
        else:
            sh = getattr(node, "sharding", node)
            out["/".join(prefix)] = tuple(sh.spec)

    walk(tree, ())
    return out


@pytest.mark.parametrize("mesh", SPEC_MESHES, ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_spec_trees_equal_reference(arch, mesh):
    import jax

    from repro import configs as jconfigs
    from repro.launch.mesh import make_abstract_mesh
    from repro.models import LogicalRules as JRules, api as japi
    from repro.models.common import SHAPES as JSHAPES
    from repro.serve import decode as jdecode
    from repro.train import step as jstep
    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api
    from repro_torch.models.common import SHAPES, LogicalRules
    from repro_torch.serve import decode
    from repro_torch.train import step
    from repro_torch.train.step import leaves

    jrules = JRules(make_abstract_mesh(*mesh))
    rules = LogicalRules(make_mesh(*mesh))
    jcfg, cfg = jconfigs.ARCHS[arch], configs.ARCHS[arch]
    assert _port_specs(api.param_shardings(cfg, rules)) == \
        _ref_specs(japi.param_shardings(jcfg, jrules))
    assert _port_specs(api.abstract_params(cfg, rules)) == \
        _ref_specs(japi.abstract_params(jcfg, jrules))
    jst, st = jstep.state_shardings(jcfg, jrules, True), step.state_shardings(cfg, rules, True)
    for name in ("params", "m", "v", "ef"):
        assert _port_specs(getattr(st, name)) == _ref_specs(getattr(jst, name)), name
    assert tuple(st.step.spec) == tuple(jst.step.spec) == ()
    ab, jab = step.abstract_state(cfg, rules, True), jstep.abstract_state(jcfg, jrules, True)
    for name in ("params", "m", "v", "ef"):
        assert _port_specs(getattr(ab, name)) == _ref_specs(getattr(jab, name)), name
        assert {p: tuple(t.shape) for p, t in leaves(getattr(ab, name))} == \
            {tuple(str(k.key) for k in p): tuple(t.shape) for p, t in
             jax.tree_util.tree_flatten_with_path(getattr(jab, name))[0]}
    for batch, seq in ((128, 32768), (1, 4096)):
        assert _port_specs(decode.cache_shardings(cfg, rules, batch, seq)) == \
            _ref_specs(jdecode.cache_shardings(jcfg, jrules, batch, seq)), (batch, seq)
        assert tuple(decode.serve_input_specs(cfg, batch, rules).sharding.spec) == \
            tuple(jdecode.serve_input_specs(jcfg, batch, jrules).sharding.spec)
    assert _port_specs(step.batch_specs(cfg, SHAPES["train_4k"], rules)) == \
        _ref_specs(jstep.batch_specs(jcfg, JSHAPES["train_4k"], jrules))


def test_minicpm_heads_fall_back_to_replication():
    from repro_torch import configs
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import api
    from repro_torch.models.common import LogicalRules

    sh = api.param_shardings(configs.ARCHS["minicpm-2b"], LogicalRules(make_production_mesh()))
    assert sh["layers"]["wq"].spec == (None, "data")          # 36 heads on 16: replicated
    assert sh["layers"]["w_gate"].spec == (None, "data", "model")


def test_local_slices_tile_each_leaf_once():
    """Every rank's block of a leaf, laid out by ``Sharding.slices`` over a
    2x2x2 mesh (a dim over ("pod", "data") row-major), covers it once."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import LogicalRules

    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    seen = torch.zeros(8, 6, 4, dtype=torch.int64)
    for c in np.ndindex(2, 2, 2):
        class Bound:                                # a mesh bound at coordinate c
            shape, axes, devices = mesh.shape, mesh.axes, mesh.devices
            sizes = mesh.sizes
            coords = dict(zip(mesh.axes, c))
        rules = LogicalRules(Bound())
        sh = rules.sharding("batch", None, "heads", dims=(8, 6, 4))
        assert sh.spec == (("pod", "data"), None, "model")
        seen[sh.slices((8, 6, 4))] += 1
        assert sh.local_shape((8, 6, 4)) == (2, 6, 2)
    assert (seen == 1).all()


@pytest.mark.parametrize("h,kv,tp", [(8, 2, 2), (8, 2, 8), (6, 2, 3), (4, 4, 2)])
def test_local_kv_gives_each_query_head_its_kv_head(h, kv, tp):
    """Each rank's query heads against ``local_kv``'s K/V heads give the
    rows of the whole attention for those heads: whole GQA groups, heads
    inside one group, and heads that straddle groups (6 heads of 3 a group
    over 3 ranks)."""
    from repro_torch.models.common import chunked_attention
    from repro_torch.models.transformer import local_kv

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 8, n, 16, generator=gen) for n in (h, kv, kv))
    whole = chunked_attention(q, k, v, 0, 4)
    hl = h // tp
    for rank in range(tp):
        h0 = rank * hl
        lk, lv = local_kv(k, v, h0, hl, h // kv)
        got = chunked_attention(q[:, :, h0:h0 + hl], lk, lv, 0, 4)
        torch.testing.assert_close(got, whole[:, :, h0:h0 + hl], rtol=1e-6, atol=1e-6)


def test_mesh_above_one_device_needs_a_process_group():
    from repro_torch.launch.mesh import DistMesh, make_mesh
    from repro_torch.models.common import LogicalRules

    with pytest.raises(ValueError, match="process group"):
        DistMesh(make_mesh((2, 1), ("data", "model")))
    rules = LogicalRules(make_mesh((2, 1), ("data", "model")))
    with pytest.raises(ValueError, match="bind it"):
        rules.coords
    one = LogicalRules(DistMesh(make_mesh((1, 1), ("data", "model"))))
    assert one.coords == {"data": 0, "model": 0} and one.mesh.member


def test_one_by_one_mesh_is_the_one_device_path():
    """With no process group a 1x1 mesh runs the one-device code: the
    train step's state and metrics equal the unsharded step's bit for bit."""
    from repro_torch import configs, train
    from repro_torch.launch.mesh import DistMesh, make_mesh
    from repro_torch.models.common import LogicalRules
    from repro_torch.train.step import leaves

    cfg = _cfg("repro_torch", "qwen3-moe-235b-a22b")
    rules = LogicalRules(DistMesh(make_mesh((1, 1), ("data", "model"))))
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)))}
    st = train.init_state(cfg, 0, "cpu")
    a, ma = train.make_train_step(cfg, _opt(train), ce_chunk=8)(st, batch)
    b, mb = train.make_train_step(cfg, _opt(train), ce_chunk=8, rules=rules)(st, batch)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for (p, x), (_, y) in zip(leaves(a.params), leaves(b.params)):
        assert torch.equal(x, y), p


# ---------------------------------------------------------------------------
# numbers on ranks against the reference at the same mesh


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _logits_close(arch, got, want, what):
    """The transformer families within rtol = atol = 5e-4
    (``tests/test_torch_lm.py``); rwkv6 and zamba2 within rtol 1e-4 and an
    atol of 2e-4 times the largest magnitude (``tests/test_torch_ssm.py``'s
    1e-4, doubled: see the module's docstring)."""
    if arch in ("rwkv6-7b", "zamba2-7b"):
        _close(got, want, 1e-4, 2e-4 * max(1.0, float(np.abs(want).max())), what)
    else:
        _close(got, want, 5e-4, 5e-4, what)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    n = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / n) if n else float(np.abs(a).max())


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS5)
def test_forward_logits_match_reference(results, arch, mesh):
    ref, port, _ = results
    k = _key(arch, mesh, "logits")
    _logits_close(arch, port[k], ref[k], k)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS5)
def test_train_steps_match_reference(results, arch, mesh):
    """The first step, from the reference's state: loss, grad norm and every
    leaf against the reference's at the same mesh.  The chained steps:
    losses against the reference's; each step against the port's
    one-device step from the same (whole) state and batch."""
    ref, port, init = results
    _close(port[_key(arch, mesh, "loss0")], ref[_key(arch, mesh, "loss0")], 1e-5, 0, "loss0")
    _close(port[_key(arch, mesh, "gnorm0")], ref[_key(arch, mesh, "gnorm0")], 2e-3, 0, "gnorm")
    trained = [k for k in ref if k.startswith(_key(arch, mesh, "trained/"))]
    assert trained and set(trained) <= set(port)
    for k in trained:
        p0 = init[f"{arch}|params|{k.split('trained/', 1)[1]}"]
        assert _rel(port[k] - p0, ref[k] - p0) <= 5e-2, k
    for i in range(1, STEPS):
        k = _key(arch, mesh, f"loss{i}")
        _close(port[k], ref[k], 2e-2, 0, k)
    if arch == "qwen3-moe-235b-a22b" and mesh[0] > 1 and mesh[1] > 1:
        return                  # the one-device dispatch is global: another drop set
    for i in range(STEPS):
        _close(port[_key(arch, mesh, f"loss{i}")], port[_key(arch, mesh, f"one/loss{i}")],
               1e-5, 0, f"loss{i}")
        _close(port[_key(arch, mesh, f"gnorm{i}")], port[_key(arch, mesh, f"one/gnorm{i}")],
               2e-3, 0, f"gnorm{i}")
        for k in [k for k in port if k.startswith(_key(arch, mesh, f"one{i}/"))]:
            assert port[k] <= (5e-2 if "/params/" in k else 2e-2), (k, float(port[k]))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", [a for a in ARCHS5 if a != "internvl2-2b"])
def test_prefill_and_decode_match_reference(results, arch, mesh):
    ref, port, _ = results
    k = _key(arch, mesh, "serve_logits")
    _logits_close(arch, port[k], ref[k], k)
    k = _key(arch, mesh, "serve_tokens")
    np.testing.assert_array_equal(port[k], ref[k], err_msg=k)


@pytest.mark.parametrize("arch", ONE_ARCHS)
def test_batch_of_one_serves_as_reference(results, arch):
    """One sequence on (2, 2): the batch is replicated over ``data``, and
    every rank's prefill and decode give the reference's logits and tokens
    (``ONE_REF_MESH``)."""
    ref, port, _ = results
    want = ONE_REF_MESH[arch]
    for r in range(ONE_MESH[0] * ONE_MESH[1]):
        k = _key(arch, ONE_MESH, f"one_logits{r}")
        assert port[k].shape[1] == 1
        _logits_close(arch, port[k], ref[_key(arch, want, "one_logits")], k)
        k = _key(arch, ONE_MESH, f"one_tokens{r}")
        np.testing.assert_array_equal(port[k], ref[_key(arch, want, "one_tokens")],
                                      err_msg=k)


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=lambda m: f"{m[0]}x{m[1]}")
def test_moe_ranks_keep_the_reference_pairs(results, mesh):
    """Each rank's kept (token, expert) pairs are the reference's for its
    experts and tokens; at (2, 2) the capacity is each data shard's, so
    the kept set differs from the global dispatch's."""
    ref, port, _ = results
    y = ref[_key("moe-probe", mesh, "y")].reshape(B * S, -1)
    e = 4
    want = {(int(t), int(x)) for t, x in zip(*np.nonzero(y[:, :e] > 0))}
    got = set()
    for r in range(mesh[0] * mesh[1]):
        pairs = port[_key("moe-probe", mesh, f"pairs{r}")]
        got |= {(int(t), int(x)) for t, x in pairs}
    assert got == want
    assert len(want) < B * S * 2                  # some pairs dropped
    if mesh == (2, 2):
        full = ref[_key("moe-probe", (1, 2), "y")].reshape(B * S, -1)
        assert want != {(int(t), int(x)) for t, x in zip(*np.nonzero(full[:, :e] > 0))}


if __name__ == "__main__":
    if sys.argv[1] == "--reference":
        reference_main(sys.argv[2], sys.argv[3], sys.argv[4])
    elif sys.argv[1] == "--moe-reference":
        moe_serve_reference(sys.argv[2], sys.argv[3])
