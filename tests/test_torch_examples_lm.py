"""The port's LM examples (``repro_torch.examples.serve_elastic`` and
``train_carbon_aware``) against the JAX package's, and the train step on a
batch that does not divide the batch axes, on the CPU.

(a) ``serve_elastic --tokens 8``: the reference example run from its file,
and the port's ``main`` on the reference's weights (``init_params``'s key-0
draw carried across with ``params_from_reference``): the shape line and
the first sequence's line printed equal, the greedy tokens equal to the
reference's serving of the same prompts, the prefill logits within rtol =
atol = 1e-4 (``tests/test_torch_lm.py``'s tolerance).

(b) ``train_carbon_aware`` at its defaults (tiny preset, 24 steps, max-dp
4, batch 4): the reference in a subprocess on 8 forced host devices, the
port on 4 gloo CPU ranks (``--host-devices 4``), then both again with
``--fault-at 6``.  The two trainers start from one step-0 checkpoint (the
port's seed-0 state in the shared ``leaves.npz`` format, written into each
``--ckpt``): the packages' generators draw different weights from one
seed.  Held: the printed model and plan lines equal; the plan, steps,
rescales and recoveries equal (each trainer counts the initial restore as
a recovery); the losses within rtol 2e-2 of the reference's (the
chained-step tolerance of ``tests/test_torch_train.py`` and
``tests/test_torch_elastic_mesh.py``).  Stragglers depend on wall time and
are not compared.  The losses are compared step by step (``_per_step``):
the reference's rollback reads the newest checkpoint without waiting for
the last save's writer thread (``src/repro/elastic/rescale.py:125``), so
where the fault falls right after a save (at step 5) it restores whichever
file the race leaves and re-takes one step or two, while the port waits for
the writer first.  The fault falls a step later, at 6, where one whole step
separates it from the save.  With ``--compress`` the reference example fails at its
first rescale: its ``CheckpointManager.restore`` cannot cast the bf16
error-feedback residual that ``np.load`` returns as raw 16-bit voids
(``src/repro/train/checkpoint.py:124``), which the test records.  The port
reads those bits as bf16, so its ``--fault-at 6 --compress`` run is held to
the same counts and to the reference's uncompressed faulted losses within
the same 2e-2 (int8 error-feedback compression of the gradient).

(c) The plan above trains its batch of 4 at k = 3.  Here one train step at
mesh (3, 1) through the port's ``make_train_step`` and ``PrefetchLoader``
(``batch_specs``: the batch replicated over ``data``, as the reference's
spec falls back) on 3 gloo ranks, from the reference's state, on reduced
stablelm-1.6b and reduced qwen3-moe-235b-a22b, against the reference's step
at (3, 1) and at (1, 1): loss rtol 1e-5, grad norm 2e-3, every leaf's
update within 5e-2 relative L2 (``tests/test_torch_sharding.py``'s
first-step tolerances); and against the port's one-device step on the same
state and batch: loss and grad norm rtol 1e-6.  Before the step ran a
replicated batch under ``replicating_batch``, the dense step already gave
these numbers (each rank's sum over three times the count, summed over
three ranks); the MoE layer's global dispatch gathered the three copies and
routed 12 rows at three times the capacity, 1.3e-4 off the loss and 0.9 %
off the grad norm.
"""
import contextlib
import dataclasses
import io
import json
import os
import runpy
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples")
TIMEOUT = 300
HOST_DEVICES, REF_DEVICES = 4, 8
RUNS = {"default": [], "faulted": ["--fault-at", "6"],
        "compressed": ["--fault-at", "6", "--compress"]}
# (c): a dense and an MoE reduced config, a batch of 4 at data 3
STEP_ARCHS = ("stablelm-1.6b", "qwen3-moe-235b-a22b")
B, S, K = 4, 32, 3
CE_CHUNK = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _opt(train):
    return train.OptimizerConfig(lr=3e-4, warmup_steps=1, total_steps=10)


def _step_cfg(pkg, arch):
    from importlib import import_module

    configs = import_module(f"{pkg}.configs")
    cfg = configs.reduced(configs.ARCHS[arch])
    return dataclasses.replace(cfg, attention_backend="xla") if pkg == "repro" else cfg


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# the reference, in a subprocess on forced host devices


def reference_main(root: str, out: str) -> None:
    import jax
    import jax.numpy as jnp

    from repro import elastic, train as jtrain
    from repro.launch.mesh import make_mesh
    from repro.models import LogicalRules

    got = []
    run = elastic.ElasticTrainer.run

    def keep(self, *a, **kw):
        res = run(self, *a, **kw)
        got.append(res)
        return res

    res = {}
    elastic.ElasticTrainer.run = keep
    for name, extra in RUNS.items():
        text = io.StringIO()
        sys.argv = ["train_carbon_aware.py", "--ckpt", os.path.join(root, f"ref-{name}")] + extra
        try:
            with contextlib.redirect_stdout(text):
                runpy.run_path(os.path.join(EXAMPLES, "train_carbon_aware.py"),
                               run_name="__main__")
        except ValueError as e:              # --compress: the bf16 residual's restore
            res[name] = dict(text=text.getvalue(), error=str(e))
            continue
        r = got[-1]
        res[name] = dict(text=text.getvalue(), losses=[float(x) for x in r["losses"]],
                         **{k: int(r[k]) for k in ("final_step", "rescales", "recoveries")})
    elastic.ElasticTrainer.run = run

    # (c) one step of the batch of 4 at (3, 1) and (1, 1)
    for arch in STEP_ARCHS:
        jcfg = _step_cfg("repro", arch)
        data = np.load(os.path.join(root, f"step_inputs-{arch}.npz"))
        params = {}
        for key in data.files:
            if key.startswith("params/"):
                node = params
                parts = key.split("/")[1:]
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = jnp.asarray(data[key])
        batch = {"tokens": jnp.asarray(data["tokens"])}
        for mesh in ((K, 1), (1, 1)):
            rules = LogicalRules(make_mesh(mesh, ("data", "model")))
            state = jtrain.TrainState(params=params, m=jax.tree.map(jnp.zeros_like, params),
                                      v=jax.tree.map(jnp.zeros_like, params),
                                      step=jnp.zeros((), jnp.int32))
            step = jax.jit(jtrain.make_train_step(jcfg, rules, _opt(jtrain),
                                                  ce_chunk=CE_CHUNK))
            new, met = step(state, batch)
            tag = f"{arch}-{mesh[0]}x{mesh[1]}"
            res[f"step/{tag}"] = dict(loss=float(met["loss"]),
                                      grad_norm=float(met["grad_norm"]))
            for path, leaf in jax.tree_util.tree_flatten_with_path(new.params)[0]:
                name = "/".join(str(p.key) for p in path)
                np.save(os.path.join(root, f"ref-trained-{tag}-{name.replace('/', '.')}.npy"),
                        np.asarray(leaf))
    with open(out, "w") as f:
        json.dump(res, f)


# ---------------------------------------------------------------------------
# the port


def _step_rank(rank: int, init: str, root: str) -> None:
    """(c) in one of K gloo ranks: the step at (K, 1) from the reference's
    state through ``PrefetchLoader`` with ``batch_specs``; rank 0 writes the
    metrics, the whole trained params and the one-device step's metrics."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=K)
    try:
        for arch in STEP_ARCHS:
            _step_arch(rank, root, arch)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _step_arch(rank: int, root: str, arch: str) -> None:
    """(c) for one config: its step at (K, 1), and rank 0's one-device step."""
    from repro_torch import train
    from repro_torch.launch.mesh import DistMesh, make_mesh
    from repro_torch.models.common import LogicalRules
    from repro_torch.train.step import gather_whole, leaves, unflatten

    cfg = _step_cfg("repro_torch", arch)
    data = np.load(os.path.join(root, f"step_inputs-{arch}.npz"))
    names = [k for k in data.files if k.startswith("params/")]
    tree = unflatten([tuple(k.split("/")[1:]) for k in names], [data[k] for k in names])
    zeros = unflatten([tuple(k.split("/")[1:]) for k in names],
                      [np.zeros_like(data[k]) for k in names])
    rules = LogicalRules(DistMesh(make_mesh((K, 1), ("data", "model"))))
    state = train.state_from_reference(cfg, {"params": tree, "m": zeros, "v": zeros,
                                             "step": 0}, device="cpu", rules=rules)
    whole = train.state_from_reference(cfg, {"params": tree, "m": zeros, "v": zeros,
                                             "step": 0}, device="cpu")
    src = train.SyntheticLM(train.DataConfig(batch=B, seq_len=S,
                                             vocab_size=cfg.vocab_size, seed=1))
    specs = train.batch_specs(cfg, dataclasses.make_dataclass(
        "Shape", ["global_batch", "seq_len"])(B, S), rules)
    loader = train.PrefetchLoader(src, device="cpu", model_cfg=cfg, sharding=specs)
    batch = next(loader)
    loader.close()
    new, met = train.make_train_step(cfg, _opt(train), ce_chunk=CE_CHUNK,
                                     rules=rules)(state, batch)
    shards = train.state_shardings(cfg, rules)
    trained = [(p, gather_whole(t, sh)) for (p, t), (_, sh)
               in zip(leaves(new.params), leaves(shards.params))]
    if rank == 0:
        _, one = train.make_train_step(cfg, _opt(train), ce_chunk=CE_CHUNK)(
            whole, {"tokens": torch.from_numpy(data["tokens"])})
        np.savez(os.path.join(root, f"port-step-{arch}.npz"),
                 rows=np.int64(batch["tokens"].shape[0]),
                 same_batch=np.bool_(np.array_equal(batch["tokens"].numpy(),
                                                    data["tokens"])),
                 loss=np.float64(met["loss"]), grad_norm=np.float64(met["grad_norm"]),
                 one_loss=np.float64(one["loss"]),
                 one_grad_norm=np.float64(one["grad_norm"]),
                 **{"trained/" + "/".join(p): t.numpy() for p, t in trained})


def _spawn(fn, nprocs: int, args: tuple, timeout: float = TIMEOUT) -> None:
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


def _inputs(root: str) -> None:
    """The two trainers' step-0 checkpoints (the port's seed-0 tiny state,
    with a zero residual for the compressed run) and (c)'s params and batch."""
    from repro_torch import train
    from repro_torch.examples.train_carbon_aware import PRESETS
    from repro_torch.train.step import leaves

    tiny = PRESETS["tiny"]
    for name in RUNS:
        compressed = "--compress" in RUNS[name]
        state = train.init_state(tiny, 0, "cpu", compression=compressed)
        # the reference's compressed run starts afresh, as the example does
        for who in ("port",) if compressed else ("ref", "port"):
            train.CheckpointManager(os.path.join(root, f"{who}-{name}")).save(
                0, state, blocking=True)
    for arch in STEP_ARCHS:
        cfg = _step_cfg("repro_torch", arch)
        params = train.init_state(cfg, 0, "cpu").params
        tokens = train.SyntheticLM(train.DataConfig(batch=B, seq_len=S, vocab_size=cfg.vocab_size,
                                                    seed=1)).batch_at(0)
        np.savez(os.path.join(root, f"step_inputs-{arch}.npz"), tokens=tokens,
                 **{"params/" + "/".join(p): t.numpy() for p, t in leaves(params)})


@pytest.fixture(scope="module")
def trained():
    from repro_torch.examples import train_carbon_aware

    with tempfile.TemporaryDirectory() as root:
        _inputs(root)
        ref_out = os.path.join(root, "reference.json")
        env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={REF_DEVICES}",
                   JAX_PLATFORMS="cpu")
        log = open(os.path.join(root, "reference.log"), "w+")
        proc = subprocess.Popen([sys.executable, __file__, "--reference", root, ref_out],
                                env=env, stdout=log, stderr=subprocess.STDOUT)
        port = {}
        try:
            for name, extra in RUNS.items():
                text = io.StringIO()
                with contextlib.redirect_stdout(text):
                    out = train_carbon_aware.main(
                        ["--host-devices", str(HOST_DEVICES), "--device", "cpu", "--ckpt",
                         os.path.join(root, f"port-{name}")] + extra)
                port[name] = dict(out, text=text.getvalue())
            _spawn(_step_rank, K, ("file://" + os.path.join(root, "rdzv"), root))
            step = {arch: dict(np.load(os.path.join(root, f"port-step-{arch}.npz")))
                    for arch in STEP_ARCHS}
            proc.wait(timeout=TIMEOUT)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.seek(0)
            text = log.read()
            log.close()
        assert proc.returncode == 0, text[-3000:]
        with open(ref_out) as f:
            ref = json.load(f)
        for arch in STEP_ARCHS:
            for tag in (f"{arch}-{K}x1", f"{arch}-1x1"):
                ref[f"trained/{tag}"] = {
                    f[len(f"ref-trained-{tag}-"):-4].replace(".", "/"):
                    np.load(os.path.join(root, f))
                    for f in os.listdir(root) if f.startswith(f"ref-trained-{tag}-")}
        init = {arch: dict(np.load(os.path.join(root, f"step_inputs-{arch}.npz")))
                for arch in STEP_ARCHS}
    return ref, port, step, init


@pytest.mark.parametrize("name", ["default", "faulted"])
def test_trainer_matches_reference(trained, name):
    ref, port, _, _ = trained
    r, p = ref[name], port[name]
    assert p["text"].splitlines()[:2] == r["text"].splitlines()[:2]
    assert p["plan"] == [0, 1, 2, 3, 3, 3, 3, 3, 3, 3, 3, 2]
    for k in ("final_step", "rescales", "recoveries"):
        assert p[k] == r[k], (name, k)
    np.testing.assert_allclose(_per_step(p, RUNS[name]), _per_step(r, RUNS[name]),
                               rtol=2e-2, err_msg=name)


def _per_step(run: dict, argv: list) -> list[float]:
    """A run's loss at each step 0 .. final_step - 1.  ``losses`` holds one
    entry a step taken, in order; after a fault at step f the trainer
    re-takes the steps from the checkpoint it restored, so the entries past
    the first f are the steps from final_step - (len - f) on, and a re-taken
    step's loss replaces the first one (from the same restored state, it is
    the same)."""
    losses, n = run["losses"], run["final_step"]
    if "--fault-at" not in argv:
        assert len(losses) == n
        return list(losses)
    f = int(argv[argv.index("--fault-at") + 1])
    start = n - (len(losses) - f)
    assert 0 <= start <= f, (start, f, len(losses))
    return list(losses[:start]) + list(losses[f:])


def test_compressed_trainer_against_the_reference(trained):
    """The reference example stops at its first rescale with ``--compress``;
    the port's compressed run keeps the faulted run's counts, and its losses
    stay within 2e-2 of the reference's uncompressed faulted run."""
    ref, port, _, _ = trained
    assert "No cast function available" in ref["compressed"]["error"]
    p, r = port["compressed"], ref["faulted"]
    for k in ("final_step", "rescales", "recoveries"):
        assert p[k] == r[k], k
    np.testing.assert_allclose(_per_step(p, RUNS["compressed"]), _per_step(r, RUNS["faulted"]),
                               rtol=2e-2)


def test_trainer_counts_follow_the_plan(trained):
    """22 steps over eleven hours of 2 (k 0 pauses the first), three
    rescales (1 -> 2 -> 3 -> 2); the initial restore is a recovery, and the
    fault at step 6 one more, which rolls back to the checkpoint after step
    4 and takes step 5 again."""
    _, port, _, _ = trained
    assert [port[n]["final_step"] for n in RUNS] == [22, 22, 22]
    assert [port[n]["rescales"] for n in RUNS] == [3, 3, 3]
    assert [port[n]["recoveries"] for n in RUNS] == [1, 2, 2]
    assert [len(port[n]["losses"]) for n in RUNS] == [22, 23, 23]
    for name in RUNS:
        losses = port[name]["losses"]
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
        lines = port[name]["text"].splitlines()
        assert lines[3].startswith("steps 22  rescales 3  recoveries ")
        assert lines[4] == (f"loss: first {losses[0]:.3f} -> last {losses[-1]:.3f} "
                            f"(improved: True)")


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_step_on_an_undivided_batch_matches_reference(trained, arch):
    """(c): the batch of 4 replicated over data 3 trains to the reference's
    loss, gradient norm and update, at (3, 1) and at (1, 1)."""
    ref, _, steps, inits = trained
    step, init = steps[arch], inits[arch]
    assert int(step["rows"]) == B and bool(step["same_batch"])   # every rank: all of it
    for tag in (f"{arch}-{K}x1", f"{arch}-1x1"):
        want = ref[f"step/{tag}"]
        np.testing.assert_allclose(step["loss"], want["loss"], rtol=1e-5, err_msg=tag)
        np.testing.assert_allclose(step["grad_norm"], want["grad_norm"], rtol=2e-3, err_msg=tag)
        leaves = ref[f"trained/{tag}"]
        assert leaves and {f"trained/{k}" for k in leaves} <= set(step)
        for k, leaf in leaves.items():
            p0 = init[f"params/{k}"]
            assert _rel(step[f"trained/{k}"] - p0, leaf - p0) <= 5e-2, (tag, k)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_step_on_an_undivided_batch_is_the_global_mean(trained, arch):
    """The replicated batch counted once: the sharded step's loss and
    gradient norm are the one-device step's on the same state and batch
    (the MoE layer routing the 4 rows, not 12)."""
    step = trained[2][arch]
    np.testing.assert_allclose(step["loss"], step["one_loss"], rtol=1e-6)
    np.testing.assert_allclose(step["grad_norm"], step["one_grad_norm"], rtol=1e-6)


# ---------------------------------------------------------------------------
# (a) serve_elastic


@pytest.fixture(scope="module")
def served():
    import jax
    import jax.numpy as jnp

    from repro.configs import ARCHS as JARCHS, reduced as jreduced
    from repro.launch.mesh import make_mesh as jmake_mesh
    from repro.models import LogicalRules as JRules, init_params as jinit_params
    from repro.serve import make_prefill as jmake_prefill, make_serve_step as jmake_step
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.examples import serve_elastic
    from repro_torch.models import api

    argv, text = sys.argv, io.StringIO()
    sys.argv = ["serve_elastic.py", "--tokens", "8"]
    try:
        with contextlib.redirect_stdout(text):
            runpy.run_path(os.path.join(EXAMPLES, "serve_elastic.py"), run_name="__main__")
    finally:
        sys.argv = argv
    ref_text = text.getvalue()

    # the reference example's computation, kept: its weights, prompts, tokens
    jcfg = jreduced(JARCHS["llama3-8b"])
    rules = JRules(jmake_mesh((1, 1), ("data", "model")))
    jparams = jinit_params(jcfg, jax.random.key(0))
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab_size, (4, 32))
    logits, cache = jax.jit(jmake_prefill(jcfg, rules, 40))(
        jparams, jnp.asarray(prompts, jnp.int32))
    first = np.asarray(logits)
    step = jax.jit(jmake_step(jcfg, rules))
    tok, gen = jnp.argmax(logits, -1).astype(jnp.int32), []
    for _ in range(8):
        gen.append(np.asarray(tok))
        logits, cache = step(jparams, cache, tok)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)

    cfg = reduced(ARCHS["llama3-8b"])
    params = api.params_from_reference(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    text = io.StringIO()
    real = serve_elastic.init_params
    serve_elastic.init_params = lambda c, seed, device: params
    try:
        with contextlib.redirect_stdout(text):
            out = serve_elastic.main(["--tokens", "8", "--device", "cpu"])
    finally:
        serve_elastic.init_params = real
    return ref_text, text.getvalue(), out, np.stack(gen, axis=1), first


def test_serve_elastic_matches_reference(served):
    ref_text, port_text, out, tokens, first = served
    ref_lines, port_lines = ref_text.splitlines(), port_text.splitlines()
    assert len(port_lines) == len(ref_lines) == 3
    assert port_lines[0] == ref_lines[0] == "arch llama3-8b-smoke batch 4 prompt 32 -> 8 new tokens"
    assert port_lines[2] == ref_lines[2]                     # the first sequence
    np.testing.assert_array_equal(out["tokens"], tokens)
    np.testing.assert_allclose(out["prefill_logits"].numpy(), first, rtol=1e-4, atol=1e-4)


def test_serve_elastic_launches_nothing_on_the_cpu(served):
    _, _, out, _, _ = served
    assert out["prefill_flash_launches"] == out["decode_flash_launches"] == 0
    assert out["cfg"].compute_dtype == torch.float32 and out["cfg"].resolved_head_dim == 32


if __name__ == "__main__":
    if sys.argv[1] == "--reference":
        reference_main(sys.argv[2], sys.argv[3])
