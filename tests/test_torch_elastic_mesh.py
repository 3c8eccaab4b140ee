"""The port's ``ElasticTrainer`` on a mesh of ranks against the JAX
package's on forced host devices, on the CPU.

Both trainers start from one checkpoint (the port's ``init_state`` from
seed 0, written in the shared ``leaves.npz`` format) and run the plan
k = 1, 2, 1 (two steps each) at ``model_axis`` 1 and 2 on reduced
stablelm-1.6b, with an injected fault at step 4 (rolled back to the last
checkpoint) and a checkpoint every two steps; then a second trainer on the
same directory resumes for two steps at k = 2.  The reference runs in a
subprocess on 4 forced host devices; the port in 4 gloo ranks (one thread
each), where a phase's mesh takes the first k * model_axis ranks and the
others sit it out.

Held: the losses of the plan and of the resumed run within rtol 2e-2 of
the reference's (the one-device test's tolerance for chained steps,
``tests/test_torch_train.py``; reading on this tree: within 6e-7), the
same step counts, rescales and recoveries, and every rank returning the
first rank's dict.
"""
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

WORLD = 4
ARCH = "stablelm-1.6b"
PLAN = [(1, 2), (2, 2), (1, 2)]
RESUME = [(2, 2)]
FAULT, EVERY, B, S = 4, 2, 4, 16
TIMEOUT = 150


def _data(pkg):
    from importlib import import_module

    configs = import_module(f"{pkg}.configs")
    train = import_module(f"{pkg}.train")
    cfg = configs.reduced(configs.ARCHS[ARCH])
    if pkg == "repro":
        import dataclasses

        cfg = dataclasses.replace(cfg, attention_backend="xla")
    data = train.SyntheticLM(train.DataConfig(batch=B, seq_len=S, vocab_size=cfg.vocab_size,
                                              seed=3))
    return cfg, data, train.OptimizerConfig(total_steps=60)


def _runs(pkg, elastic, ckpt, model_axis, **kw):
    cfg, data, opt = _data(pkg)
    first = elastic.ElasticTrainer(cfg, data, opt, ckpt, model_axis=model_axis, **kw)
    a = first.run([elastic.RescalePlan(k=k, steps=n) for k, n in PLAN],
                  checkpoint_every=EVERY, fault_at=FAULT)
    second = elastic.ElasticTrainer(cfg, data, opt, ckpt, model_axis=model_axis, **kw)
    b = second.run([elastic.RescalePlan(k=k, steps=n) for k, n in RESUME])
    return a, b


def reference_main(root: str, out: str) -> None:
    from repro import elastic

    res = {}
    for m in (1, 2):
        a, b = _runs("repro", elastic, os.path.join(root, f"ref{m}"), m)
        for name, r in (("plan", a), ("resume", b)):
            res[f"{m}|{name}|losses"] = np.asarray(r["losses"], np.float64)
            for k in ("final_step", "rescales", "recoveries"):
                res[f"{m}|{name}|{k}"] = np.int64(r[k])
    np.savez(out, **res)


def _port_rank(rank: int, init: str, root: str, out: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=WORLD)
    from repro_torch import elastic

    res = {}
    for m in (1, 2):
        a, b = _runs("repro_torch", elastic, os.path.join(root, f"port{m}"), m, device="cpu")
        for name, r in (("plan", a), ("resume", b)):
            res[f"{m}|{name}|losses"] = np.asarray(r["losses"], np.float64)
            for k in ("final_step", "rescales", "recoveries"):
                res[f"{m}|{name}|{k}"] = np.int64(r[k])
    np.savez(f"{out}.{rank}.npz", **res)
    dist.barrier()
    dist.destroy_process_group()


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


def _initial_checkpoints(root: str) -> None:
    """Step 0 of both trainers: the port's initial state, written once per
    trainer directory."""
    from repro_torch import train

    cfg, _, _ = _data("repro_torch")
    state = train.init_state(cfg, 0, "cpu")
    for name in ("ref1", "ref2", "port1", "port2"):
        train.CheckpointManager(os.path.join(root, name)).save(0, state, blocking=True)


@pytest.fixture(scope="module")
def results():
    with tempfile.TemporaryDirectory() as root:
        _initial_checkpoints(root)
        ref_out = os.path.join(root, "reference.npz")
        env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
                   JAX_PLATFORMS="cpu")
        log = open(os.path.join(root, "reference.log"), "w+")
        proc = subprocess.Popen([sys.executable, __file__, "--reference", root, ref_out],
                                env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            out = os.path.join(root, "port")
            spawn(_port_rank, WORLD, ("file://" + os.path.join(root, "rdzv"), root, out))
            proc.wait(timeout=TIMEOUT)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.seek(0)
            text = log.read()
            log.close()
        assert proc.returncode == 0, text[-3000:]
        ref = dict(np.load(ref_out))
        ranks = [dict(np.load(f"{out}.{r}.npz")) for r in range(WORLD)]
    return ref, ranks


@pytest.mark.parametrize("model_axis", [1, 2])
@pytest.mark.parametrize("run", ["plan", "resume"])
def test_trainer_matches_reference(results, model_axis, run):
    ref, ranks = results
    key = f"{model_axis}|{run}|"
    np.testing.assert_allclose(ranks[0][key + "losses"], ref[key + "losses"], rtol=2e-2,
                               err_msg=key)
    for k in ("final_step", "rescales", "recoveries"):
        assert int(ranks[0][key + k]) == int(ref[key + k]), (key, k)


@pytest.mark.parametrize("model_axis", [1, 2])
def test_every_rank_returns_the_same_result(results, model_axis):
    _, ranks = results
    for r in ranks[1:]:
        for k in ranks[0]:
            if k.startswith(f"{model_axis}|"):
                np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


def test_plan_counts(results):
    """Six steps, two rescales (1 -> 2 -> 1), the initial restore and the
    fault's rollback; the resumed run ends two steps later."""
    _, ranks = results
    for m in (1, 2):
        r = ranks[0]
        assert int(r[f"{m}|plan|final_step"]) == 6
        assert len(r[f"{m}|plan|losses"]) == 6
        assert int(r[f"{m}|plan|rescales"]) == 2
        assert int(r[f"{m}|plan|recoveries"]) == 2
        assert int(r[f"{m}|resume|final_step"]) == 8
        assert np.isfinite(r[f"{m}|plan|losses"]).all()


if __name__ == "__main__":
    if sys.argv[1] == "--reference":
        reference_main(sys.argv[2], sys.argv[3])
