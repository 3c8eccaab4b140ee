"""The port's checkpoint manager, gradient compression, elastic trainer and
launcher against the JAX package's, on the CPU.

Compression is the reference's float32 expression step by step (round half
to even in both, the same top-k threshold), so the decompressed gradients
and the bf16 residuals equal the reference's bit for bit, over a chain of
steps that feeds each residual back.  A checkpoint directory written by
either package restores into the other, leaf for leaf, bit for bit, and
the ``leaves.npz`` keys, their order, dtypes and ``meta.json`` are the
reference's.  The trainer's cases are those of ``tests/test_elastic.py``.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro import elastic as jelastic
from repro import train as jtrain
from repro_torch import configs, elastic, train
from repro_torch.elastic import rescale
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import train as launch_train
from repro_torch.train.step import leaves


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small tensor ops: with one intra-op thread they
    run as fast serially and do not thrash when test workers share cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# compression


def _grad_trees(seed, n=4):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        g = {"a": rng.normal(size=(8, 8)).astype(np.float32),
             "b": {"c": (rng.normal(size=(33,)) * 1e-3).astype(np.float32),
                   "d": np.zeros((5,), np.float32)}}
        g["a"][0, :3] = (-0.0, 0.5, -2.5)            # signed zero, ties of round
        out.append(g)
    return out


def _bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return t.numpy().view(np.uint8)
    return np.asarray(t).view(np.uint8)


@pytest.mark.parametrize("kind,ratio", [("int8", 0.05), ("topk", 0.25), ("topk", 1e-4)])
def test_compressors_equal_reference_bit_for_bit(kind, ratio):
    jcomp = jelastic.make_compressor(kind, ratio=ratio)
    comp = elastic.make_compressor(kind, ratio=ratio)
    jef = ef = None
    for g in _grad_trees(0):
        jsent, jef = jcomp(jax.tree.map(jnp.asarray, g), jef)
        sent, ef = comp(jax.tree.map(torch.from_numpy, g), ef)
        for got, want in ((sent, jsent), (ef, jef)):
            w = dict(leaves(jax.tree.map(np.asarray, want)))
            for path, t in leaves(got):
                assert np.array_equal(_bits(t), _bits(w[path])), (kind, path)
                assert str(w[path].dtype) == str(t.dtype).split(".")[1], path


def test_unknown_compressor_raises():
    with pytest.raises(ValueError):
        elastic.make_compressor("fp4")({"g": torch.ones(3)}, None)


# ---------------------------------------------------------------------------
# checkpoints


def _state(seed=0):
    cfg = configs.reduced(configs.ARCHS["stablelm-1.6b"])
    st = train.init_state(cfg, seed=seed, device="cpu", compression=True)
    st.step = 7
    return cfg, st


class TestCheckpointManager:
    def test_roundtrip(self, tmp_path):
        cm = train.CheckpointManager(str(tmp_path))
        tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.tensor(3.5)}}
        cm.save(7, tree, blocking=True)
        assert cm.latest_step() == 7
        out = cm.restore(tree)
        assert torch.equal(out["a"], tree["a"]) and float(out["b"]["c"]) == 3.5

    def test_state_roundtrip_bit_for_bit(self, tmp_path):
        cfg, st = _state()
        cm = train.CheckpointManager(str(tmp_path))
        cm.save(st.step, st, blocking=True)
        out = cm.restore(train.state_template(cfg, compression=True), device="cpu")
        assert out.step == 7
        for tree in ("params", "m", "v", "ef"):
            for (_, a), (_, b) in zip(leaves(getattr(out, tree)), leaves(getattr(st, tree))):
                assert a.dtype == b.dtype and torch.equal(a, b)

    def test_keep_policy_gc(self, tmp_path):
        cm = train.CheckpointManager(str(tmp_path), keep=2)
        for s in [1, 2, 3, 4]:
            cm.save(s, {"x": torch.zeros(3)}, blocking=True)
        assert cm.steps() == [3, 4]

    def test_partial_write_ignored(self, tmp_path):
        cm = train.CheckpointManager(str(tmp_path))
        cm.save(5, {"x": torch.ones(2)}, blocking=True)
        os.makedirs(tmp_path / "tmp.step_000000009")   # crashed writer
        cm2 = train.CheckpointManager(str(tmp_path))
        assert cm2.latest_step() == 5
        assert not os.path.exists(tmp_path / "tmp.step_000000009")

    def test_async_save_then_wait(self, tmp_path):
        cm = train.CheckpointManager(str(tmp_path))
        _, st = _state()
        cm.save(1, st)                  # returns before the write ends
        cm.save(2, st)                  # waits for the first writer
        cm.wait()
        assert cm.steps() == [1, 2]
        assert not any(n.startswith("tmp.") for n in os.listdir(tmp_path))

    def test_files_are_the_references(self, tmp_path):
        """The same state through both managers: the same keys in the same
        order, dtypes, bytes and meta.json; each restores into the other."""
        cfg, st = _state(seed=3)
        jstate = jtrain.TrainState(
            params=jax.tree.map(lambda t: jnp.asarray(t.numpy()), st.params),
            m=jax.tree.map(lambda t: jnp.asarray(t.numpy()), st.m),
            v=jax.tree.map(lambda t: jnp.asarray(t.numpy()), st.v),
            step=jnp.int32(st.step),
            ef=jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16),
                            st.ef))
        jdir, pdir = tmp_path / "jax", tmp_path / "torch"
        jtrain.CheckpointManager(str(jdir)).save(7, jstate, blocking=True)
        train.CheckpointManager(str(pdir)).save(7, st, blocking=True)
        jz = np.load(jdir / "step_000000007" / "leaves.npz")
        pz = np.load(pdir / "step_000000007" / "leaves.npz")
        assert list(jz.keys()) == list(pz.keys())
        assert "params__layers__wq" in jz.keys() and "step" in jz.keys()
        for key in jz.keys():
            assert jz[key].dtype == pz[key].dtype and jz[key].shape == pz[key].shape, key
            assert jz[key].tobytes() == pz[key].tobytes(), key
        meta = [json.loads((d / "step_000000007" / "meta.json").read_text())
                for d in (jdir, pdir)]
        assert meta[0] == meta[1]
        # the reference's checkpoint restores into the port ...
        out = train.CheckpointManager(str(jdir)).restore(
            train.state_template(cfg, compression=True), device="cpu")
        for tree in ("params", "m", "v", "ef"):
            assert all(torch.equal(a, b) for (_, a), (_, b) in
                       zip(leaves(getattr(out, tree)), leaves(getattr(st, tree))))
        # ... and the port's into the reference (its params, moments, step)
        template = jax.eval_shape(lambda: jtrain.TrainState(
            params=jstate.params, m=jstate.m, v=jstate.v, step=jstate.step))
        back = jtrain.CheckpointManager(str(pdir)).restore(template)
        assert int(back.step) == 7
        for (_, a), (_, b) in zip(leaves(jax.tree.map(np.asarray, back.params)),
                                  leaves(st.params)):
            assert np.array_equal(a, b.numpy())

    def test_state_from_reference_checkpoint(self, tmp_path):
        """A state the reference initialised and saved trains on in the port."""
        jcfg = jconfigs.reduced(jconfigs.ARCHS["stablelm-1.6b"])
        cfg = configs.reduced(configs.ARCHS["stablelm-1.6b"])
        jstate = jtrain.init_state(jcfg, jax.random.key(1))
        jtrain.CheckpointManager(str(tmp_path)).save(0, jstate, blocking=True)
        out = train.CheckpointManager(str(tmp_path)).restore(train.state_template(cfg),
                                                             device="cpu")
        direct = train.state_from_reference(cfg, {
            "params": jax.tree.map(np.asarray, jstate.params),
            "m": jax.tree.map(np.asarray, jstate.m), "v": jax.tree.map(np.asarray, jstate.v),
            "step": np.asarray(jstate.step)}, device="cpu")
        assert out.step == direct.step == 0
        assert all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(leaves(out.params), leaves(direct.params)))


# ---------------------------------------------------------------------------
# the elastic trainer


def _two_rank_trainers(rank: int, init: str, root: str, out: str) -> None:
    """Two gloo ranks: a plan that rescales 1 -> 2, the unbroken k = 1 run
    it is compared with, and a run at model_axis 2."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
    cfg = configs.reduced(configs.ARCHS["stablelm-1.6b"])
    data = train.SyntheticLM(train.DataConfig(batch=4, seq_len=32,
                                              vocab_size=cfg.vocab_size, seed=3))

    def mk(name, **kw):
        return elastic.ElasticTrainer(cfg, data, train.OptimizerConfig(total_steps=60),
                                      os.path.join(root, name), device="cpu", **kw)

    res = {"rescaled": mk("a").run([elastic.RescalePlan(k=1, steps=2),
                                    elastic.RescalePlan(k=2, steps=2)]),
           "whole": mk("b").run([elastic.RescalePlan(k=1, steps=4)]),
           "axis2": mk("c", model_axis=2).run([elastic.RescalePlan(k=1, steps=2)]),
           "restored": _sharded_checkpoints(rank, cfg, root)}
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def _sharded_checkpoints(rank, cfg, root):
    """A state held as blocks over (1, 2) and over (2, 1) saved through the
    shardings, and each file restored under the other mesh: whether each
    rank's restored blocks equal that mesh's blocks of the state."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import DistMesh, make_mesh
    from repro_torch.models.common import LogicalRules

    if rank == 0:
        train.CheckpointManager(os.path.join(root, "whole")).save(
            0, train.init_state(cfg, 0, "cpu"), blocking=True)
    meshes = {s: LogicalRules(DistMesh(make_mesh(s, ("data", "model"))))
              for s in ((1, 2), (2, 1))}
    out = {}
    for shape, rules in meshes.items():
        ckpt = train.CheckpointManager(os.path.join(root, f"sharded{shape[0]}{shape[1]}"))
        ckpt.save(0, train.init_state(cfg, 0, "cpu", rules=rules), blocking=True,
                  shardings=train.state_shardings(cfg, rules))
        dist.barrier()
        other = meshes[shape[::-1]]
        back = ckpt.restore(train.state_template(cfg), device="cpu",
                            shardings=train.state_shardings(cfg, other))
        want = train.init_state(cfg, 0, "cpu", rules=other)
        out[f"{shape[0]}x{shape[1]}"] = all(
            torch.equal(a, b) for tree in ("params", "m", "v")
            for (_, a), (_, b) in zip(leaves(getattr(back, tree)), leaves(getattr(want, tree))))
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    from test_torch_elastic_mesh import spawn

    root = str(tmp_path_factory.mktemp("two_ranks"))
    out = os.path.join(root, "out.json")
    spawn(_two_rank_trainers, 2, ("file://" + os.path.join(root, "rdzv"), root, out),
          timeout=120)
    with open(out) as f:
        return dict(json.load(f), root=root)


class TestElasticTrainer:
    def _mk(self, tmp_path, **kw):
        cfg = configs.reduced(configs.ARCHS["stablelm-1.6b"])
        data = train.SyntheticLM(train.DataConfig(batch=4, seq_len=32,
                                                  vocab_size=cfg.vocab_size, seed=3))
        return elastic.ElasticTrainer(cfg, data, train.OptimizerConfig(total_steps=60),
                                      str(tmp_path / "ckpt"), device="cpu", **kw)

    def test_elastic_plan_rescales(self, tmp_path):
        tr = self._mk(tmp_path)
        out = tr.run([elastic.RescalePlan(k=1, steps=3), elastic.RescalePlan(k=0, steps=5),
                      elastic.RescalePlan(k=1, steps=3)], checkpoint_every=2)
        assert out["final_step"] == 6
        assert len(out["losses"]) == 6
        assert np.isfinite(out["losses"]).all()

    def test_fault_recovery(self, tmp_path):
        tr = self._mk(tmp_path)
        out = tr.run([elastic.RescalePlan(k=1, steps=6)], checkpoint_every=2, fault_at=4)
        assert out["recoveries"] >= 1
        assert out["final_step"] == 6          # work completed despite fault

    def test_resume_from_checkpoint(self, tmp_path):
        tr = self._mk(tmp_path)
        first = tr.run([elastic.RescalePlan(k=1, steps=4)], checkpoint_every=2)
        tr2 = self._mk(tmp_path)
        out = tr2.run([elastic.RescalePlan(k=1, steps=2)])
        assert out["final_step"] == 6
        assert tr2.recoveries >= 1
        # the resumed run continues the first run's trajectory exactly
        whole = self._mk(tmp_path / "whole").run([elastic.RescalePlan(k=1, steps=6)])
        assert first["losses"] + out["losses"] == whole["losses"]

    def test_compression_trains(self, tmp_path):
        tr = self._mk(tmp_path, compression=elastic.make_compressor("int8"))
        out = tr.run([elastic.RescalePlan(k=1, steps=4)])
        assert np.isfinite(out["losses"]).all()

    def test_rescale_goes_through_the_checkpoint(self, two_ranks):
        """A change of k within the world (two gloo ranks) checkpoints, builds
        the new mesh and restores under its shardings; the trajectory is the
        unbroken k = 1 run's: the k = 2 steps split the batch over the two
        ranks, so their losses are the same global mean summed in another
        order (within rtol 1e-6)."""
        out, whole = two_ranks["rescaled"], two_ranks["whole"]
        assert out["rescales"] == 1 and out["final_step"] == 4
        assert out["losses"][:2] == whole["losses"][:2]
        np.testing.assert_allclose(out["losses"], whole["losses"], rtol=1e-6)

    @pytest.mark.parametrize("checkpointed", [False, True])
    def test_failure_that_rollback_does_not_cure_raises(self, tmp_path, monkeypatch,
                                                        checkpointed):
        """A backward that fails at every launch (as a kernel's failed launch
        raises RuntimeError) is retried ``MAX_RETRIES`` times, then raised,
        with or without a checkpoint to roll back to."""
        tr = self._mk(tmp_path)
        if checkpointed:
            tr.run([elastic.RescalePlan(k=1, steps=3)], checkpoint_every=2)
        calls = []

        def failed_launch(*args):
            calls.append(1)
            raise RuntimeError("the bwd_dq kernel of gqa_flash's backward failed: "
                               "cudaError_t 719")

        monkeypatch.setattr(fa, "gqa_flash_bwd_plain", failed_launch)
        with pytest.raises(RuntimeError, match="bwd_dq kernel"):
            tr.run([elastic.RescalePlan(k=1, steps=3)], checkpoint_every=2)
        assert len(calls) == rescale.MAX_RETRIES + 1
        assert tr.recoveries == rescale.MAX_RETRIES

    def test_sharded_checkpoints_are_the_reference_files_and_restore_across_meshes(
            self, two_ranks):
        """A checkpoint saved from blocks over (1, 2) or (2, 1) is the same
        ``leaves.npz`` as the unsharded save, key for key and bit for bit,
        and restores under the other mesh to that mesh's blocks."""
        root = two_ranks["root"]
        with np.load(os.path.join(root, "whole", "step_000000000", "leaves.npz")) as whole:
            for name in ("sharded12", "sharded21"):
                path = os.path.join(root, name, "step_000000000", "leaves.npz")
                with np.load(path) as got:
                    assert list(got.keys()) == list(whole.keys())
                    for key in whole.keys():
                        a, b = got[key], whole[key]
                        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (name, key)
        assert two_ranks["restored"] == {"1x2": True, "2x1": True}

    def test_scale_and_axis_limits(self, tmp_path, two_ranks):
        """k * model_axis above the world raises, as the reference's mesh
        does; model_axis 2 on a world of two ranks trains."""
        with pytest.raises(ValueError, match="devices"):
            self._mk(tmp_path).run([elastic.RescalePlan(k=2, steps=1)])
        with pytest.raises(ValueError, match="devices"):
            self._mk(tmp_path, model_axis=2).run([elastic.RescalePlan(k=1, steps=1)])
        axis2, whole = two_ranks["axis2"], two_ranks["whole"]
        assert axis2["final_step"] == 2
        np.testing.assert_allclose(axis2["losses"], whole["losses"][:2], rtol=1e-5)


def test_prefix_config_trainer_raises_in_both_packages(tmp_path):
    """The reference's trainer builds batches from tokens alone, so a prefix
    config's loss slices past its hidden states: it raises in both."""
    jcfg = jconfigs.reduced(jconfigs.ARCHS["internvl2-2b"])
    cfg = configs.reduced(configs.ARCHS["internvl2-2b"])
    kw = dict(batch=2, seq_len=32, vocab_size=cfg.vocab_size, seed=0)
    jtr = jelastic.ElasticTrainer(jcfg, jtrain.SyntheticLM(jtrain.DataConfig(**kw)),
                                  jtrain.OptimizerConfig(), str(tmp_path / "j"))
    with pytest.raises(TypeError, match="reshape"):
        jtr.run([jelastic.RescalePlan(k=1, steps=1)])
    tr = elastic.ElasticTrainer(cfg, train.SyntheticLM(train.DataConfig(**kw)),
                                train.OptimizerConfig(), str(tmp_path / "t"), device="cpu")
    with pytest.raises(ValueError, match="prefix_embeds"):
        tr.run([elastic.RescalePlan(k=1, steps=1)])


# ---------------------------------------------------------------------------
# the launcher


def test_launcher_trains_and_resumes(tmp_path, capsys):
    args = ["--arch", "stablelm-1.6b", "--reduced", "--steps", "3", "--batch", "2",
            "--seq", "16", "--ckpt", str(tmp_path / "c"), "--device", "cpu"]
    out = launch_train.main(args)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "arch stablelm-1.6b-smoke: 0.6M params, dp=1 tp=1"
    assert lines[1].startswith("3 steps in ") and lines[1].endswith("resumed_from_ckpt=False")
    assert out["final_step"] == 3
    again = launch_train.main(args)
    assert again["final_step"] == 6
    assert capsys.readouterr().out.strip().endswith("resumed_from_ckpt=True")
    comp = launch_train.main(args[:-4] + ["--ckpt", str(tmp_path / "z"), "--compress",
                                          "--device", "cpu"])
    assert np.isfinite(comp["losses"]).all()


@pytest.mark.parametrize("flag,err", [(["--tp", "2"], ValueError),
                                      (["--dp", "2"], ValueError),
                                      (["--host-devices", "2"], ValueError)])
def test_launcher_refuses_what_it_cannot_run(tmp_path, flag, err):
    """A mesh above the ranks (one process: a world of one), and host
    devices on the card (they are CPU ranks)."""
    device = "cuda" if "--host-devices" in flag else "cpu"
    with pytest.raises(err):
        launch_train.main(["--arch", "stablelm-1.6b", "--reduced", "--steps", "1",
                           "--ckpt", str(tmp_path), "--device", device] + flag)


def test_launcher_host_devices_trains_and_resumes(tmp_path):
    """``--host-devices 4 --dp 2 --tp 2``: four gloo CPU ranks train on a
    2 x 2 mesh, then a second launch resumes from the checkpoint.  Each
    launch runs as a user runs it, in its own process, within 120 s."""
    import subprocess
    import sys

    ckpt = str(tmp_path / "c")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "stablelm-1.6b",
           "--reduced", "--steps", "3", "--batch", "2", "--seq", "16", "--ckpt", ckpt,
           "--device", "cpu", "--host-devices", "4", "--dp", "2", "--tp", "2"]
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([src, os.environ.get("PYTHONPATH", "")]))
    runs = [subprocess.run(cmd, capture_output=True, text=True, timeout=120, env=env)
            for _ in range(2)]
    for run in runs:
        assert run.returncode == 0, run.stderr[-2000:]
    first, again = (run.stdout.strip().splitlines() for run in runs)
    assert first[0] == again[0] == "arch stablelm-1.6b-smoke: 0.6M params, dp=2 tp=2"
    assert first[1].startswith("3 steps in ") and first[1].endswith("resumed_from_ckpt=False")
    assert again[1].startswith("3 steps in ") and again[1].endswith("resumed_from_ckpt=True")
    assert train.CheckpointManager(ckpt).latest_step() == 6
