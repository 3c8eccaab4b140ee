"""The dry-run's collectives, counted from the sharded step on a stand-in
mesh (``launch.mesh.StandInMesh``), against real ranks and the reference.

- **(a) The stand-in records what real ranks send.**  4 gloo ranks run the
  sharded train step and decode step of reduced llama3-8b,
  qwen3-moe-235b-a22b, rwkv6-7b and zamba2-7b (bf16 compute, so 16-bit sums
  cross in fp32) at mesh (2, 2) on the CPU, each rank logging its
  collectives (``DistMesh.log``); the stand-in's log of the same program on
  ``meta`` (``dryrun.step_program``) equals each rank's, entry for entry:
  op, reduction, axis, group size, dtype on the wire, elements.
- **(b)** A 1 x 1 mesh records none, and counts the one-device step.
- **(c)** The 1-2-3 repeat fit equals the full count on (2, 2), the
  collectives included.
- **(d)** rwkv6's and zamba2's forward and train step on the stand-in at
  (1, 2) gather nothing over ``model``: no leaf split over ``model`` is
  made whole.
- **(e)** The port's total collective payload against the reference's
  (``lower_cell`` on 4 forced host devices at (2, 2), ``analyze_module``)
  on reduced configs: the ratio within ``PAYLOAD_RATIO``, stated from the
  readings on this tree, 0.864-1.475 (train 0.864-0.954, prefill
  0.915-1.070, decode 1.081-1.475).  The port runs 2.3-3.1 times the
  reference's count of collectives: one ZeRO-3 gather per leaf per use (a
  recomputed checkpoint gathers again), one sum per row-parallel product;
  XLA merges and schedules its own, and reshards with collective-permute
  and all-to-all, which the port's explicit layout never asks for.  Decode
  moves more in the port: each step gathers its leaves whole over ``data``
  where XLA keeps some products split.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import pytest
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import StandInMesh, make_mesh
from repro_torch.models import ShapeConfig
from repro_torch.models.common import LogicalRules

WORLD = 4
ARCHS4 = ["llama3-8b", "qwen3-moe-235b-a22b", "rwkv6-7b", "zamba2-7b"]
SHAPES = {"train": ShapeConfig("t", 32, 4, "train"), "decode": ShapeConfig("d", 32, 4, "decode")}
TIMEOUT = 300
REF_SHAPES = {"train": ShapeConfig("t", 128, 4, "train"),
              "prefill": ShapeConfig("p", 128, 4, "prefill"),
              "decode": ShapeConfig("d", 256, 4, "decode")}
PAYLOAD_RATIO = (0.6, 2.0)


def _cfg(arch):
    return dataclasses.replace(reduced(ARCHS[arch]), compute_dtype=torch.bfloat16,
                               attention_backend="chunked")


def _entries(log):
    return [[c.op, c.reduce, c.axis, c.group, str(c.dtype), c.numel] for c in log]


def _stand_in_log(arch, kind, mesh=(2, 2)):
    rules = LogicalRules(StandInMesh(make_mesh(mesh, ("data", "model"))))
    fn, args = dryrun.step_program(_cfg(arch), SHAPES[kind], rules)
    fn(*args)
    return rules.mesh.log


# --------------------------------------------------------------------------
# real ranks (spawned) and the reference (a subprocess)


def _rank(rank: int, init: str, out: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=WORLD)
    from repro_torch import train
    from repro_torch.launch.mesh import DistMesh
    from repro_torch.models import api
    from repro_torch.serve import decode

    res = {}
    gen = torch.Generator().manual_seed(0)
    for arch in ARCHS4:
        cfg = _cfg(arch)
        for kind, shape in SHAPES.items():
            rules = LogicalRules(DistMesh(make_mesh((2, 2), ("data", "model"))))
            b, s = shape.global_batch, shape.seq_len
            if kind == "train":
                state = train.init_state(cfg, 0, "cpu", rules=rules)
                sh = rules.sharding("batch", "seq", dims=(b, s))
                tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                       dtype=torch.int32)
                fn = train.make_train_step(cfg, train.OptimizerConfig(), rules=rules)
                args = (state, {"tokens": sh.local(tokens)})
            else:
                params = api.shard_params(api.init_params(cfg, 0, "cpu", master=True), cfg,
                                          rules)
                cache = decode.init_cache(cfg, b, s, "cpu", rules=rules)
                if "length" in cache:
                    cache["length"] = s - 1
                tokens = decode.serve_input_specs(cfg, b, rules).sharding.local(
                    torch.randint(0, cfg.vocab_size, (b,), generator=gen, dtype=torch.int32))
                fn = torch.no_grad()(decode.make_serve_step(cfg, rules))
                args = (params, cache, tokens)
            rules.mesh.log = []
            fn(*args)
            res[f"{arch}|{kind}"] = _entries(rules.mesh.log)
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def reference_main(out: str) -> None:
    import jax

    jax.devices()       # the backend first: the reference's dry-run sets XLA_FLAGS
    from repro.configs import ARCHS as REF_ARCHS
    from repro.configs import reduced as ref_reduced
    from repro.launch import dryrun as ref_dryrun
    from repro.launch.hlo_analysis import analyze_module
    from repro.launch.mesh import make_mesh as ref_make_mesh
    from repro.models.common import ShapeConfig as RefShape

    res = {}
    for arch in ARCHS4:
        for kind, shape in REF_SHAPES.items():
            lowered, hints = ref_dryrun.lower_cell(
                ref_reduced(REF_ARCHS[arch]), RefShape(*dataclasses.astuple(shape)),
                ref_make_mesh((2, 2), ("data", "model")))
            coll = analyze_module(lowered.compile().as_text(), scan_trip_hints=hints).collectives
            res[f"{arch}|{kind}"] = coll.as_dict()
    with open(out, "w") as f:
        json.dump(res, f)


@pytest.fixture(scope="module")
def runs():
    """(each rank's logs, the reference's collectives): the reference's
    subprocess and the ranks run at the same time."""
    from test_torch_sharding import spawn

    with tempfile.TemporaryDirectory() as tmp:
        ref_out = os.path.join(tmp, "reference.json")
        env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
                   JAX_PLATFORMS="cpu")
        log = open(os.path.join(tmp, "reference.log"), "w+")
        proc = subprocess.Popen([sys.executable, __file__, "--reference", ref_out], env=env,
                                stdout=log, stderr=subprocess.STDOUT)
        try:
            out = os.path.join(tmp, "ranks")
            spawn(_rank, WORLD, ("file://" + os.path.join(tmp, "rdzv"), out))
            ranks = []
            for r in range(WORLD):
                with open(f"{out}.{r}.json") as f:
                    ranks.append(json.load(f))
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
    return ranks, ref


# --------------------------------------------------------------------------
# (a) the stand-in against real ranks


@pytest.mark.parametrize("kind", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS4)
def test_stand_in_records_what_ranks_send(runs, arch, kind):
    ranks, _ = runs
    want = _entries(_stand_in_log(arch, kind))
    assert want
    for r, got in enumerate(ranks):
        assert got[f"{arch}|{kind}"] == want, f"rank {r}"
    # a 16-bit sum crosses in fp32; gathers keep the tensor's dtype
    sums = {e[4] for e in want if e[0] == "all-reduce" and e[1] == "sum"}
    assert "torch.bfloat16" not in sums


# --------------------------------------------------------------------------
# (b) one device, (c) the repeat fit


@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_one_device_mesh_records_none(kind):
    cfg = reduced(ARCHS["rwkv6-7b"])
    one = make_mesh((1, 1), ("data", "model"))
    stats = dryrun.count_cell(cfg, SHAPES[kind], mesh=one)
    assert stats.comm == {} and dryrun.collectives(stats)["count"] == 0
    whole = dryrun.count_cell(cfg, SHAPES[kind])
    assert (stats.flops, stats.bytes, stats.ops) == (whole.flops, whole.bytes, whole.ops)
    assert _stand_in_log("rwkv6-7b", kind, mesh=(1, 1)) == []


@pytest.mark.parametrize("kind", sorted(SHAPES))
@pytest.mark.parametrize("arch,layers", [("llama3-8b", 5), ("qwen3-moe-235b-a22b", 4),
                                         ("rwkv6-7b", 5), ("zamba2-7b", 13)])
def test_fit_equals_full_count_with_collectives(arch, layers, kind):
    cfg = dataclasses.replace(reduced(ARCHS[arch]), num_layers=layers)
    mesh = make_mesh((2, 2), ("data", "model"))
    assert len(dryrun.fit_tasks(cfg)) == 3
    full, fit = dryrun.count_step(cfg, SHAPES[kind], mesh=mesh), \
        dryrun.count_cell(cfg, SHAPES[kind], mesh=mesh)
    assert full.comm and fit.comm == full.comm
    assert (fit.flops, fit.bytes, fit.ops) == (full.flops, full.bytes, full.ops)
    assert dryrun.collectives(fit) == dryrun.collectives(full)


# --------------------------------------------------------------------------
# (d) nothing split over ``model`` gathered


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-7b"])
def test_ssm_families_gather_nothing_over_model(arch):
    from repro_torch.models import api

    cfg = _cfg(arch)
    rules = LogicalRules(StandInMesh(make_mesh((1, 2), ("data", "model"))))
    params = dryrun.local_meta(api.abstract_params(cfg, rules))
    sh = api.param_shardings(cfg, rules)["layers"]
    assert [k for k, v in sh.items() if any("model" in a for a in v.dims(len(v.spec)))]
    tokens = torch.zeros((4, 16), dtype=torch.int32, device="meta")
    with torch.no_grad():
        api.forward(params, tokens, cfg, rules=rules)
    fwd = list(rules.mesh.log)
    fn, args = dryrun.step_program(cfg, SHAPES["train"], rules)
    rules.mesh.log.clear()
    fn(*args)
    for what, log in (("forward", fwd), ("train step", rules.mesh.log)):
        assert log, what                          # the layers' sums cross
        gathers = [c for c in log if c.op == "all-gather" and c.axis == "model"]
        assert not gathers, (what, gathers)


# --------------------------------------------------------------------------
# (e) the total payload against the reference's HLO


@pytest.mark.parametrize("kind", sorted(REF_SHAPES))
@pytest.mark.parametrize("arch", ARCHS4)
def test_payload_against_reference(runs, arch, kind):
    _, ref = runs
    want = ref[f"{arch}|{kind}"]
    got = dryrun.collectives(dryrun.count_cell(reduced(ARCHS[arch]), REF_SHAPES[kind],
                                               mesh=make_mesh((2, 2), ("data", "model"))))
    ratio = got["payload_bytes"] / want["payload_bytes"]
    print(f"{arch} {kind}: payload {got['payload_bytes']:.6e} B in {got['count']} "
          f"collectives {got['by_type']}, reference {want['payload_bytes']:.6e} B in "
          f"{want['count']} {want['by_type']}: ratio {ratio:.3f}")
    assert PAYLOAD_RATIO[0] <= ratio <= PAYLOAD_RATIO[1]


if __name__ == "__main__":
    if sys.argv[1] == "--reference":
        reference_main(sys.argv[2])
