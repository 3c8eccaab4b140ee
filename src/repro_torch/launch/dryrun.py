"""Dry-run: count every (architecture x input shape) cell's step on the
``meta`` device and record one device's FLOPs, bytes, collectives and
roofline terms (the counterpart of ``repro/launch/dryrun.py``, which lowers
and compiles each cell on 512 placeholder TPU devices and reads the
partitioned per-device HLO).

Usage (no card needed: ``meta`` tensors hold shapes and no storage):
  PYTHONPATH=src python -m repro_torch.launch.dryrun                    # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch rwkv6-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod        # 2x16x16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --out DIR

Outputs one JSON per cell, ``{out}/{arch}__{shape}__{mesh}.json``, in the
reference's fields, so ``core/profiles.py::terms_from_dryrun`` reads it.
The default ``--out`` is ``results/dryrun_torch``: the reference's
``elasticity="tpu"`` reads ``results/dryrun_opt``, and no cell of this
package lands there unless a caller names it.

What a cell counts (``count_cell``, as ``lower_cell`` lowers), on the
production mesh: rank 0's program of the sharded step, run under
``LogicalRules`` on a ``launch.mesh.StandInMesh`` with the rank's blocks
of the state, params and cache and its slice of the batch:

- train: one step of ``train/step.py::make_train_step(cfg, rules=)``
  (forward, chunked cross-entropy, ``torch.autograd.grad`` with every
  checkpoint recomputed, the gradient's reduction, AdamW);
- prefill: the forward over the prompt and the last position's logits,
  as the reference's ``lower_cell`` counts a prefill (not ``make_prefill``,
  which for rwkv6 and zamba2 replays the prompt one decode step a token);
- decode: ``make_serve_step(cfg, rules)``, one new token per sequence
  against a ``seq_len`` cache.

Its FLOPs and bytes are that rank's (``OpCounter``), and its
``collectives`` every collective the rank's program asks for, recorded by
the stand-in (``repro_torch/distributed.py``) in the reference's fields:
payload (each collective's output bytes), wire bytes (ring factors: an
all-reduce 2(n-1)/n, an all-gather (n-1)/n of a group of n), by type, count.
A sum of 16-bit floats crosses in fp32 in the port, where XLA's HLO would
carry bf16.  A one-device mesh counts the whole step with no collective.
Attention is counted on the ``"chunked"`` backend, the counterpart of the
reference's ``"xla"`` default that its dry-run lowers, with
``_adapted_cfg``'s chunk.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ARCHS, LONG_CONTEXT_ARCHS
from repro_torch.launch.mesh import Mesh, StandInMesh, make_production_mesh
from repro_torch.launch.op_analysis import OpStats, count
from repro_torch.models import api
from repro_torch.models.common import SHAPES, LogicalRules, ModelConfig, ShapeConfig
from repro_torch.models import rwkv6, zamba2
from repro_torch.serve import decode
from repro_torch.serve.decode import make_serve_step
from repro_torch.train import step as train_step
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.step import TrainState, leaves, make_train_step, state_template, unflatten

META = torch.device("meta")

# One H100 SXM at its full 700 W limit (NVIDIA's H100 data sheet): dense
# bf16 on the tensor cores and HBM3 bandwidth, the rates PERF.md's bounds
# use.  The link: every collective is charged at the inter-node rate, since
# a ring over the 16 devices of a mesh axis spans two 8-GPU nodes: one
# 400 Gb/s ConnectX-7 port per GPU on a DGX H100 (NVIDIA DGX H100 data
# sheet), 50e9 bytes/s each way.
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 50e9
RATES = {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW, "link_bw": LINK_BW}
RATES_SOURCE = ("NVIDIA H100 SXM data sheet (989 TFLOP/s dense bf16, 3.35 TB/s HBM3); "
                "NVIDIA DGX H100 data sheet (one 400 Gb/s ConnectX-7 port per GPU)")
DEFAULT_OUT = "results/dryrun_torch"


def runnable(arch: str, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return False          # full-attention archs skip long_500k
    return True


def _adapted_cfg(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    # bigger attention chunks for long prefill keep the chunk loop short
    if shape.seq_len >= 32_768:
        return dataclasses.replace(cfg, attention_chunk=2048)
    return cfg


# --------------------------------------------------------------------------
# meta templates (the reference's ShapeDtypeStruct stand-ins)


def abstract_params(cfg: ModelConfig) -> dict:
    """Every leaf of ``param_shapes`` in ``param_dtype`` on ``meta``."""
    shapes = leaves(api.module_for(cfg).param_shapes(cfg))
    return unflatten([p for p, _ in shapes],
                     [torch.empty(s, dtype=cfg.param_dtype, device=META) for _, s in shapes])


def abstract_state(cfg: ModelConfig, compression: bool = False) -> TrainState:
    """The train state on ``meta`` (``train/step.py::state_template``)."""
    return state_template(cfg, compression)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """One global training (or prefill) batch on ``meta``: ``tokens`` (B,
    seq_len - prefix_len) int32, and ``prefix_embeds`` (B, prefix_len, d) in
    ``compute_dtype`` for a prefix config."""
    b, s = shape.global_batch, shape.seq_len
    out = {"tokens": torch.empty((b, s - cfg.prefix_len), dtype=torch.int32, device=META)}
    if cfg.prefix_len:
        out["prefix_embeds"] = torch.empty((b, cfg.prefix_len, cfg.d_model),
                                           dtype=cfg.compute_dtype, device=META)
    return out


def serve_input_specs(cfg: ModelConfig, batch: int) -> torch.Tensor:
    return torch.empty((batch,), dtype=torch.int32, device=META)


def abstract_cache(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """The serving cache on ``meta``, its ``length`` a 0-d int32 tensor as
    the reference's (``count_cell`` sets the int the decode step takes)."""
    if cfg.family == "ssm":
        return rwkv6.init_cache(cfg, batch, META)
    if cfg.family == "hybrid":
        cache = zamba2.init_cache(cfg, batch, max_seq, META)
    else:
        shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
        cache = {"k": torch.empty(shape, dtype=cfg.compute_dtype, device=META),
                 "v": torch.empty(shape, dtype=cfg.compute_dtype, device=META)}
    cache["length"] = torch.empty((), dtype=torch.int32, device=META)
    return cache


def input_specs(arch: str, shape_name: str):
    """Meta stand-ins for every input of the (arch x shape) cell: the
    training batch for train and prefill shapes, (tokens, cache) for
    decode; global, unsharded."""
    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    if shape.kind in ("train", "prefill"):
        return batch_specs(cfg, shape)
    return {
        "tokens": serve_input_specs(cfg, shape.global_batch),
        "cache": abstract_cache(cfg, shape.global_batch, shape.seq_len),
    }


# --------------------------------------------------------------------------
# counting


def local_meta(tree):
    """A rank's blocks of ``meta`` stand-ins (whole shapes, each with its
    ``.sharding``): of a tensor, or of each tensor of a nested dict."""
    if isinstance(tree, dict):
        return {k: local_meta(v) for k, v in tree.items()}
    return torch.empty(tree.sharding.local_shape(tuple(tree.shape)), dtype=tree.dtype,
                       device=META)


def step_program(cfg: ModelConfig, shape: ShapeConfig, rules: LogicalRules | None = None):
    """(fn, args): the cell's step at ``cfg`` (as ``count_step`` adapts it)
    and its ``meta`` inputs; with ``rules`` the sharded step and the rank's
    blocks of its inputs and batch slice."""
    if shape.kind == "train":
        opt = OptimizerConfig(schedule="wsd" if cfg.lr_schedule == "wsd" else "cosine")
        if rules is None:
            return make_train_step(cfg, opt), (abstract_state(cfg), batch_specs(cfg, shape))
        st = train_step.abstract_state(cfg, rules)
        state = TrainState(params=local_meta(st.params), m=local_meta(st.m),
                           v=local_meta(st.v), step=0)
        return (make_train_step(cfg, opt, rules=rules),
                (state, local_meta(train_step.batch_specs(cfg, shape, rules))))
    params = (abstract_params(cfg) if rules is None
              else local_meta(api.abstract_params(cfg, rules)))
    if shape.kind == "prefill":
        @torch.no_grad()
        def prefill(params, batch):
            x, head = api.forward(params, batch["tokens"], cfg, rules=rules,
                                  return_hidden=True, prefix_embeds=batch.get("prefix_embeds"))
            return x[:, -1] @ head.to(x.dtype)

        batch = (batch_specs(cfg, shape) if rules is None
                 else local_meta(train_step.batch_specs(cfg, shape, rules)))
        return prefill, (params, batch)
    # decode: one new token against a seq_len context, the cache filled up
    # to its last position (the chunked attention reads every position of
    # the cache whatever its length, as the reference's)
    b = shape.global_batch
    if rules is None:
        cache, tokens = abstract_cache(cfg, b, shape.seq_len), serve_input_specs(cfg, b)
    else:
        cache = decode.init_cache(cfg, b, shape.seq_len, device="meta", rules=rules)
        tokens = local_meta(decode.serve_input_specs(cfg, b, rules))
    if "length" in cache:
        cache["length"] = shape.seq_len - 1
    return torch.no_grad()(make_serve_step(cfg, rules)), (params, cache, tokens)


def count_step(cfg: ModelConfig, shape: ShapeConfig, attention: str = "chunked",
               mesh: Mesh | None = None) -> OpStats:
    """The op counts of one step of the cell (see the module docstring) at
    ``cfg``'s depth, on ``meta``: with a ``mesh`` of more than one device,
    rank 0's program of the sharded step and its collectives
    (``OpStats.comm``); else the whole step.  ``attention="flash"`` counts
    the step as the card runs it: each ``gqa_flash`` forward and backward
    one kernel of the work ``flash_attention.kernel_work`` gives."""
    if attention not in ("chunked", "flash"):
        raise ValueError(f"attention {attention!r}: use 'chunked' or 'flash'")
    cfg = dataclasses.replace(_adapted_cfg(cfg, shape), attention_backend=attention)
    rules = None if mesh is None or mesh.devices == 1 else LogicalRules(StandInMesh(mesh))
    fn, args = step_program(cfg, shape, rules)
    _, stats = count(fn, *args)
    if rules is not None:
        stats.add_collectives(rules.mesh.log)
    return stats


#: The repeat counts a cell is counted at before ``count_cell`` extrapolates.
FIT_REPEATS = (1, 2, 3)


def repeats(cfg: ModelConfig) -> tuple[int, object]:
    """(n, at): how many times the cell's repeated unit occurs, and
    ``at(k)``, the config with k of them.  The unit is a layer; for the
    hybrid family, a group of ``shared_attn_every`` Mamba layers and the
    shared block, the remainder layers kept."""
    if cfg.family == "hybrid":
        p = cfg.shared_attn_every
        groups, rest = divmod(cfg.num_layers, p)
        return groups, lambda k: dataclasses.replace(cfg, num_layers=k * p + rest)
    return cfg.num_layers, lambda k: dataclasses.replace(cfg, num_layers=k)


def fit_tasks(cfg: ModelConfig) -> list[ModelConfig]:
    """The configs ``count_cell`` counts for ``cfg``: itself when its repeat
    count is at most 3, else the same model at 1, 2 and 3 repeats."""
    n, at = repeats(cfg)
    if n <= len(FIT_REPEATS):
        return [cfg]
    return [at(k) for k in FIT_REPEATS]


def extrapolate(parts: list[OpStats], n: int) -> OpStats:
    """The counts at n repeats from the counts at 1, 2 and 3 (Lagrange).

    Exact when every count is a polynomial of degree at most 2 in the
    repeat count: each repeat runs the same ops on the same shapes (linear),
    and the gradient of a leaf stacked over the repeats arrives one repeat
    at a time as a tensor of the whole stack, the accumulation of those
    contributions growing with the stack (quadratic).  The tests hold it
    equal to the full count on reduced configs."""
    if len(parts) == 1:
        return parts[0]
    w = [(n - 2) * (n - 3), -2 * (n - 1) * (n - 3), (n - 1) * (n - 2)]
    return OpStats.combine(parts, w, divisor=2)


def count_cell(cfg: ModelConfig, shape: ShapeConfig, attention: str = "chunked",
               mesh: Mesh | None = None) -> OpStats:
    """The op counts of one step of the cell (``count_step`` on ``mesh``):
    each config of ``fit_tasks`` counted, then ``extrapolate``d to
    ``cfg``'s depth, the collectives with the rest."""
    return extrapolate([count_step(c, shape, attention, mesh) for c in fit_tasks(cfg)],
                       repeats(cfg)[0])


def _timed_count(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh | None
                 ) -> tuple[OpStats, float]:
    t0 = time.perf_counter()
    stats = count_step(cfg, shape, mesh=mesh)
    return stats, time.perf_counter() - t0


def count_cells(cells: list[tuple[ModelConfig, ShapeConfig]], workers: int = 1,
                mesh: Mesh | None = None) -> list[tuple[OpStats, float]]:
    """``count_cell`` of every (cfg, shape) on ``mesh``, with each cell's
    counting seconds (the sum of its fit configs'); with ``workers`` > 1 the
    fit configs are counted in that many spawned processes (each imports the
    caller's ``__main__`` again, so a script keeps its work under ``if
    __name__ == "__main__"``)."""
    tasks = [(c, shape, mesh) for cfg, shape in cells for c in fit_tasks(cfg)]
    if workers > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        # the longest first, so the pool's last tasks are short ones
        order = sorted(range(len(tasks)), key=lambda i: -tasks[i][0].num_layers)
        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as ex:
            futures = {i: ex.submit(_timed_count, *tasks[i]) for i in order}
            done = [futures[i].result() for i in range(len(tasks))]
    else:
        done = [_timed_count(*task) for task in tasks]
    out, i = [], 0
    for cfg, _ in cells:
        k = len(fit_tasks(cfg))
        parts = done[i:i + k]
        i += k
        out.append((extrapolate([p for p, _ in parts], repeats(cfg)[0]),
                    sum(s for _, s in parts)))
    return out


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS: 6·N·D for train (forward and backward), 2·N·D for
    inference, N the active parameters, D the tokens of the step."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch          # one new token per sequence
    return 2.0 * n_active * tokens


#: Bytes on the wire per payload byte of a ring collective over a group of
#: n (the reference's ``hlo_analysis`` wire-cost model).
RING = {"all-reduce": lambda n: 2.0 * (n - 1) / n, "all-gather": lambda n: (n - 1) / n}


def collectives(stats: OpStats) -> dict:
    """A count's collectives in the reference's fields (``hlo_analysis``'s
    ``CollectiveStats``): payload bytes, ring-weighted wire bytes, payload
    by type, count; and each (type, group size)'s [count, payload]."""
    payload = wire = 0.0
    by_type: dict = {}
    count_ = 0
    for key, (n, nbytes) in sorted(stats.comm.items()):
        op, group = key.rsplit("/", 1)
        payload += nbytes
        wire += nbytes * RING[op](int(group))
        by_type[op] = by_type.get(op, 0.0) + nbytes
        count_ += n
    return {"payload_bytes": payload, "wire_bytes": wire, "by_type": by_type,
            "count": count_, "by_group": {k: list(v) for k, v in sorted(stats.comm.items())}}


def cell_record(arch: str, cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                stats: OpStats, count_s: float) -> dict:
    """One cell's JSON record from one device's counts (``count_cell`` on
    ``mesh``; the reference's fields)."""
    chips = mesh.devices
    coll = collectives(stats)
    flops_per_dev, bytes_per_dev = stats.flops, stats.bytes
    compute_s = flops_per_dev / PEAK_FLOPS
    memory_s = bytes_per_dev / HBM_BW
    collective_s = coll["wire_bytes"] / LINK_BW
    model_flops_per_dev = model_flops(cfg, shape) / chips
    mesh_name = "x".join(str(n) for n in mesh.shape)
    return {
        "arch": arch,
        "shape": shape.name,
        "kind": shape.kind,
        "mesh": mesh_name,
        "chips": chips,
        "count_s": count_s,
        "ops": stats.ops,
        "hlo_stats": {"flops": flops_per_dev, "hbm_bytes": bytes_per_dev},
        "counted": {"flops": stats.flops, "bytes": stats.bytes,
                    "split": (f"rank 0's program of the sharded step on the {mesh_name} mesh"
                              if chips > 1 else "the whole step on one device")},
        "collectives": coll,
        "rates": dict(RATES),
        "rates_source": RATES_SOURCE,
        "roofline": {
            "compute_s": compute_s,
            "memory_s": memory_s,
            "collective_s": collective_s,
            "dominant": max(
                [("compute", compute_s), ("memory", memory_s),
                 ("collective", collective_s)], key=lambda kv: kv[1])[0],
            "model_flops_per_dev": model_flops_per_dev,
            "useful_flops_ratio": (model_flops_per_dev / flops_per_dev
                                   if flops_per_dev else None),
        },
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
    }


def analyze_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    """One cell's record on the production mesh."""
    cfg, shape = ARCHS[arch], SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    [(stats, count_s)] = count_cells([(cfg, shape)], mesh=mesh)
    return cell_record(arch, cfg, shape, mesh, stats, count_s)


def cell_path(out: str, arch: str, shape_name: str, mesh_name: str) -> str:
    return os.path.join(out, f"{arch}__{shape_name}__{mesh_name}.json")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)

    failures = []
    for multi_pod in meshes:
        mesh_name = "2x16x16" if multi_pod else "16x16"
        for arch in archs:
            for shape_name in shapes:
                if not runnable(arch, SHAPES[shape_name]):
                    print(f"SKIP {arch} x {shape_name} (full attention at 500k)")
                    continue
                tag = f"{arch}__{shape_name}__{mesh_name}"
                path = cell_path(args.out, arch, shape_name, mesh_name)
                if args.skip_existing and os.path.exists(path):
                    print(f"CACHED {tag}")
                    continue
                try:
                    res = analyze_cell(arch, shape_name, multi_pod)
                    with open(path, "w") as f:
                        json.dump(res, f, indent=1)
                    r = res["roofline"]
                    print(f"OK {tag}: counted in {res['count_s']:.2f} s, "
                          f"{res['hlo_stats']['flops']:.4e} FLOPs "
                          f"{res['hlo_stats']['hbm_bytes']:.4e} B per device, "
                          f"compute {r['compute_s'] * 1e3:.1f}ms "
                          f"memory {r['memory_s'] * 1e3:.1f}ms "
                          f"coll {r['collective_s'] * 1e3:.1f}ms "
                          f"-> {r['dominant']}", flush=True)
                except Exception as e:  # noqa: BLE001 — record and continue
                    failures.append((tag, repr(e)))
                    print(f"FAIL {tag}: {e}", flush=True)
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(" ", tag, err)
        raise SystemExit(1)
    print("\nall dry-run cells passed")


if __name__ == "__main__":
    main()
