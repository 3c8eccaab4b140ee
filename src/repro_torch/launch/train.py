"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``
(the counterpart of ``repro/launch/train.py``).

Runs the training loop of any assigned architecture through
``ElasticTrainer`` on a mesh (``--dp``, ``--tp``): ``--reduced`` for the
small same-family config.  Resumes from ``--ckpt`` when it holds a
checkpoint; ``--compress`` adds int8 gradient compression with error
feedback.  Runs on the card unless ``--device cpu``.

The ranks are the caller's:

- one process: a world of one, ``--dp`` and ``--tp`` 1;
- ``torchrun --nproc-per-node N -m repro_torch.launch.train ...``: the
  process group is read from torchrun's environment, ``nccl`` on cards
  (one card a rank), ``gloo`` with ``--device cpu``;
- ``--host-devices N`` (the reference's forced host devices): N CPU ranks
  over gloo, spawned here, with ``--device cpu``.

``--dp`` times ``--tp`` above the ranks raises ``ValueError``, as the
reference's mesh does.  The printed lines are the reference's.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="spawn N CPU ranks over gloo (the reference's forced host devices)")
    ap.add_argument("--device", default="cuda")
    return ap


def _config(args):
    from repro_torch.configs import ARCHS, reduced

    cfg = ARCHS[args.arch]
    return reduced(cfg) if args.reduced else cfg


def _train(args) -> tuple[dict, float]:
    """This rank's trainer; returns (its result, wall seconds)."""
    from repro_torch.elastic import ElasticTrainer, RescalePlan, make_compressor
    from repro_torch.train import DataConfig, OptimizerConfig, SyntheticLM

    cfg = _config(args)
    data = SyntheticLM(DataConfig(batch=args.batch, seq_len=args.seq,
                                  vocab_size=cfg.vocab_size, seed=0))
    opt = OptimizerConfig(
        lr=args.lr, warmup_steps=max(args.steps // 10, 1),
        total_steps=args.steps,
        schedule="wsd" if cfg.lr_schedule == "wsd" else "cosine")
    ckpt = args.ckpt or os.path.join(tempfile.gettempdir(), f"repro_torch_train_{cfg.name}")
    trainer = ElasticTrainer(
        cfg, data, opt, ckpt, model_axis=args.tp, device=args.device,
        compression=make_compressor("int8") if args.compress else None)
    t0 = time.time()
    out = trainer.run([RescalePlan(k=args.dp, steps=args.steps)],
                      checkpoint_every=args.checkpoint_every)
    return out, time.time() - t0


def _summary(out: dict, dt: float) -> str:
    losses = out["losses"]
    return (f"{len(losses)} steps in {dt:.1f}s "
            f"({dt / max(len(losses), 1):.2f}s/step); "
            f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
            f"resumed_from_ckpt={out['recoveries'] > 0}")


def _host_rank(rank: int, run, argv: list, n: int, init: str, result: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=n)
    try:
        out = run(argv)
        if rank == 0:
            with open(result, "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_host_ranks(run, argv: list, n: int, device: str):
    """``run(argv)`` in ``n`` spawned CPU ranks over gloo (the reference's
    forced host devices); returns rank 0's result, which ``run`` (a
    module-level function) returns as JSON data."""
    import torch.multiprocessing as mp

    if device != "cpu":
        raise ValueError("--host-devices runs CPU ranks: pass --device cpu")
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        result = os.path.join(tmp, "result.json")
        mp.start_processes(_host_rank, args=(run, argv, n, init, result),
                           nprocs=n, join=True, start_method="spawn")
        with open(result) as f:
            return json.load(f)


def join_ranks(args) -> int:
    """This process's rank.  Under torchrun (``WORLD_SIZE`` above 1) it
    joins the process group first: ``nccl`` on cards, one a rank
    (``args.device`` becomes ``cuda:LOCAL_RANK``), ``gloo`` with ``--device
    cpu``.  In a process group the caller initialised it keeps that group;
    alone it is rank 0."""
    import torch
    import torch.distributed as dist

    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        if args.device == "cpu":
            dist.init_process_group("gloo")
        else:
            local = int(os.environ.get("LOCAL_RANK", "0"))
            torch.cuda.set_device(local)
            args.device = f"cuda:{local}"
            dist.init_process_group("nccl")
    return dist.get_rank() if dist.is_initialized() else 0


def _run(argv: list) -> dict:
    out, dt = _train(_parser().parse_args(argv))
    return {"out": out, "dt": dt}


def main(argv=None) -> dict:
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)

    from repro_torch.models import param_count

    cfg = _config(args)
    rank = 0
    if args.host_devices:
        print(f"arch {cfg.name}: {param_count(cfg) / 1e6:.1f}M params, "
              f"dp={args.dp} tp={args.tp}", flush=True)
        got = spawn_host_ranks(_run, argv, args.host_devices, args.device)
        out, dt = got["out"], got["dt"]
    else:
        rank = join_ranks(args)
        if rank == 0:
            print(f"arch {cfg.name}: {param_count(cfg) / 1e6:.1f}M params, "
                  f"dp={args.dp} tp={args.tp}", flush=True)
        out, dt = _train(args)
    if rank == 0:
        print(_summary(out, dt), flush=True)
    return out


if __name__ == "__main__":
    main()
