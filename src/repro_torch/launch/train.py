"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``
(the counterpart of ``repro/launch/train.py``).

Runs the training loop of any assigned architecture through
``ElasticTrainer``: ``--reduced`` for the small same-family config.
Resumes from ``--ckpt`` when it holds a checkpoint; ``--compress`` adds
int8 gradient compression with error feedback.  Runs on the card unless
``--device cpu``.  ``--dp`` above the visible devices and ``--tp`` above 1
raise, as in ``ElasticTrainer``; ``--host-devices`` (an XLA flag of the
reference) has no counterpart and raises when set.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time


def main(argv=None) -> dict:
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
                    help="the reference's forced host device count: raises when set")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.host_devices:
        raise NotImplementedError("--host-devices sets an XLA flag of the JAX package; "
                                  "the port has no counterpart")

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.elastic import ElasticTrainer, RescalePlan, make_compressor
    from repro_torch.models import param_count
    from repro_torch.train import DataConfig, OptimizerConfig, SyntheticLM

    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduced(cfg)
    print(f"arch {cfg.name}: {param_count(cfg) / 1e6:.1f}M params, "
          f"dp={args.dp} tp={args.tp}", flush=True)

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
    dt = time.time() - t0
    losses = out["losses"]
    print(f"{len(losses)} steps in {dt:.1f}s "
          f"({dt / max(len(losses), 1):.2f}s/step); "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"resumed_from_ckpt={trainer.recoveries > 0}")
    return out


if __name__ == "__main__":
    main()
