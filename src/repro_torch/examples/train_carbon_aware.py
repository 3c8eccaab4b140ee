"""End-to-end driver: carbon-aware elastic training of an LM.

CarbonFlex decides, hour by hour, how many data-parallel slices the
training job gets (scale up at low carbon intensity, pause at high); the
ElasticTrainer executes the plan with checkpoint/restart rescaling and
fault recovery — the full paper loop (provision -> schedule -> scancel ->
resume) on a real PyTorch model.

Defaults train the tiny preset (CI); ``--preset 100m`` is a ~100M-parameter
llama-style model, ``--steps`` bounds wall time.  The data-parallel ranks
are the caller's, as ``repro_torch.launch.train``'s:

- one process: a world of one (``--max-dp 1``; a plan that asks for more
  raises);
- ``torchrun --nproc-per-node N -m repro_torch.examples.train_carbon_aware``:
  the process group from torchrun's environment, ``nccl`` on cards (one
  card a rank), ``gloo`` with ``--device cpu``; or a process group the
  caller has already initialised;
- ``--host-devices N`` (the counterpart of the reference's forced host
  devices): N CPU ranks over gloo, spawned here, with ``--device cpu``.

On cards, e.g.:

  torchrun --nproc-per-node 8 -m repro_torch.examples.train_carbon_aware \\
      --preset 100m --steps 300 --max-dp 8
  python -m repro_torch.examples.train_carbon_aware --host-devices 4 --device cpu
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch.core import CarbonService
from repro_torch.device import resolve_device
from repro_torch.elastic import ElasticTrainer, RescalePlan, make_compressor
from repro_torch.launch.train import join_ranks, spawn_host_ranks
from repro_torch.models import param_count
from repro_torch.models.common import ModelConfig
from repro_torch.train import DataConfig, OptimizerConfig, SyntheticLM

PRESETS = {
    # ~100M params: 12 x 640 with 32k vocab ≈ 103M
    "100m": ModelConfig(name="lm-100m", family="dense", num_layers=12,
                        d_model=640, num_heads=10, num_kv_heads=10,
                        d_ff=1792, vocab_size=32000),
    "10m": ModelConfig(name="lm-10m", family="dense", num_layers=6,
                       d_model=256, num_heads=8, num_kv_heads=4,
                       d_ff=704, vocab_size=8192),
    "tiny": ModelConfig(name="lm-tiny", family="dense", num_layers=2,
                        d_model=64, num_heads=4, num_kv_heads=2,
                        d_ff=128, vocab_size=512),
}
HOURS = 12


def carbon_plan(ci: CarbonService, hours: int, steps_per_slot: int,
                max_dp: int) -> list[RescalePlan]:
    """CarbonFlex-style elastic plan: allocation tracks the day-ahead CI
    rank through the job's roofline-derived scaling profile."""
    plan = []
    for t in range(hours):
        rank = ci.rank(t)
        if rank < 0.25:
            k = 0                       # pause at high carbon
        else:
            # scale by rank through the marginal-throughput profile
            k = 1 + int(round((max_dp - 1) * max(rank - 0.25, 0) / 0.75))
        plan.append(RescalePlan(k=k, steps=steps_per_slot if k else 0))
    return plan


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--max-dp", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--region", default="south-australia")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "carbonflex_train"))
    ap.add_argument("--compress", action="store_true",
                    help="int8 error-feedback gradient compression")
    ap.add_argument("--fault-at", type=int, default=None)
    ap.add_argument("--host-devices", type=int, default=0,
                    help="spawn N CPU ranks over gloo (the reference's forced host devices)")
    ap.add_argument("--device", default="cuda")
    return ap


def elastic_plan(args) -> tuple[list[RescalePlan], int]:
    """The plan for the parsed ``args`` and its steps per slot."""
    ci = CarbonService.synthetic(args.region, 24 * 7, seed=3)
    steps_per_slot = max(args.steps // HOURS, 1)
    return carbon_plan(ci, HOURS, steps_per_slot, args.max_dp), steps_per_slot


def _train(args) -> dict:
    """This rank's trainer over the plan; the result dict, equal on every
    rank."""
    cfg = PRESETS[args.preset]
    plan, steps_per_slot = elastic_plan(args)
    data = SyntheticLM(DataConfig(batch=args.batch, seq_len=args.seq,
                                  vocab_size=cfg.vocab_size, seed=0))
    trainer = ElasticTrainer(
        cfg, data, OptimizerConfig(lr=1e-3, warmup_steps=10,
                                   total_steps=args.steps),
        args.ckpt, device=args.device,
        compression=make_compressor("int8") if args.compress else None)
    return trainer.run(plan, checkpoint_every=max(steps_per_slot, 2),
                       fault_at=args.fault_at)


def _run(argv: list) -> dict:
    return _train(parser().parse_args(argv))


def main(argv=None) -> dict:
    """Prints the model's size, the plan, the run's counts and its first
    and last loss (rank 0); returns the trainer's result with ``plan`` (k
    per hour) and ``params`` added."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser().parse_args(argv)
    resolve_device(args.device)
    rank = 0 if args.host_devices else join_ranks(args)

    cfg = PRESETS[args.preset]
    plan, _ = elastic_plan(args)
    if rank == 0:
        print(f"model {cfg.name}: {param_count(cfg) / 1e6:.1f}M params")
        print("elastic plan (k per hour):", [p.k for p in plan])

    out = (spawn_host_ranks(_run, argv, args.host_devices, args.device) if args.host_devices
           else _train(args))

    losses = out["losses"]
    if rank == 0:
        print(f"\nsteps {out['final_step']}  rescales {out['rescales']}  "
              f"recoveries {out['recoveries']}  stragglers {out['stragglers']}")
        print(f"loss: first {losses[0]:.3f} -> last {losses[-1]:.3f} "
              f"(improved: {losses[-1] < losses[0]})")
    assert np.isfinite(losses).all()
    return dict(out, plan=[p.k for p in plan], params=param_count(cfg))


if __name__ == "__main__":
    main()
