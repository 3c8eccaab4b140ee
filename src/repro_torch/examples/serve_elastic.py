"""End-to-end serving driver: batched decode with a KV cache.

Serves a small dense LM: a prefill pass builds the sequence-sharded KV
cache for a batch of prompts, then batched decode steps generate new
tokens — the ``serve_step`` lowered by the decode_* dry-run cells, run for
real.  The mesh is the reference example's (1, 1) ("data", "model"): one
device, no process group.  The weights are drawn from seed 0 on the host
and moved to ``--device``, so a card and the CPU serve the same model (a
generator on the card draws other numbers from one seed).

  python -m repro_torch.examples.serve_elastic --tokens 32
  python -m repro_torch.examples.serve_elastic --tokens 8 --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import LogicalRules, init_params
from repro_torch.serve import greedy_generate


def _to(tree: dict, device: torch.device) -> dict:
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def main(argv=None):
    """Prints the shapes, the prefill and decode times and the first
    sequence; returns ``greedy_generate``'s dict, the ids as numpy and the
    config under ``cfg``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced(ARCHS[args.arch])
    mesh = make_mesh((1, 1), ("data", "model"))
    rules = LogicalRules(mesh)
    params = _to(init_params(cfg, seed=0, device="cpu"), device)

    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))).to(device)

    out = greedy_generate(params, prompts, cfg, args.tokens, rules)
    gen = out["tokens"].cpu().numpy()
    print(f"arch {cfg.name} batch {args.batch} prompt {args.prompt_len} "
          f"-> {args.tokens} new tokens")
    print(f"prefill {out['prefill_s']:.2f}s  decode {out['decode_s']:.2f}s "
          f"({args.tokens * args.batch / max(out['decode_s'], 1e-9):.1f} tok/s)")
    print("first sequence:", gen[0][:16], "...")
    assert gen.shape == (args.batch, args.tokens)
    assert (gen >= 0).all() and (gen < cfg.vocab_size).all()
    return dict(out, tokens=gen, cfg=cfg)


if __name__ == "__main__":
    main()
