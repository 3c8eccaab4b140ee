"""Serve a batch of random prompts with greedy decode (the counterpart of
``examples/serve_elastic.py``): a prefill builds the cache, then batched
decode steps generate new tokens.  Weights are random, from seed 0;
prompts are drawn with numpy from seed 0.

    python -m repro_torch.serve --arch llama3-8b --batch 4 --prompt-len 2048 --tokens 64
    python -m repro_torch.serve --arch rwkv6-7b
    python -m repro_torch.serve --arch zamba2-7b
    python -m repro_torch.serve --reduced --device cpu
    python -m repro_torch.serve --arch qwen3-moe-235b-a22b --reduced --device cpu

Full width on the card by default (it raises without one); ``--reduced``
takes the reference example's scale (``configs.reduced``, prompt 32, 32
new tokens).  The transformer families prefill in one forward pass
(default prompt 2048, 64 new tokens); rwkv6 and zamba2 replay the prompt
through their decode step one token at a time, as the reference does
(default prompt 128, 32 new tokens).  The MoE configs at full depth do not
fit one card.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serve import greedy_generate


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve")
    ap.add_argument("--arch", default="llama3-8b", choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=None,
                    help="default 2048 (rwkv6, zamba2: 128), or 32 with --reduced")
    ap.add_argument("--tokens", type=int, default=None,
                    help="default 64 (rwkv6, zamba2: 32), or 32 with --reduced")
    ap.add_argument("--reduced", action="store_true",
                    help="the small same-family config of the CPU tests")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = reduced(ARCHS[args.arch]) if args.reduced else ARCHS[args.arch]
    replay = cfg.family in ("ssm", "hybrid")
    prompt_len = args.prompt_len or (32 if args.reduced else 128 if replay else 2048)
    new_tokens = args.tokens or (32 if args.reduced or replay else 64)

    params = init_params(cfg, seed=0, device=device)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (args.batch, prompt_len))).to(device)

    out = greedy_generate(params, prompts, cfg, new_tokens)
    gen = out["tokens"].cpu().numpy()
    print(f"arch {cfg.name} on {device} batch {args.batch} prompt {prompt_len} "
          f"-> {new_tokens} new tokens, attention {cfg.attention_backend}")
    print(f"prefill {out['prefill_s']:.3f} s  decode {out['decode_s']:.3f} s "
          f"({new_tokens * args.batch / max(out['decode_s'], 1e-9):.1f} tok/s); "
          f"flash kernel launches: {out['prefill_flash_launches']} in prefill, "
          f"{out['decode_flash_launches']} in decode")
    print("first sequence:", gen[0][:16], "...")
    assert gen.shape == (args.batch, new_tokens)
    assert (gen >= 0).all() and (gen < cfg.vocab_size).all()
    return out


if __name__ == "__main__":
    main()
