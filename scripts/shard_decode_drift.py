"""How far a tensor-parallel decode of zamba2 drifts from the one-rank
decode, on two gloo CPU ranks at mesh (1, 2), and where the drift grows:

    PYTHONPATH=src python scripts/shard_decode_drift.py     # ~3 min on 8 cores

zamba2-7b at full width with 6 Mamba layers and its shared block (d_ff cut
to 1024 to keep the host's time short; no other width is cut), seed-0
weights:

1. one decode token from an empty cache through the layer stack twice: the
   one-rank blocks, and the tensor-parallel blocks each fed its own
   previous output (chained), printing the relative L2 between the two
   residual streams after every block; and each tensor-parallel block on the
   one-rank block's input (not chained);
2. the replay of a 4 x 16 prompt and 8 greedy decode steps through
   ``make_prefill`` / ``make_serve_step`` on the sharded caches against the
   one-rank path, in bf16 and in fp32: every output's relative L2, and
   whether the greedy tokens agree.

Under the reference init each Mamba layer amplifies a difference many times
over, so the chained bf16 decode drifts far apart while each block agrees to
a few 1e-5; fp32 stays close chained.  This is why ``chip_smoke.py``'s
shard cell (f) holds the decode block by block.
"""
import dataclasses
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

LAYERS, D_FF, BATCH, PROMPT, NEW = 6, 1024, 4, 16, 8


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def _rank(rank: int, init: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import DistMesh, make_mesh
    from repro_torch.models import api, transformer, zamba2
    from repro_torch.models.common import LogicalRules, layer, rms_norm
    from repro_torch.serve.decode import (cache_shardings, init_cache, make_prefill,
                                          make_serve_step, sharded_decode_attention)

    rules = LogicalRules(DistMesh(make_mesh((1, 2), ("data", "model"))))
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        cfg = dataclasses.replace(ARCHS["zamba2-7b"], num_layers=LAYERS, d_ff=D_FF,
                                  compute_dtype=dtype)
        params = api.init_params(cfg, 0, "cpu")
        local = api.shard_params(params, cfg, rules)
        prompts = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab_size, (BATCH, PROMPT)))
        name = str(dtype).split(".")[-1]
        with torch.no_grad():
            if dtype == torch.bfloat16:
                # 1. one token through the stack, chained and block by block
                whole = init_cache(cfg, BATCH, PROMPT + NEW, "cpu")
                mine = {k: sh.local(whole[k]) for k, sh in
                        cache_shardings(cfg, rules, BATCH, PROMPT + NEW).items()
                        if k != "length"}
                x = transformer.embed(params, prompts[:, 0], cfg)[:, None]
                xt = x.clone()
                for li in range(LAYERS):
                    lp, lpl = layer(params["layers"], li), layer(local["layers"], li)

                    def one(v):
                        return zamba2._mamba_decode_step(
                            rms_norm(v, lp["ln"], cfg.norm_eps), lp, cfg,
                            whole["ssm"][li], whole["conv"][li])[0]

                    def tp(v):
                        return zamba2._mamba_decode_step(
                            rms_norm(v, lp["ln"], cfg.norm_eps), lpl, cfg, mine["ssm"][li],
                            mine["conv"][li], rules)[0]

                    y = x + one(x)
                    out.append(f"mamba {li}: block on the one-rank input {_rel(x + tp(x), y):.3e}"
                               f", chained {_rel(xt + tp(xt), y):.3e}")
                    x, xt = y, xt + tp(xt)

                def attend(q, kc, vc, kn, vn, length):
                    return sharded_decode_attention(q, kc, vc, kn, vn, length, rules, True)

                y = zamba2._shared_decode(x, params["shared"], cfg, whole["k"][0].clone(),
                                          whole["v"][0].clone(), 0)
                yt = zamba2._shared_decode(xt, local["shared"], cfg, mine["k"][0].clone(),
                                           mine["v"][0].clone(), 0, rules, attend)
                out.append(f"shared block: chained {_rel(yt, y):.3e}")

            # 2. the replay and greedy decode, each path on its own tokens
            def serve(p, r):
                logits, cache = make_prefill(cfg, PROMPT + NEW, r)(p, prompts)
                step = make_serve_step(cfg, r)
                outs, toks = [logits], [logits.argmax(-1)]
                for _ in range(NEW):
                    logits, cache = step(p, cache, toks[-1])
                    outs.append(logits)
                    toks.append(logits.argmax(-1))
                return torch.stack(outs), torch.stack(toks)

            got, got_t = serve(local, rules)
            want, want_t = serve(params, None)
            out.append(f"{name} replay + decode: {_rel(got, want):.3e} in all, by output "
                       f"{[round(_rel(a, b), 5) for a, b in zip(got, want)]}; greedy tokens "
                       f"equal {torch.equal(got_t, want_t)}")
    if rank == 0:
        print("\n".join(out), flush=True)
    dist.destroy_process_group()


def main() -> None:
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=("file://" + os.path.join(tmp, "rendezvous"),),
                           nprocs=2, start_method="spawn")


if __name__ == "__main__":
    main()
