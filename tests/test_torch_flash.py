"""The port's attention against the JAX package's, on the CPU.

``repro_torch.kernels.flash_attention.gqa_flash`` on CPU tensors runs its
plain version; it is held against the Pallas kernel ``gqa_flash`` in
interpret mode (64×64 blocks) and against ``ref.flash_attention_ref`` on
the same numpy inputs, at the reference's tolerances
(``tests/test_kernels.py``): 2e-5 in fp32, 5e-2 in bf16.  The port's
``chunked_attention`` is held against the reference's at 2e-5.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops, ref
from repro.models import common as jcommon
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import common

# (sq, extra keys, hq, group, d): every sq and every offset of the grid
# sq in {1, 17, 64, 130}, sk = sq + {0, 37, 200}, (hq, group) in
# {(2, 1), (4, 2), (8, 4)}, d in {32, 64, 128}, each head layout and head
# dim four times.
CASES = [
    (1, 0, 2, 1, 32), (1, 37, 4, 2, 64), (1, 200, 8, 4, 128),
    (17, 0, 4, 2, 128), (17, 37, 8, 4, 32), (17, 200, 2, 1, 64),
    (64, 0, 8, 4, 64), (64, 37, 2, 1, 128), (64, 200, 4, 2, 32),
    (130, 0, 2, 1, 128), (130, 37, 4, 2, 32), (130, 200, 8, 4, 64),
]
BF16_CASES = [(1, 200, 8, 4, 128), (64, 0, 4, 2, 64), (130, 37, 2, 1, 32)]


def _qkv(sq, extra, hq, group, d, seed):
    rng = np.random.default_rng(seed)
    sk = sq + extra
    hkv = hq // group
    return (rng.normal(size=(2, sq, hq, d)).astype(np.float32),
            rng.normal(size=(2, sk, hkv, d)).astype(np.float32),
            rng.normal(size=(2, sk, hkv, d)).astype(np.float32), extra)


@pytest.mark.parametrize(
    "case,dtype", [(c, "float32") for c in CASES]
    + [(c, "bfloat16") for c in BF16_CASES], ids=str)
def test_gqa_flash_cpu_matches_pallas_and_ref(case, dtype):
    q, k, v, off = _qkv(*case, seed=sum(case))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" \
        else (jnp.bfloat16, torch.bfloat16)
    tol = 2e-5 if dtype == "float32" else 5e-2
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    pallas = ops.flash_attention(jq, jk, jv, causal_offset=off, interpret=True,
                                 block_q=64, block_k=64)
    expect = ref.flash_attention_ref(jq, jk, jv, causal_offset=off)
    fa.reset_launches()
    out = fa.gqa_flash(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                       causal_offset=off)
    assert fa.launches["gqa_flash"] == 0           # CPU tensors: plain version
    assert out.dtype == tdt and out.shape == q.shape
    got = out.float().numpy()
    for want in (pallas, expect):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("chunk", [64, 1024])
@pytest.mark.parametrize("sq,extra,hq,group,d", [(17, 200, 8, 4, 64),
                                                 (130, 0, 4, 2, 32),
                                                 (1, 1500, 2, 1, 128)])
def test_chunked_attention_matches_reference(sq, extra, hq, group, d, chunk):
    q, k, v, off = _qkv(sq, extra, hq, group, d, seed=chunk + sq)
    want = jcommon.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), off, chunk)
    got = common.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), off, chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)

