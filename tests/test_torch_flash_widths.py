"""The head-dim kernels of ``gqa_flash`` on the CPU: every 16-bit head dim D
that is a multiple of 8 in (32, 128] and has no instantiation of its own
runs its products at the head's own width W = ceil(D / 16) * 16 (S = Q K^T
and dP in W / 16 k-steps, O += P V, dQ, dK and dV at N = W) on the 64- and
128-wide tiles, its blocks in the L2 order, forward and backward
(``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``,
``by_width``).  Here, without a card:

- ``product_dim``, ``width_kernel`` and the instantiation each (dtype, D)
  runs, forward and backward, against the sources' dispatch;
- the planned L2 order walked as the kernels decode it
  (``hopper::block_of<true>``, ``wg::l2_unit``): fp16 D 112 at zamba2-7b's
  layout, bf16 D 96 over 8 KV heads, ragged shapes, and budgets small
  enough to give several groups: each output stored once, the groups one
  after another, each group's heaviest tiles first, each group within its
  budget;
- the yardsticks' plans (``kernel="wgmma_tile"``, ``route="wgmma_tile"``):
  the grid's order on the whole tile, at the head-dim kernels' (dtype, D)
  only;
- the backward's plain version from the LSE at D 48, 80 and 112 in bf16
  and fp16 against ``jax.vjp`` of the reference's ``chunked_attention`` on
  the same rounded inputs (the forward's parity with the Pallas kernel at
  these head dims is in ``tests/test_torch_flash_dims.py``).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models.common import chunked_attention as jchunked_attention
from repro_torch.kernels import flash_attention as fa

CSRC = Path(fa.__file__).resolve().parents[1] / "csrc"
HALF = (torch.bfloat16, torch.float16)
T_NAMES = {torch.bfloat16: "__nv_bfloat16", torch.float16: "__half"}
CASES = [(dtype, d) for dtype in HALF for d in range(40, 129, 8)]


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype,d", CASES, ids=str)
def test_product_dim_and_instance(dtype, d):
    """W is the least multiple of 16 that holds D, within the tiles; bf16
    at 64, 112 and 128 keep their own forward instantiations (64 and 128
    their backward too), every other (dtype, D) here runs a head-dim kernel,
    whose yardstick is the whole-tile instantiation of its run-time D."""
    w, tile = fa.product_dim(d), fa.wgmma_tile_dim(d)
    assert w in fa.PRODUCT_WIDTHS and w % 16 == 0 and 0 <= w - d < 16 and w <= tile
    assert w > {64: 32, 128: 64}[tile]          # the static_assert: past the tile's least D
    own_fwd = dtype == torch.bfloat16 and d in (64, 112, 128)
    own_bwd = dtype == torch.bfloat16 and d in (64, 128)
    assert fa.width_kernel(dtype, d) == (not own_fwd)
    assert fa.width_kernel(dtype, d, backward=True) == (not own_bwd)
    assert fa.l2_order(dtype, d) == (not own_fwd or d == 112)
    t = T_NAMES[dtype]
    width = f"Products<{w}, {w}, true>"
    if own_fwd:
        want = ("flash_wgmma_kernel<128, 112, __nv_bfloat16, Products<112, 112, true>>"
                if d == 112 else f"flash_wgmma_kernel<{d}, {d}, __nv_bfloat16>")
    else:
        want = f"flash_wgmma_kernel<{tile}, 0, {t}, {width}>"
        assert fa.instance(dtype, d, "wgmma_tile") == f"flash_wgmma_kernel<{tile}, 0, {t}>"
    assert fa.instance(dtype, d) == want
    for which, kind in enumerate(("dq", "dkdv")):
        got = fa.bwd_instance(dtype, d, which=which)
        if own_bwd:
            assert got == f"flash_bwd_{kind}_wgmma_kernel<{d}, {d}, __nv_bfloat16>"
        else:
            assert got == f"flash_bwd_{kind}_wgmma_kernel<{tile}, 0, {t}, {width}>"
            tile_do = 112 if dtype == torch.bfloat16 and d == 112 else 0
            assert fa.bwd_instance(dtype, d, "wgmma_tile", which) == \
                f"flash_bwd_{kind}_wgmma_kernel<{tile}, {tile_do}, {t}>"


def test_head_dim_kernels_in_the_sources():
    """The wrapper's widths, instantiations and conditions are the sources':
    both ``by_width`` switches, each width's ``Products<W, W, true>`` on its
    tiles, the C entries' head dims, and the O products' widths."""
    fwd = (CSRC / "flash_attention.cu").read_text()
    bwd = (CSRC / "flash_attention_bwd.cu").read_text()
    hopper = (CSRC / "hopper.cuh").read_text()
    for src, first in ((fwd, "tm, o, lse"), (bwd, "which, tm, a")):
        body = src[src.index("int by_width("):]
        body = body[:body.index("\n}\n")]
        assert "switch ((d + 15) / 16 * 16) {" in body
        cases = [int(c) for c in re.findall(r"case (\d+):", body)]
        assert tuple(cases) == fa.PRODUCT_WIDTHS
        for w in fa.PRODUCT_WIDTHS:
            tile = fa.wgmma_tile_dim(w)
            assert f"launch<{tile}, 0, T, Products<{w}, {w}, true>>(\n          {first}" in body
    assert "const bool widths = d % 8 == 0 && d > 32 && d <= 128 && " \
           "!(dtype == 1 && d % 64 == 0);" in fwd
    assert "const bool widths = d % 8 == 0 && d > 32 && d <= 128;" in bwd
    assert "using D112 = Products<112, 112, true>;" in fwd
    assert "struct Products {" in hopper and "struct Products {" not in fwd + bwd
    for n in (48, 80, 96, 112):
        assert f"wgmma.mma_async.sync.aligned.m64n{n}k16.f32." in hopper
        assert f"wgmma_rs_n{n}<T>(d, a, b);" in hopper
    # the products' k-steps and N in the backward
    assert "for (int kk = 1; kk < QK / 16; ++kk) {" in bwd
    assert "wgmma_rs<N, T>(acc, a + 4 * kk" in bwd


def _units(n, tiles, heads, group, group_kv):
    """``wg::l2_unit`` and ``hopper::block_of<true>``: block i's (head,
    batch, place of its tile in the walk)."""
    for i in range(n):
        full = group_kv * group * tiles
        kv0 = i // full * group_kv
        m = min(group_kv, n // (group * tiles) - kv0) * group
        r = i % full
        kv = kv0 + r % m // group
        hkv = heads // group
        yield kv % hkv * group + r % group, kv // hkv, r // m


def _check_walk(blocks, kv_of, b, hkv, group_kv, heavy):
    """Each block once; the KV pairs' groups in order; in each group the
    blocks' work (``heavy``) never rising."""
    assert len(set(blocks)) == len(blocks)
    groups = [(bb * hkv + kv_of(h)) // group_kv for h, bb, _ in blocks]
    assert groups == sorted(groups)
    for g in set(groups):
        work = [heavy(x) for (h, bb, x), gg in zip(blocks, groups) if gg == g]
        assert all(a >= c for a, c in zip(work, work[1:]))
        pairs = {bb * hkv + kv_of(h) for (h, bb, _), gg in zip(blocks, groups) if gg == g}
        assert pairs == set(range(g * group_kv, min((g + 1) * group_kv, b * hkv)))


# (B, Sq, Sk, Hq, Hkv, D, dtype, causal offset): zamba2-7b's layout in fp16,
# bf16 D 96 over 8 KV heads, ragged GQA shapes and one row over a long cache
WALK_SHAPES = [(4, 2048, 2048, 32, 32, 112, torch.float16, 0),
               (4, 2048, 2048, 32, 8, 96, torch.bfloat16, 0),
               (2, 130, 167, 4, 2, 48, torch.float16, 37),
               (3, 300, 300, 6, 3, 80, torch.bfloat16, 0),
               (2, 1, 300, 4, 4, 72, torch.float16, 299)]


@pytest.mark.parametrize("shape", WALK_SHAPES, ids=str)
@pytest.mark.parametrize("budget", [fa.L2_KV_BUDGET, 4 * 2**20, 1], ids=["L2", "4MiB", "1B"])
def test_forward_l2_order_walk(shape, budget):
    """The forward's plan at the stated budget, and the kernel's decode at
    4 MiB (several groups at zamba2's and the GQA shape) and at 1 byte (a
    group a KV pair): every query row of every head stored once, the groups
    in order, each group's heaviest query tiles first, each within the
    budget."""
    b, sq, sk, hq, hkv, d, dtype, off = shape
    q, k = _meta((b, sq, hq, d), dtype), _meta((b, sk, hkv, d), dtype)
    pl = fa.plan(q, k, k, off)
    tiles = -(-sq // fa.WGMMA_ROWS)
    assert pl.route == "wgmma" and pl.grid == (b * hq * tiles, 1, 1)
    assert pl.group_kv == fa.kv_group(b, sk, hkv, d)
    g = fa.kv_group(b, sk, hkv, d, budget=budget)
    assert (b * hkv) % g == 0 and (g == 1 or g * 2 * sk * d * 2 <= budget)
    group = hq // hkv
    blocks = [(h, bb, (tiles - 1 - z) * fa.WGMMA_ROWS)
              for h, bb, z in _units(pl.grid[0], tiles, hq, group, g)]
    rows = np.zeros((b, sq, hq), dtype=int)
    for h, bb, q0 in blocks:
        rows[bb, q0:q0 + fa.WGMMA_ROWS, h] += 1
    assert (rows == 1).all()
    _check_walk(blocks, lambda h: h // group, b, hkv, g, heavy=lambda q0: q0)


@pytest.mark.parametrize("shape", WALK_SHAPES, ids=str)
@pytest.mark.parametrize("budget", [fa.L2_KV_BUDGET, 4 * 2**20, 1], ids=["L2", "4MiB", "1B"])
def test_backward_l2_order_walk(shape, budget):
    """The backward's plan: dQ over query heads in groups of ``kv_group``'s
    KV pairs, heaviest query tiles first; dK/dV over KV heads in groups of
    ``rows_group``'s, whose query heads' Q and dO fit the budget, key tiles
    first to last (the first keys are seen by the most rows): each dQ row
    and each dK/dV key written by one block."""
    b, sq, sk, hq, hkv, d, dtype, off = shape
    q, k = _meta((b, sq, hq, d), dtype), _meta((b, sk, hkv, d), dtype)
    pl = fa.plan_bwd(q, k, k, q, q, causal_offset=off)
    q_tiles = -(-sq // fa.BWD_WGMMA_DQ_ROWS)
    k_tiles = -(-sk // fa.BWD_WGMMA_KV_KEYS)
    assert pl.grids == ((b * hq * q_tiles, 1, 1), (b * hkv * k_tiles, 1, 1))
    assert pl.groups == (fa.kv_group(b, sk, hkv, d), fa.rows_group(b, sq, hq, hkv, d))
    group = hq // hkv
    g_dq = fa.kv_group(b, sk, hkv, d, budget=budget)
    g_kv = fa.rows_group(b, sq, hq, hkv, d, budget=budget)
    assert (b * hkv) % g_kv == 0 and (g_kv == 1 or g_kv * 2 * sq * group * d * 2 <= budget)
    dq_blocks = [(h, bb, (q_tiles - 1 - z) * fa.BWD_WGMMA_DQ_ROWS)
                 for h, bb, z in _units(pl.grids[0][0], q_tiles, hq, group, g_dq)]
    dq = np.zeros((b, sq, hq), dtype=int)
    for h, bb, q0 in dq_blocks:
        dq[bb, q0:q0 + fa.BWD_WGMMA_DQ_ROWS, h] += 1
    assert (dq == 1).all()
    _check_walk(dq_blocks, lambda h: h // group, b, hkv, g_dq, heavy=lambda q0: q0)
    kv_blocks = [(hk, bb, z * fa.BWD_WGMMA_KV_KEYS)
                 for hk, bb, z in _units(pl.grids[1][0], k_tiles, hkv, 1, g_kv)]
    dkv = np.zeros((b, sk, hkv), dtype=int)
    for hk, bb, k0 in kv_blocks:
        dkv[bb, k0:k0 + fa.BWD_WGMMA_KV_KEYS, hk] += 1
    assert (dkv == 1).all()
    _check_walk(kv_blocks, lambda hk: hk, b, hkv, g_kv, heavy=lambda k0: -k0)


def test_group_rules_at_the_timed_shapes():
    """zamba2-7b's layout (B 4, S 2048, 32 over 32, D 112): K/V of 917,504
    bytes a pair, 14 within the budget, 8 the largest divisor of 128, and Q
    and dO the same per pair; internvl2-2b's train shape at D 96 (B 4, S
    2304, 16 over 8): K/V 884,736 bytes a pair, 8 of 32; Q and dO of its two
    query heads twice that, 4."""
    assert fa.kv_group(4, 2048, 32, 112) == fa.rows_group(4, 2048, 32, 32, 112) == 8
    assert fa.kv_group(4, 2304, 8, 96) == 8 and fa.rows_group(4, 2304, 16, 8, 96) == 4
    assert fa.kv_group(4, 2048, 8, 96) == 16          # the forward's GQA case: 2 groups
    assert fa.kv_group(4, 2048, 8, 48) == 32          # all 32 pairs: the grid's order
    assert fa.rows_group(1, 9, 2, 1, 40, budget=1) == 1


@pytest.mark.parametrize("dtype,d", [(torch.float16, 112), (torch.bfloat16, 96),
                                     (torch.float16, 40), (torch.bfloat16, 120)], ids=str)
def test_yardstick_plans(dtype, d):
    """The whole-tile yardsticks keep the grid's order, the default plan's
    maps and the ring of the kernels in the grid's order (2 deep at width
    128, where the head-dim kernels overlap their softmax with their
    products on a ring 3 deep)."""
    q, k = _meta((2, 300, 8, d), dtype), _meta((2, 300, 2, d), dtype)
    pl, yard = fa.plan(q, k, k), fa.plan(q, k, k, kernel="wgmma_tile")
    assert yard == fa.Plan("wgmma_tile", maps=pl.maps, grid=(8, 2, 3),
                           smem=fa.wgmma_smem_bytes(d))
    assert pl.smem == fa.wgmma_smem_bytes(d, ordered=True)
    assert fa.wgmma_stages(d, ordered=True) == (3 if fa.wgmma_tile_dim(d) == 128 else
                                                fa.wgmma_stages(d))
    bpl, byard = fa.plan_bwd(q, k, k, q, q), fa.plan_bwd(q, k, k, q, q, route="wgmma_tile")
    assert byard.route == "wgmma_tile" and byard.groups == (0, 0)
    assert byard.grids == ((8, 2, 3), (2, 2, 5)) and byard.maps == bpl.maps
    assert byard.smem == bpl.smem and fa.BWD_ROUTE_KERNELS["wgmma_tile"] == (
        "bwd_wgmma_tile_dq", "bwd_wgmma_tile_dkdv")


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64), (torch.bfloat16, 128),
                                     (torch.bfloat16, 112), (torch.float16, 100),
                                     (torch.float16, 136), (torch.bfloat16, 32),
                                     (torch.float32, 96)], ids=str)
def test_yardsticks_take_only_the_head_dim_kernels(dtype, d):
    """``kernel="wgmma_tile"`` only where the forward runs a head-dim kernel
    (bf16 112 keeps ``"wgmma_pad128"``) or a wide kernel (past 128, 136
    here: the whole-tile instantiations in the grid's order),
    ``route="wgmma_tile"`` only where the backward does (bf16 112
    included)."""
    q = _meta((1, 8, 4, fa.tma_width(d)), dtype)[..., :d]
    if fa.wide_kernel(dtype, d):
        assert fa.plan(q, q, q, kernel="wgmma_tile").group_kv == 0
        assert fa.plan_bwd(q, q, q, q, q, route="wgmma_tile").groups == (0, 0)
        return
    with pytest.raises(ValueError, match="does not take"):
        fa.plan(q, q, q, kernel="wgmma_tile")
    if dtype == torch.bfloat16 and d == 112:
        assert fa.plan_bwd(q, q, q, q, q, route="wgmma_tile").route == "wgmma_tile"
    else:
        with pytest.raises(ValueError, match="does not take"):
            fa.plan_bwd(q, q, q, q, q, route="wgmma_tile")


@pytest.mark.parametrize("dtype", HALF, ids=str)
@pytest.mark.parametrize("d", [48, 80, 112])
def test_lse_backward_matches_jax_vjp_at_head_dim_widths(d, dtype):
    """The head-dim kernels' plain version (P from the LSE, P and dS rounded
    to the inputs' type where the kernels round them) against ``jax.vjp`` of
    the reference's ``chunked_attention`` on the same rounded inputs in fp32:
    within 5e-2 elementwise and 1e-2 relative L2, as on the wgmma route's
    other head dims (``tests/test_torch_flash_bwd_wgmma.py``)."""
    b, sq, sk, hq, hkv, off = 1, 37, 70, 4, 2, 33
    rng = np.random.default_rng(d)
    q, k, v, do = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dtype)
                   for s in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, hq, d)))
    q32, k32, v32, do32 = (jnp.asarray(t.float().numpy()) for t in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, c, e: jchunked_attention(a, c, e, off, 16), q32, k32, v32)
    want = [np.asarray(g) for g in vjp(do32)]
    o = fa.gqa_flash_plain(q, k, v, off)
    lse = fa.gqa_flash_lse_plain(q, k, off)
    got = fa.gqa_flash_bwd_lse_plain(q, k, v, o, do, lse, off, round_bf16=True)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        g = g.float().numpy()
        np.testing.assert_allclose(g, w, rtol=5e-2, atol=5e-2)
        assert np.linalg.norm(g - w) / np.linalg.norm(w) <= 1e-2
