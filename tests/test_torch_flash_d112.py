"""The D-112 kernel's launch arithmetic on the CPU: ``gqa_flash`` at bf16 head
dim 112 (zamba2-7b's shared attention) runs its blocks in the L2 order that
``kernels/flash_attention.py::plan`` lays out and
``csrc/flash_attention.cu::hopper::block_of`` decodes.  The order is walked
here as the kernel decodes it: each (batch, query head, query tile) runs
exactly once; the KV heads go in groups of ``group_kv``, one group after
another, and within a group the query tiles heaviest first (the key tiles a
block reads never rise along the group) with the query heads of one KV head
side by side; a group's K and V fit the budget the plan was given.  The
yardstick (``kernel="wgmma_pad128"``) keeps the grid's order.  The parity of
the port's attention at D 112 with the reference is in
``tests/test_torch_flash.py``.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa

D = fa.WGMMA_D112
CSRC = Path(fa.__file__).resolve().parents[1] / "csrc"


def _bf16(b, s, h, d=D):
    return torch.empty((b, s, h, d), dtype=torch.bfloat16, device="meta")


def _decode(i, grid_x, sq, hq, group, group_kv):
    """``hopper::block_of<true>``: block i's (query head, batch, first row)."""
    tiles = -(-sq // fa.WGMMA_ROWS)
    full = group_kv * group * tiles
    kv0 = i // full * group_kv
    kvs = grid_x // (group * tiles)
    heads = min(group_kv, kvs - kv0) * group
    r = i % full
    kv = kv0 + r % heads // group
    hkv = hq // group
    return kv % hkv * group + r % group, kv // hkv, (tiles - 1 - r // heads) * fa.WGMMA_ROWS


def _kv_tiles(q0, sq, sk, offset):
    """The key tiles a block of 128 query rows from q0 reads (``kv_tiles``)."""
    last = min(q0 + fa.WGMMA_ROWS, sq) - 1
    return -(-min(sk, offset + last + 1) // fa.WGMMA_KEYS)


def _walk(b, sq, sk, hq, hkv, offset, group_kv):
    """Every block of the L2 order in launch order: (i, h, b, q0, KV pair)."""
    group = hq // hkv
    tiles = -(-sq // fa.WGMMA_ROWS)
    n = b * hq * tiles
    out = []
    for i in range(n):
        h, bb, q0 = _decode(i, n, sq, hq, group, group_kv)
        assert 0 <= h < hq and 0 <= bb < b and 0 <= q0 < sq
        out.append((i, h, bb, q0, bb * hkv + h // group))
    return out


def _check_order(blocks, b, sq, sk, hq, hkv, offset, group_kv):
    group = hq // hkv
    tiles = -(-sq // fa.WGMMA_ROWS)
    seen = {(h, bb, q0) for _, h, bb, q0, _ in blocks}
    assert len(seen) == len(blocks) == b * hq * tiles        # each block once
    assert seen == {(h, bb, t * fa.WGMMA_ROWS) for h in range(hq) for bb in range(b)
                    for t in range(tiles)}
    # the groups: KV pairs [g * group_kv, (g + 1) * group_kv), one after another
    groups = [blk[4] // group_kv for blk in blocks]
    assert groups == sorted(groups)
    for g in set(groups):
        mine = [blk for blk in blocks if blk[4] // group_kv == g]
        pairs = sorted({blk[4] for blk in mine})
        assert pairs == list(range(g * group_kv, min((g + 1) * group_kv, b * hkv)))
        # heaviest query tiles first: the key tiles read never rise
        work = [_kv_tiles(q0, sq, sk, offset) for _, _, _, q0, _ in mine]
        assert all(x >= y for x, y in zip(work, work[1:]))
        rows = [q0 for _, _, _, q0, _ in mine]
        assert rows == sorted(rows, reverse=True)
        # within a tile, KV pair by KV pair, the query heads of one side by side
        for q0 in set(rows):
            tile = [(blk[4], blk[1]) for blk in mine if blk[3] == q0]
            assert tile == sorted(tile)
            assert [h for _, h in tile] == [kv % hkv * group + m for kv in pairs
                                            for m in range(group)]


# (B, Sq, Sk, Hq, Hkv, causal offset): zamba2-7b's forward, shard cell (f)'s
# local heads, a GQA shape, ragged S (a last query tile of 2 rows, keys past
# the rows), one row over a long cache, and an odd count of KV pairs
SHAPES = [(4, 2048, 2048, 32, 32, 0), (4, 512, 512, 16, 16, 0), (2, 1000, 1000, 32, 8, 0),
          (2, 130, 167, 4, 2, 37), (2, 1, 300, 4, 4, 299), (3, 300, 300, 6, 3, 0)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("budget", [fa.L2_KV_BUDGET, 4 * 2**20, 1], ids=["L2", "4MiB", "1B"])
def test_l2_order_walk(shape, budget):
    """The plan's L2 order at the stated budget, at 4 MiB (several groups at
    zamba2's S) and at 1 byte (a group a KV head): each block once, the
    groups in order, heaviest tiles first in each, within the budget."""
    b, sq, sk, hq, hkv, off = shape
    q, k = _bf16(b, sq, hq), _bf16(b, sk, hkv)
    g = fa.kv_group(b, sk, hkv, D, budget=budget)
    assert (b * hkv) % g == 0 and (g == 1 or g * 2 * sk * D * 2 <= budget)
    # the largest such divisor
    assert not any((b * hkv) % x == 0 and x * 4 * sk * D <= budget
                   for x in range(g + 1, b * hkv + 1))
    pl = fa.plan(q, k, k, off)
    tiles = -(-sq // fa.WGMMA_ROWS)
    assert pl.route == "wgmma" and pl.grid == (b * hq * tiles, 1, 1)
    assert pl.group_kv == fa.kv_group(b, sk, hkv, D)
    blocks = _walk(b, sq, sk, hq, hkv, off, g)
    _check_order(blocks, b, sq, sk, hq, hkv, off, g)


@pytest.mark.parametrize("shape,group_kv", [
    ((4, 2048, 2048, 32, 32, 0), 28), ((4, 2048, 2048, 32, 32, 0), 9),
    ((2, 130, 167, 4, 2, 37), 3), ((3, 300, 300, 6, 3, 0), 4), ((2, 1000, 1000, 32, 8, 0), 5),
    ((2, 1, 300, 4, 4, 299), 7), ((1, 70, 70, 2, 1, 0), 2)], ids=str)
def test_l2_order_walk_ragged_last_group(shape, group_kv):
    """The kernel's decode at group sizes that leave a smaller last group
    (the plan picks divisors, so only a caller such as
    scripts/kernel_splits.py d112 passes these; the C entry takes any)."""
    b, sq, sk, hq, hkv, off = shape
    blocks = _walk(b, sq, sk, hq, hkv, off, group_kv)
    _check_order(blocks, b, sq, sk, hq, hkv, off, group_kv)


def test_zamba2_groups_and_the_yardstick_plan():
    """zamba2-7b's forward: 917,504 bytes of K and V a KV head, 14 of them
    within the quarter of L2, the largest divisor of its 128 pairs 8; 2048
    blocks.  The yardstick plans the grid's order on the same maps, with the
    ring 2 deep where the D-112 kernel's is 3 deep."""
    q = _bf16(4, 2048, 32)
    pl, yard = fa.plan(q, q, q), fa.plan(q, q, q, kernel="wgmma_pad128")
    assert fa.L2_KV_BUDGET == 13_107_200 and fa.L2_KV_BUDGET // (2 * 2048 * D * 2) == 14
    assert pl.group_kv == 8 and pl.grid == (2048, 1, 1)
    assert yard == fa.Plan("wgmma_pad128", maps=pl.maps, grid=(32, 4, 16),
                           smem=fa.wgmma_smem_bytes(D))
    assert pl.smem == fa.wgmma_smem_bytes(D, ordered=True) == yard.smem + 65536 + 24
    assert fa.plan(_bf16(4, 512, 16), _bf16(4, 512, 16), _bf16(4, 512, 16)).group_kv == 32


@pytest.mark.parametrize("dtype,d,kernel", [
    (torch.float16, 112, None), (torch.bfloat16, 128, None), (torch.bfloat16, 96, None),
    (torch.bfloat16, 112, "mma_sync")], ids=str)
def test_l2_order_only_at_bf16_d112(dtype, d, kernel):
    """The L2 order is the D-112 kernel's and, since the head-dim kernels
    took it too, theirs: fp16 at D 112 and bf16 at D 96 run it (one group of
    both KV pairs here, whose K and V fit the budget: the grid's order on a
    1-D grid); bf16 at D 128 (its own instantiation) and the named kernels
    keep the 3-D grid's order."""
    q = torch.empty((2, 300, 8, d), dtype=dtype, device="meta")
    k = torch.empty((2, 300, 2, d), dtype=dtype, device="meta")
    pl = fa.plan(q, k, k, kernel=kernel)
    if kernel is None and fa.width_kernel(dtype, d):
        assert fa.l2_order(dtype, d) and pl.grid == (2 * 8 * 3, 1, 1)
        assert pl.group_kv == fa.kv_group(2, 300, 2, d) == 4
        return
    assert pl.group_kv == 0
    if kernel is None:
        assert not fa.l2_order(dtype, d) and pl.grid == (8, 2, 3)
    else:
        assert pl.grid == (-(-300 // fa.FWD_ROWS), 8, 2)


@pytest.mark.parametrize("dtype,d", [(torch.float16, 112), (torch.bfloat16, 128),
                                     (torch.float32, 112)], ids=str)
def test_yardstick_takes_only_bf16_d112(dtype, d):
    q = torch.empty((1, 8, 4, d), dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="does not take"):
        fa.plan(q, q, q, kernel="wgmma_pad128")


def test_d112_kernel_in_the_source():
    """The wrapper's arithmetic is the source's: the D-112 kernel's
    products and order, the decode this file transcribes, and the C entry
    that picks the kernel by group_kv."""
    src = (CSRC / "flash_attention.cu").read_text()
    hopper = (CSRC / "hopper.cuh").read_text()
    assert "using D112 = Products<112, 112, true>;" in src
    for line in ("const int full = group_kv * group * tiles;",
                 "const int kv0 = i / full * group_kv;",
                 "const int kvs = gridDim.x / (group * tiles);",
                 "const int heads = min(group_kv, kvs - kv0) * group;",
                 "const int kv = kv0 + r % heads / group;",
                 "return {kv % hkv * group + r % group, kv / hkv, (tiles - 1 - r / heads) * ROWS};"):
        assert line in src, line
    assert "hopper::launch<128, 112, __nv_bfloat16, hopper::D112>(" in src
    assert "wgmma.mma_async.sync.aligned.m64n112k16.f32." in hopper
    assert re.search(r"for \(int kk = 0; kk < QK / 16; \+\+kk\)", src)
    assert fa.WGMMA_TILE_DIM[D] == 128 and fa.wgmma_smem_bytes(D) == fa.wgmma_smem_bytes(128)
    assert "wgmma_pad128" in fa.launches                # the yardstick's own count


def test_group_rule_examples():
    """``kv_group``: the largest divisor of B x Hkv within the budget, at
    least 1."""
    assert fa.kv_group(4, 2048, 32, D) == 8            # 14 fit; 8 divides 128
    assert fa.kv_group(4, 2048, 8, D) == 8             # 32 pairs
    assert fa.kv_group(1, 2048, 7, D) == 7             # all 7 fit (6.4 MB)
    assert fa.kv_group(1, 16384, 7, D) == 1            # 7.3 MB each: one a group
    assert fa.kv_group(3, 2048, 5, D) == 5             # 15 pairs, 14 fit: 5
    assert fa.kv_group(4, 512, 16, D) == 32            # 57 fit; 32 divides 64
    assert fa.kv_group(2, 64, 1, D, budget=1) == 1
    sizes = np.array([fa.kv_group(b, s, h, D) for b in (1, 2, 4) for s in (1, 700, 4096)
                      for h in (1, 3, 8)])
    assert (sizes >= 1).all()
