"""The wide kernels of ``gqa_flash`` on the CPU: every 16-bit head dim D in
(128, 256] runs on the tiles 192 or 256 wide in the L2 order, forward and
backward, the forward's K/V tiles of ``wide_keys(D)`` keys (96 at width 192,
64 at 256), dQ's of ``wide_dq_keys(D)`` (64, 32), and at width 256 a
producer warpgroup that hands each consumer thread 240 registers
(``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``,
``by_wide``; ``csrc/hopper.cuh``, ``Wide``, ``RolesOf``).  Here, without a
card:

- the route, ``instance`` and ``bwd_instance`` of every multiple of 8 in
  (128, 256] and of D 130 and 250 (``DO = -1``, staged) in bf16 and fp16,
  against the sources' dispatch, and the threads each instance launches
  (``RolesOf``);
- the planned L2 order walked as ``hopper::block_of<true>`` and
  ``wg::l2_unit`` decode it, at Gemma-2-9B's layout (16 query heads over 8
  KV heads of 256), at D 192, at ragged shapes and at small budgets: each
  output stored once, the groups one after another, each group's heaviest
  tiles first, each group within its budget;
- the new tilings' shared memory within a block's 227 KB, as the sources
  lay it out;
- the yardsticks' plans (``kernel="wgmma_tile"``, ``route="wgmma_tile"``):
  the grid's order on the tiles' own keys;
- a float64 model of the forward's tile loop at K/V tiles of 96 keys (width
  192's, which divide neither the block's rows nor most sequences), 80 (a
  split variant's) and 64, against the plain version's arithmetic;
- the plain forward and the plain LSE backward at D 192 and 256 in bf16 and
  fp16 against ``repro``'s Pallas kernel in interpret mode and ``jax.vjp``
  of ``chunked_attention`` on the same rounded inputs.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ops, ref
from repro.models.common import chunked_attention as jchunked_attention
from repro_torch.kernels import flash_attention as fa

CSRC = Path(fa.__file__).resolve().parents[1] / "csrc"
HALF = (torch.bfloat16, torch.float16)
T_NAMES = {torch.bfloat16: "__nv_bfloat16", torch.float16: "__half"}
SMEM_LIMIT = 232_448          # a block's dynamic shared memory on an H100
WIDE_DIMS = list(range(136, 257, 8)) + [130, 250]


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _threads(tile: int, regs: int) -> int:
    """``hopper::RolesOf<tile, P>``'s threads: 256 without a producer (the
    narrow tiles, and width 256 at ``P::REGS`` 0), else 384."""
    return 256 if tile <= fa.WGMMA_NARROW or (tile > 192 and regs == 0) else 384


@pytest.mark.parametrize("dtype", HALF, ids=str)
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_route_and_instances(dtype, d):
    """Every 16-bit D past 128 runs the wide kernels both ways, ``DO`` 0 at a
    multiple of 8 and -1 off it; their yardsticks are the whole-tile
    instantiations of the same ``DO``; width 256 launches 384 threads (a
    producer) where its yardstick launches 256, width 192 384 both."""
    tile, t = fa.wgmma_tile_dim(d), T_NAMES[dtype]
    do = 0 if d % 8 == 0 else -1
    assert fa.route(dtype, d) == fa.bwd_route(dtype, d) == "wgmma"
    assert fa.wide_kernel(dtype, d) and fa.l2_order(dtype, d)
    assert not fa.width_kernel(dtype, d) and not fa.width_kernel(dtype, d, backward=True)
    regs = fa.WIDE_REGS if tile == 256 else 0
    keys, dq_keys = fa.wide_keys(d), fa.wide_dq_keys(d)
    assert (keys, dq_keys) == ((64, 32) if tile == 256 else (96, 64))
    wide = f"Products<{tile}, {tile}, true, {keys}, {regs}>"
    assert fa.instance(dtype, d) == f"flash_wgmma_kernel<{tile}, {do}, {t}, {wide}>"
    assert fa.instance(dtype, d, "wgmma_tile") == f"flash_wgmma_kernel<{tile}, {do}, {t}>"
    for which, kind in enumerate(("dq", "dkdv")):
        assert fa.bwd_instance(dtype, d, which=which) == (
            f"flash_bwd_{kind}_wgmma_kernel<{tile}, {do}, {t}, "
            f"Products<{tile}, {tile}, true, {dq_keys}, {regs}>>")
        assert fa.bwd_instance(dtype, d, "wgmma_tile", which) == \
            f"flash_bwd_{kind}_wgmma_kernel<{tile}, {do}, {t}>"
    assert _threads(tile, regs) == 384 and _threads(tile, 0) == (256 if tile == 256 else 384)
    # no 16-bit D up to 128 and no fp32 D runs them
    assert not fa.wide_kernel(dtype, 128) and not fa.wide_kernel(torch.float32, d)


def test_wide_kernels_in_the_sources():
    """The wrapper's keys, registers and conditions are the sources': the
    key counts in ``hopper.cuh``, ``Wide`` in both sources, each
    ``by_wide`` dispatching the tiles 192 and 256 by ``tile_of(d)``, the C
    entries taking every D past 128 in the L2 order, ``RolesOf``'s producer
    at width 256 only where ``Products::REGS`` asks, and the registers
    handed over within the launch's 168 a thread at 384 threads."""
    hopper = (CSRC / "hopper.cuh").read_text()
    fwd = (CSRC / "flash_attention.cu").read_text()
    bwd = (CSRC / "flash_attention_bwd.cu").read_text()
    assert "constexpr int wide_keys(int w) { return w > 192 ? 64 : 96; }" in hopper
    assert "constexpr int wide_dq_keys(int w) { return w > 192 ? 32 : 64; }" in hopper
    assert fa.WIDE_KEYS == {192: 96, 256: 64} and fa.WIDE_DQ_KEYS == {192: 64, 256: 32}
    assert "using Wide = Products<D, D, true, wide_keys(D), (D > 192 ? 240 : 0)>;" in fwd
    assert "using Wide = Products<D, D, true, wide_dq_keys(D), (D > 192 ? 240 : 0)>;" in bwd
    assert fa.WIDE_REGS == 240 and (168 * 384 - 256 * fa.WIDE_REGS) // 128 == 24
    for src, first in ((fwd, "tm, o, lse"), (bwd, "which, tm, a")):
        body = src[src.index("int by_wide("):]
        body = body[:body.index("\n}\n")]
        assert "if (tile_of(d) == 192)" in body
        for tile in (192, 256):
            assert f"launch<{tile}, DO, T, Wide<{tile}>>({first}" in body
        assert "const bool wide = d > 128;" in src
        assert "(ordered && !widths && !wide)" in src
        for t in ("__half", "__nv_bfloat16"):
            assert re.search(rf"d % 8 != 0 \? (hopper|wg)::by_wide<-1, {t}>", src)
            assert re.search(rf"(hopper|wg)::by_wide<0, {t}>", src)
    assert "using RolesOf = Roles<(D <= NARROW || (D > 192 && P::REGS == 0)), " \
           "(D <= NARROW ? 2 : 1)," in hopper
    assert "static_assert(PREGS * 128 + CREGS * 256 == 168 * 384" in hopper
    assert "(REGS == 0 || REGS == 232 || REGS == 240)" in hopper
    # the roles: one if/else on threadIdx.x < 128 to the kernel's end (a
    # branch on the warpgroup's index broadcast by __shfl_sync made ptxas
    # spill the producer layout at width 256: kernel_splits.py wide)
    assert "__device__ static bool producer() { return !WIDE && threadIdx.x < 128; }" in hopper
    assert "__shfl_sync" not in hopper[hopper.index("struct Roles {"):hopper.index("using RolesOf")]
    for n in (80, 96):            # S = Q K^T over the wide kernels' K/V tiles
        assert f"wgmma.mma_async.sync.aligned.m64n{n}k16.f32." in hopper
        assert f"wgmma_ss_n{n}_first<T>(d, a, b); else wgmma_ss_n{n}<T>(d, a, b);" in hopper
    # the forward's C entry encodes the K/V boxes at the kernel's keys, Q's
    # at q_rows_of them
    assert "const int keys = ordered && wide ? hopper::wide_keys(d) : hopper::keys_of(d);" in fwd
    assert "return 128 % keys == 0 ? keys : 64;" in fwd
    assert all(fa.wgmma_q_rows(k) == (k if 128 % k == 0 else 64) for k in (64, 80, 96, 128))


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
    blocks' work (``heavy``) never rising and its pairs the group's."""
    assert len(set(blocks)) == len(blocks)
    groups = [(bb * hkv + kv_of(h)) // group_kv for h, bb, _ in blocks]
    assert groups == sorted(groups)
    for g in set(groups):
        work = [heavy(x) for (h, bb, x), gg in zip(blocks, groups) if gg == g]
        assert all(a >= c for a, c in zip(work, work[1:]))
        pairs = {bb * hkv + kv_of(h) for (h, bb, _), gg in zip(blocks, groups) if gg == g}
        assert pairs == set(range(g * group_kv, min((g + 1) * group_kv, b * hkv)))


# (B, Sq, Sk, Hq, Hkv, D, dtype, causal offset): Gemma-2-9B's heads at a
# prefill of 4 x 2048 and the same at D 192, then ragged shapes (Sq != Sk,
# offsets, one row over a long cache, the staged 130 and 250)
WALK_SHAPES = [(4, 2048, 2048, 16, 8, 256, torch.bfloat16, 0),
               (4, 2048, 2048, 16, 8, 192, torch.bfloat16, 0),
               (2, 130, 167, 4, 2, 136, torch.float16, 37),
               (3, 300, 300, 6, 3, 250, torch.bfloat16, 0),
               (2, 1, 300, 4, 4, 200, torch.float16, 299),
               (1, 77, 90, 4, 1, 130, torch.bfloat16, 13)]


@pytest.mark.parametrize("shape", WALK_SHAPES, ids=str)
@pytest.mark.parametrize("budget", [fa.L2_KV_BUDGET, 4 * 2**20, 1], ids=["L2", "4MiB", "1B"])
def test_forward_l2_order_walk(shape, budget):
    """The forward's plan (a 1-D grid, ``kv_group``'s KV pairs a group) and
    the kernel's decode at that budget: every query row of every head
    stored once, the groups in order, each group's heaviest query tiles
    first, each group's K and V within the budget."""
    b, sq, sk, hq, hkv, d, dtype, off = shape
    q, k = _meta((b, sq, hq, fa.tma_width(d)), dtype)[..., :d], \
        _meta((b, sk, hkv, fa.tma_width(d)), dtype)[..., :d]
    pl = fa.plan(q, k, k, off)
    tiles = -(-sq // fa.WGMMA_ROWS)
    assert pl.route == "wgmma" and pl.grid == (b * hq * tiles, 1, 1)
    assert pl.group_kv == fa.kv_group(b, sk, hkv, d) > 0
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
    first to last: each dQ row and each dK/dV key written by one block."""
    b, sq, sk, hq, hkv, d, dtype, off = shape
    q, k = _meta((b, sq, hq, fa.tma_width(d)), dtype)[..., :d], \
        _meta((b, sk, hkv, fa.tma_width(d)), dtype)[..., :d]
    pl = fa.plan_bwd(q, k, k, q, q, causal_offset=off)
    q_tiles = -(-sq // fa.BWD_WGMMA_DQ_ROWS)
    k_tiles = -(-sk // fa.BWD_WGMMA_KV_KEYS)
    assert pl.route == "wgmma"
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


def test_groups_at_gemma_2_9b():
    """Gemma-2-9B's heads (16 over 8 KV heads of 256) at B 4: K and V of a
    (batch, KV head) pair are 2 MiB at S 2048, so 4 of the 32 pairs a group
    (8 MiB of the 12.5 MiB budget); at internvl2-2b's train length (S 2304)
    dQ's groups hold 4 pairs, dK/dV's 2 (Q and dO of a pair's two query
    heads: 4.5 MiB); at D 192 8 pairs and 2."""
    assert fa.kv_group(4, 2048, 8, 256) == 4 and fa.kv_group(4, 2304, 8, 256) == 4
    assert fa.rows_group(4, 2304, 16, 8, 256) == 2
    assert fa.kv_group(4, 2048, 8, 192) == 8 and fa.rows_group(4, 2304, 16, 8, 192) == 2


@pytest.mark.parametrize("d", WIDE_DIMS)
def test_wide_tilings_fit_a_block(d):
    """The wide kernels' shared memory, as the sources lay it out, within a
    block's 227 KB: the forward's Q (128 rows) and two stages of K and V
    tiles of ``wide_keys(d)`` keys (64 at width 256, the yardstick's:
    197,688 bytes; 96 at 192: 197,688), dQ's ring of ``wide_dq_keys(d)``
    keys (64 at width 192: two stages, 197,672 bytes), dK/dV's as the
    yardstick's."""
    tile, keys, dq_keys = fa.wgmma_tile_dim(d), fa.wide_keys(d), fa.wide_dq_keys(d)
    row = 2 * tile
    assert fa.wgmma_stages(d, keys) == 2
    fwd = fa.wgmma_smem_bytes(d, keys)
    assert fwd == 1024 + 128 * row + 2 * 2 * keys * row + 8 * 7 <= SMEM_LIMIT
    assert fwd == {256: 197_688, 192: 197_688}[tile] and fwd == fa.wgmma_smem_bytes(tile, keys)
    s_dq, s_kv = fa.bwd_wgmma_stages(d, dq_keys)
    assert (s_dq, s_kv) == ((3, 2) if tile == 256 else (2, 3))
    dq, dkdv = fa.bwd_wgmma_smem_bytes(d, dq_keys)
    assert dq == 1024 + 2 * 128 * row + 2 * s_dq * dq_keys * row + 8 * (1 + 2 * s_dq)
    assert max(dq, dkdv) <= SMEM_LIMIT and dkdv == fa.bwd_wgmma_smem_bytes(d)[1]
    assert (dq, dkdv) == {256: (230_456, 231_464), 192: (197_672, 231_992)}[tile]
    # one more stage would not fit: the rings are as deep as a block allows
    assert 1024 + 128 * row + 2 * 3 * keys * row + 8 * 10 > SMEM_LIMIT
    assert 1024 + 2 * 128 * row + 2 * (s_dq + 1) * dq_keys * row + 8 * (3 + 2 * s_dq) \
        > SMEM_LIMIT
    fwd_src = (CSRC / "flash_attention.cu").read_text()
    assert ("static constexpr int RING = OVERLAP && D == 128 ? 3 : KEYS == keys_of(D) ? STAGES : 2;"
            in fwd_src)
    assert "static constexpr int Q_ROWS = ROWS % KEYS == 0 ? KEYS : 64;" in fwd_src
    bwd_src = (CSRC / "flash_attention_bwd.cu").read_text()
    assert "(232448 - 1024 - 2 * Rows::BYTES - 8) / (2 * Keys::BYTES + 16)" in bwd_src


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 256), (torch.float16, 192),
                                     (torch.bfloat16, 250), (torch.float16, 136)], ids=str)
def test_yardstick_plans(dtype, d):
    """The whole-tile yardsticks keep the grid's order on the tiles' own
    keys (64 past 128: K/V and Q boxes of 64 rows), the tiles' own shared
    memory and 3-D grids; the wide kernels' maps differ only in the K/V
    boxes' rows (96 at width 192; none at 256)."""
    q = _meta((2, 300, 8, fa.tma_width(d)), dtype)[..., :d]
    k = _meta((2, 300, 2, fa.tma_width(d)), dtype)[..., :d]
    pl, yard = fa.plan(q, k, k), fa.plan(q, k, k, kernel="wgmma_tile")
    assert yard.route == "wgmma_tile" and yard.grid == (8, 2, 3) and yard.group_kv == 0
    assert yard.smem == fa.wgmma_smem_bytes(d) and pl.smem == fa.wgmma_smem_bytes(
        d, fa.wide_keys(d))
    assert [yard.maps[11 * i + 9] for i in range(3)] == [64, 64, 64]
    assert [pl.maps[11 * i + 9] for i in range(3)] == [64] + [fa.wide_keys(d)] * 2
    assert [m for i, m in enumerate(yard.maps) if i % 11 != 9] == \
        [m for i, m in enumerate(pl.maps) if i % 11 != 9]
    bpl, byard = fa.plan_bwd(q, k, k, q, q), fa.plan_bwd(q, k, k, q, q, route="wgmma_tile")
    assert byard.route == "wgmma_tile" and byard.groups == (0, 0)
    assert byard.grids == ((8, 2, 3), (2, 2, 5)) and byard.maps == bpl.maps
    assert byard.smem == fa.bwd_wgmma_smem_bytes(d)
    assert bpl.smem == fa.bwd_wgmma_smem_bytes(d, fa.wide_dq_keys(d))


def _kv_tiles(q0, rows, keys, sq, sk, off):
    """``kv_tiles<ROWS, KEYS>``: the K/V tiles the block's rows can see."""
    last = min(q0 + rows, sq) - 1
    return -(-min(sk, off + last + 1) // keys)


@pytest.mark.parametrize("keys", [80, 96, 64])
@pytest.mark.parametrize("shape", [(1, 200, 333, 2, 1, 0), (1, 130, 130, 2, 2, 70),
                                   (2, 257, 170, 2, 1, 0), (1, 1, 300, 2, 1, 299)], ids=str)
def test_forward_loop_model_at_wide_keys(shape, keys):
    """The forward kernel's loop in float64 at K/V tiles of ``keys`` keys:
    per block of 128 query rows its ``kv_tiles`` tiles, masking only the
    tiles that cross the diagonal or the end of K (per consumer's 64 rows),
    the online softmax in the log2 domain; the output equals the plain
    version's arithmetic in float64 within 1e-12."""
    b, sq, sk, hq, hkv, off = shape
    d = 40
    rng = np.random.default_rng(keys + sq)
    q = rng.normal(size=(b, sq, hq, d))
    k, v = rng.normal(size=(b, sk, hkv, d)), rng.normal(size=(b, sk, hkv, d))
    scale_log2 = 1.0 / np.sqrt(d) / np.log(2.0)
    out = np.zeros_like(q)
    group = hq // hkv
    for bb in range(b):
        for h in range(hq):
            for q0 in range(0, sq, 128):
                n_tiles = _kv_tiles(q0, 128, keys, sq, sk, off)
                for c in range(2):
                    r0 = q0 + 64 * c
                    rows = np.arange(r0, r0 + 64)
                    qpos = off + rows
                    first = off + r0
                    m = np.full(64, -1e30)
                    l_ = np.zeros(64)
                    acc = np.zeros((64, d))
                    qr = np.zeros((64, d))
                    live = rows < sq
                    qr[live] = q[bb, rows[live], h]
                    for j in range(n_tiles):
                        k0 = j * keys
                        kk = np.arange(k0, k0 + keys)
                        kt = np.zeros((keys, d))
                        vt = np.zeros((keys, d))
                        inb = kk < sk
                        kt[inb] = k[bb, kk[inb], h // group]
                        vt[inb] = v[bb, kk[inb], h // group]
                        s = qr @ kt.T
                        if not (k0 + keys <= sk and k0 + keys - 1 <= first):
                            s = np.where((kk[None, :] < sk) & (qpos[:, None] >= kk[None, :]),
                                         s, -1e30)
                        else:     # no row of the consumer misses a key of the tile
                            assert ((qpos[:, None] >= kk[None, :]) & inb).all()
                        mx = np.maximum(m, s.max(1))
                        corr = np.exp2((m - mx) * scale_log2)
                        p = np.exp2(s * scale_log2 - (mx * scale_log2)[:, None])
                        l_ = l_ * corr + p.sum(1)
                        acc = acc * corr[:, None] + p @ vt
                        m = mx
                    o = acc / np.maximum(l_, 1e-30)[:, None]
                    out[bb, rows[live], h] = o[live]
    # the plain version's arithmetic (``gqa_flash_plain``) in float64
    qg = q.reshape(b, sq, hkv, group, d)
    s = np.einsum("bqhgd,bkhd->bhgqk", qg, k) / np.sqrt(d)
    s = np.where((off + np.arange(sq))[:, None] >= np.arange(sk)[None, :], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = np.einsum("bhgqk,bkhd->bqhgd", p, v).reshape(b, sq, hq, d)
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-12)


def _rounded(rng, shapes, dtype):
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dtype) for s in shapes]


@pytest.mark.parametrize("dtype", HALF, ids=str)
@pytest.mark.parametrize("d", [192, 256])
def test_plain_forward_matches_pallas(d, dtype):
    """The plain forward (what the wide kernels compute; ``chip_smoke.py``
    holds them to it on the card) against the reference's Pallas kernel in
    interpret mode and ``flash_attention_ref`` on the same rounded inputs,
    Sq != Sk, an offset: within 5e-2 in bf16 (the reference's kernel
    tolerance, ``tests/test_kernels.py``) and 1e-2 in fp16."""
    b, sq, sk, hq, hkv, off = 1, 37, 70, 4, 2, 33
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-2
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16
    q, k, v = _rounded(np.random.default_rng(d), ((b, sq, hq, d), (b, sk, hkv, d),
                                                  (b, sk, hkv, d)), dtype)
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jdt) for t in (q, k, v))
    pallas = ops.flash_attention(jq, jk, jv, causal_offset=off, interpret=True,
                                 block_q=64, block_k=64)
    expect = ref.flash_attention_ref(jq, jk, jv, causal_offset=off)
    out = fa.gqa_flash(q, k, v, causal_offset=off)
    assert out.dtype == dtype and out.shape == q.shape
    for want in (pallas, expect):
        np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", HALF, ids=str)
@pytest.mark.parametrize("d", [192, 256])
def test_lse_backward_matches_jax_vjp(d, dtype):
    """The wide backward's plain version (P from the LSE, P and dS rounded to
    the inputs' type where the kernels round them) against ``jax.vjp`` of
    the reference's ``chunked_attention`` on the same rounded inputs in
    fp32: within 5e-2 elementwise and 1e-2 relative L2, as on the wgmma
    route's other head dims (``tests/test_torch_flash_bwd_wgmma.py``); the
    plain LSE against ``jax.nn.logsumexp`` of the reference's scores
    within 1e-5."""
    b, sq, sk, hq, hkv, off = 1, 37, 70, 4, 2, 33
    q, k, v, do = _rounded(np.random.default_rng(d + 7),
                           ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, hq, d)),
                           dtype)
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
    qg = q32.reshape(b, sq, hkv, hq // hkv, d)
    s = jnp.einsum("bqhgd,bkhd->bhgqk", qg, k32) / np.sqrt(d)
    mask = (off + jnp.arange(sq))[:, None] >= jnp.arange(sk)[None, :]
    jl = jax.nn.logsumexp(jnp.where(mask, s, -1e30), axis=-1).reshape(b, hq, sq)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
