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
# dim four times; then zamba2-7b's head dim 112, and 16 (the tiny trainer of
# repro_torch.examples.train_carbon_aware).
CASES = [
    (1, 0, 2, 1, 32), (1, 37, 4, 2, 64), (1, 200, 8, 4, 128),
    (17, 0, 4, 2, 128), (17, 37, 8, 4, 32), (17, 200, 2, 1, 64),
    (64, 0, 8, 4, 64), (64, 37, 2, 1, 128), (64, 200, 4, 2, 32),
    (130, 0, 2, 1, 128), (130, 37, 4, 2, 32), (130, 200, 8, 4, 64),
    (130, 0, 4, 1, 112), (17, 37, 4, 2, 112),
    (1, 200, 4, 2, 16), (130, 37, 4, 2, 16), (64, 0, 2, 1, 16),
]
BF16_CASES = [(1, 200, 8, 4, 128), (64, 0, 4, 2, 64), (130, 37, 2, 1, 32),
              (130, 0, 4, 1, 112), (128, 0, 4, 2, 16), (17, 200, 2, 1, 16)]


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



# --- routing and launch arithmetic of the CUDA kernels (runs on any tensor) --

@pytest.mark.parametrize("dtype,d,kernel", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 112, "wgmma"),
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 32, "wgmma"),
    (torch.bfloat16, 16, "wgmma"),
    (torch.float32, 128, "fp32"), (torch.float32, 112, "fp32"),
    (torch.float32, 64, "fp32"), (torch.float32, 32, "fp32"), (torch.float32, 16, "fp32")])
def test_route_depends_on_dtype_and_head_dim(dtype, d, kernel):
    assert fa.route(dtype, d) == kernel
    q = torch.zeros((1, 3, 4, d), dtype=dtype)
    k = torch.zeros((1, 5, 2, d), dtype=dtype)
    assert fa.plan(q, k, k, causal_offset=2).route == kernel


@pytest.mark.parametrize("dtype,d", [(torch.float16, 257), (torch.bfloat16, 0),
                                     (torch.int32, 64)])
def test_route_rejects_what_no_kernel_takes(dtype, d):
    """Every float dtype at every head dim 1..256 has a kernel; a head dim
    past 256, an empty one or an integer dtype has none."""
    with pytest.raises(ValueError, match="no kernel"):
        fa.route(dtype, d)


def _bf16(*shape):
    return torch.empty(shape, dtype=torch.bfloat16)


def test_plan_llama3_prefill():
    """The prefill's shape: 4-D maps over (D, H, S, B) with byte strides,
    two 64-column boxes per 128-row tile, grid (Hq, B, Sq / 128)."""
    q, k, v = _bf16(4, 2048, 32, 128), _bf16(4, 2048, 8, 128), _bf16(4, 2048, 8, 128)
    pl = fa.plan(q, k, v)
    assert pl.route == "wgmma" and pl.grid == (32, 4, 16)
    assert pl.maps == (128, 32, 2048, 4, 256, 8192, 16777216, 64, 1, 128, 1,
                       128, 8, 2048, 4, 256, 2048, 4194304, 64, 1, 128, 1,
                       128, 8, 2048, 4, 256, 2048, 4194304, 64, 1, 128, 1)
    # Q tile 32 KB + 2 stages of K and V (64 KB each) + 7 mbarriers + 1 KB slack.
    assert pl.smem == 1024 + 32768 + 2 * 65536 + 8 * 7 == 164920
    assert pl.smem <= 232448                   # what a block may ask for


@pytest.mark.parametrize("sq,d,grid_z,smem", [(1, 64, 1, 1024 + 16384 + 3 * 32768 + 80),
                                              (128, 128, 1, 164920),
                                              (129, 128, 2, 164920),
                                              (2047, 64, 16, 115792)])
def test_plan_grid_and_shared_memory(sq, d, grid_z, smem):
    pl = fa.plan(_bf16(2, sq, 8, d), _bf16(2, sq + 200, 2, d), _bf16(2, sq + 200, 2, d),
                 causal_offset=200)
    assert pl.grid == (8, 2, grid_z) and pl.smem == smem
    assert pl.maps[2] == sq and pl.maps[13] == pl.maps[24] == sq + 200


def test_plan_zamba2_forward_at_head_dim_112():
    """zamba2-7b's shared attention (d_model 3584 over 32 heads): D = 112
    stays the maps' innermost extent (H stride 224 bytes, a multiple of 16,
    as TMA requires), on the D = 128 kernel's tiles, ring and shared
    memory."""
    q, k, v = (_bf16(4, 2048, 32, 112) for _ in range(3))
    pl = fa.plan(q, k, v)
    assert pl.route == "wgmma" and pl.grid == (32, 4, 16)
    one = (112, 32, 2048, 4, 224, 32 * 224, 2048 * 32 * 224, 64, 1, 128, 1)
    assert pl.maps == one * 3
    assert all(s % 16 == 0 for s in one[4:7])
    assert fa.WGMMA_TILE_DIM[112] == 128 and fa.wgmma_stages(112) == 2
    assert pl.smem == fa.wgmma_smem_bytes(128) == 164920


@pytest.mark.parametrize("b,sq,hq", [(4, 2048, 32), (2, 130, 3), (1, 1, 2)])
def test_wgmma_head_dim_112_walk_covers_each_output_once(b, sq, hq):
    """The D = 112 launch walked as the kernel walks it: each block (h, b,
    z) owns query rows q0 = (Z - 1 - z) * 128 onward; its two consumer
    warpgroups' threads (warp w, lane 4g + t) store rows q0 + 64c + 16w + g
    (+ 8) below Sq, columns 8n + 2t and 8n + 2t + 1 for n < 112 / 8.  Every
    output element is stored once and no column at or past 112; the two
    64-column boxes of a tile load columns 0..127, of which TMA fills those
    at or past the maps' extent 112 with zeros."""
    d = 112
    q = _bf16(b, sq, hq, d)
    pl = fa.plan(q, q, q)
    hits = np.zeros((b, sq, hq, 128), dtype=np.int64)
    gx, gy, gz = pl.grid
    c, w, g, t, r, n = np.meshgrid(np.arange(2), np.arange(4), np.arange(8), np.arange(4),
                                   np.arange(2), np.arange(d // 8), indexing="ij")
    for z in range(gz):
        q0 = (gz - 1 - z) * fa.WGMMA_ROWS
        rows = (q0 + 64 * c + 16 * w + g + 8 * r).ravel()
        cols = (8 * n + 2 * t).ravel()
        keep = rows < sq
        for h in range(gx):
            for bb in range(gy):
                for col in (cols[keep], cols[keep] + 1):
                    np.add.at(hits, (bb, rows[keep], h, col), 1)
    assert (hits[..., :d] == 1).all() and not hits[..., d:].any()
    extent, box = pl.maps[0], pl.maps[7]
    loaded = np.arange(fa.WGMMA_TILE_DIM[d] // box * box)
    assert extent == d and set(loaded[loaded < extent]) == set(range(d))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,sq,hq,d", [(4, 128, 4, 16), (2, 130, 3, 16), (1, 1, 2, 16),
                                       (2, 65, 4, 32)])
def test_mma_sync_and_fp32_walk_covers_each_output_once(dtype, b, sq, hq, d):
    """The mma.sync (bf16, by name: the yardstick) and fp32 launches walked
    as the kernels walk them, at the tiny trainer's head dim 16 and at 32:
    mma.sync: the grid
    (ceil(Sq / 64), Hq, B), block (x, h, b) owns rows 64x + 16w + g (+ 8) of
    warp w < 4, lane 4g + t, each storing columns 8n + 2t and 8n + 2t + 1 for
    n < D / 8; fp32 (the tiled kernel): the grid (Hq, B, ceil(Sq / 128)),
    block (h, b, z) owns rows 128 (gz - 1 - z) + 8 ty + i (i < 8), thread
    (ty, tx) of 16 x 16 columns tx + 16j (j < D / 16).  Each stores only rows
    below Sq; every output element is stored once."""
    q = torch.zeros((b, sq, hq, d), dtype=dtype)
    k = torch.zeros((b, 3, 1, d), dtype=dtype)
    pl = fa.plan(q, k, k, kernel="mma_sync" if dtype == torch.bfloat16 else None)
    assert pl.route == ("mma_sync" if dtype == torch.bfloat16 else "fp32")
    assert pl.maps is None
    if pl.route == "fp32":
        assert pl.grid == (hq, b, -(-sq // 128)) and pl.smem == fa.tiled_fwd_tiling(d).smem
        ty, tx, i, j = np.meshgrid(np.arange(16), np.arange(16), np.arange(8),
                                   np.arange(d // 16), indexing="ij")
        rows, cols = (8 * ty + i).ravel(), (tx + 16 * j).ravel()
        hits = np.zeros((b, sq, hq, d), dtype=np.int64)
        for z in range(pl.grid[2]):
            r = (pl.grid[2] - 1 - z) * 128 + rows
            keep = r < sq
            for h in range(hq):
                for bb in range(b):
                    np.add.at(hits, (bb, r[keep], h, cols[keep]), 1)
        assert (hits == 1).all()
        return
    assert pl.grid == (-(-sq // fa.FWD_ROWS), hq, b)
    gx, gy, gz = pl.grid
    if pl.route == "mma_sync":
        w, g, t, r, n = np.meshgrid(np.arange(4), np.arange(8), np.arange(4), np.arange(2),
                                    np.arange(d // 8), indexing="ij")
        rows = (16 * w + g + 8 * r).ravel()
        cols = [(8 * n + 2 * t).ravel(), (8 * n + 2 * t + 1).ravel()]
    else:
        ty, tx, i, j = np.meshgrid(np.arange(16), np.arange(16), np.arange(4),
                                   np.arange(d // 16), indexing="ij")
        rows, cols = (ty + 16 * i).ravel(), [(tx + 16 * j).ravel()]
    hits = np.zeros((b, sq, hq, d), dtype=np.int64)
    for x in range(gx):
        r = x * fa.FWD_ROWS + rows
        keep = r < sq
        for h in range(gy):
            for bb in range(gz):
                for c in cols:
                    np.add.at(hits, (bb, r[keep], h, c[keep]), 1)
    assert (hits == 1).all()


def test_plan_strided_views():
    """The card test's strided views: q, k and v cut out of one packed
    (B, S, 3, H, D) tensor keep their strides in the maps, in bytes."""
    qkv = _bf16(2, 70, 3, 8, 64)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1, :4], qkv[:, :, 2, :4]
    pl = fa.plan(q, k, v, causal_offset=5)
    row, batch = 3 * 8 * 64 * 2, 70 * 3 * 8 * 64 * 2
    assert pl.maps[:11] == (64, 8, 70, 2, 128, row, batch, 64, 1, 128, 1)
    assert pl.maps[11:22] == pl.maps[22:] == (64, 4, 70, 2, 128, row, batch, 64, 1, 128, 1)
    assert pl.grid == (8, 2, 1)


def test_plan_rejects_strides_and_starts_off_16_bytes():
    q = _bf16(1, 10, 2, 132)[..., :128]        # rows 264 bytes apart
    k = _bf16(1, 10, 2, 128)
    with pytest.raises(ValueError, match="multiples of 8 elements"):
        fa.plan(q, k, k)
    flat = torch.empty(10 * 2 * 128 + 4, dtype=torch.bfloat16)
    shifted = flat[4:].view(1, 10, 2, 128)     # starts 8 bytes past 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.plan(shifted, k, k)
    with pytest.raises(ValueError, match="unit stride"):
        fa.plan(k.transpose(1, 3).contiguous().transpose(1, 3), k, k)


def test_plan_named_kernel():
    q, k = _bf16(1, 8, 4, 128), _bf16(1, 8, 2, 128)
    assert fa.plan(q, k, k, kernel="mma_sync") == fa.Plan("mma_sync", grid=(1, 4, 1))
    with pytest.raises(ValueError, match="does not take"):
        fa.plan(q.float(), k.float(), k.float(), kernel="wgmma")
    with pytest.raises(ValueError, match="does not take"):
        fa.plan(q.float(), k.float(), k.float(), kernel="mma_sync")


def test_launch_needs_cuda_and_counts_stay_zero_on_cpu():
    q = torch.zeros((1, 4, 2, 64), dtype=torch.bfloat16)
    fa.reset_launches()
    fa.gqa_flash(q, q, q)                      # CPU tensors: the plain version
    assert fa.launches == {"gqa_flash": 0, "wgmma": 0, "mma_sync": 0, "fp32": 0,
                           "fp32_simple": 0, "gqa_flash_bwd": 0, "bwd_stats": 0,
                           "bwd_dkdv": 0, "bwd_dq": 0, "bwd_wgmma_dq": 0, "bwd_wgmma_dkdv": 0,
                           "bwd_mma_dq": 0, "bwd_mma_dkdv": 0, "bwd_tiled_dq": 0,
                           "bwd_tiled_dkdv": 0, "layout_copy": 0}
    with pytest.raises(ValueError, match="CUDA device"):
        fa.launch(q, q, q)


def test_tiling_constants_match_the_cuda_source():
    """The wrapper's tiling and shared memory are those the kernel's source
    declares (the launch also checks the shared memory on the card)."""
    import re
    from pathlib import Path

    csrc = Path(fa.__file__).resolve().parents[1] / "csrc"
    # the kernel's source, then the Hopper building blocks it includes
    src = (csrc / "flash_attention.cu").read_text() + (csrc / "hopper.cuh").read_text()
    hopper = src[src.index("namespace hopper {"):]
    const = {n: int(v) for n, v in re.findall(r"constexpr int (\w+) = (\d+);", hopper)}
    assert const["ROWS"] == fa.WGMMA_ROWS and const["KEYS"] == fa.WGMMA_KEYS
    assert const["BOX"] == fa.TMA_BOX_COLS
    assert "STAGES = D <= NARROW ? 4 : D == 64 || D == 192 ? 3 : 2;" in hopper
    assert const["NARROW"] == fa.WGMMA_NARROW and fa.WGMMA_NARROW_STAGES == 4
    assert (fa.wgmma_stages(128), fa.wgmma_stages(64), fa.wgmma_stages(32)) == (2, 3, 4)
    # the Hopper entry point runs D = 112 on the D = 128 tiles
    assert "case 112:\n      return static_cast<int>(hopper::launch<128, 112>(" in src
    assert fa.WGMMA_TILE_DIM == {64: 64, 112: 128, 128: 128}
