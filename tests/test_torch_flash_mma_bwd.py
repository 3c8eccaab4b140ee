"""Every 16-bit head dim of ``gqa_flash`` on tensor cores, on the CPU.

bf16 and fp16 take the Hopper (wgmma) route at every D, a multiple of 8
or not; at D <= 32 the mma.sync forward and the "mma" backward run by name,
the yardsticks: two mma.sync kernels (``csrc/flash_attention_bwd.cu``,
namespace ``mm``) that read the LSE the forward writes.  TMA needs byte strides that
are multiples of 16, so at a D off a multiple of 8 the wrapper stages each
input into rows ``tma_width(D)`` wide and hands the kernels the [..., :D]
view.  Here, without a card:

- the route table at every (dtype, D);
- staging at D 36 and 250: the views TMA reads, their maps' extent D, one
  counted layout copy each, none for an input TMA reads as it lies;
- the plain LSE path the kernels are held to on the card
  (``gqa_flash_lse_plain`` + ``gqa_flash_bwd_lse_plain(round_bf16=True)``)
  against ``jax.vjp`` of the reference's ``chunked_attention`` and of
  ``kernels/ref.py::flash_attention_ref`` at bf16 and fp16, D 16, 24, 36 and
  250, inputs from one numpy seed rounded to the type: within 1e-2 relative
  L2 and 5e-2 elementwise (P and dS rounded to the 16-bit type, as the
  kernels round them, and the gradients rounded once; bf16 keeps 8 bits, a
  relative 2^-9 a value, fp16 11);
- a float64 model of the mma kernels' loops (the blocks' tiles, the tiles a
  warp skips, the tiles it masks, zero-filled rows and keys past Sq and Sk)
  against the plain version;
- ``kernel_work``'s products and bytes by route, the staged copies' bytes
  included; the mma kernels' tiling against the CUDA source.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.ref import flash_attention_ref
from repro.models.common import chunked_attention as jchunked_attention
from repro_torch.kernels import flash_attention as fa

HALF = {"bfloat16": torch.bfloat16, "float16": torch.float16}
ROUNDED_REL, ROUNDED_TOL = 1e-2, 5e-2
# (B, Sq, Sk, Hq, Hkv, causal offset): Sq != Sk, a group of 2, ragged tiles
SHAPE = (1, 37, 70, 4, 2, 33)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, sq, sk, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, hq, d))]


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_route_table_of_every_16_bit_head_dim():
    for d in range(1, 257):
        for dtype in HALF.values():
            # every D on the Hopper kernels; mma.sync and "mma" only by name
            assert (fa.route(dtype, d), fa.bwd_route(dtype, d)) == ("wgmma", "wgmma")
            # the Hopper kernel's tiles: 16 or 32 wide at D <= 32, else the
            # least multiple of 64 that holds D
            tile = fa.wgmma_tile_dim(d)
            if d > 32:
                assert tile % 64 == 0 and tile - 64 < d <= tile
            else:
                assert tile == (16 if d <= 16 else 32)
        for dtype in (torch.float32, torch.float64):
            assert (fa.route(dtype, d), fa.bwd_route(dtype, d)) == ("fp32", "tiled")
    for (dtype, d), kernel in fa.ROUTES.items():       # the pinned pairs stay
        assert fa.route(dtype, d) == kernel
    assert fa.tma_width(250) == 256 and fa.tma_width(36) == 40 and fa.tma_width(96) == 96


@pytest.mark.parametrize("dtype", list(HALF.values()), ids=str)
@pytest.mark.parametrize("d", [36, 250])
def test_staging_gives_tma_views_of_extent_d(d, dtype):
    b, sq, sk, hq, hkv, off = SHAPE
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in _inputs(b, sq, sk, hq, hkv, d, 1))
    assert not fa._tma_ready(q)                     # rows of 2D bytes: no multiple of 16
    fa.reset_launches()
    staged = [fa._readable_copy(t, "wgmma") for t in (q, k, v, do)]
    assert fa.launches["layout_copy"] == 4
    for t, s in zip((q, k, v, do), staged):
        assert fa._tma_ready(s) and s.shape == t.shape and torch.equal(s, t)
        assert s.stride() == (t.shape[1] * t.shape[2] * fa.tma_width(d),
                              t.shape[2] * fa.tma_width(d), fa.tma_width(d), 1)
        assert fa._readable_copy(s, "wgmma") is s    # read as it lies: no second copy
    assert fa.launches["layout_copy"] == 4
    pl = fa.plan(*staged[:3], causal_offset=off)
    keys = fa.wide_keys(d) if fa.wide_kernel(dtype, d) else None   # 250: the wide kernels'
    assert pl.route == "wgmma" and pl.smem == fa.wgmma_smem_bytes(d, keys)
    for i in range(3):                              # extent D, byte strides of 16
        assert pl.maps[11 * i] == d and all(s % 16 == 0 for s in pl.maps[11 * i + 4:11 * i + 7])
    o = fa.gqa_flash_plain(q, k, v, off)
    bp = fa.plan_bwd(*staged[:3], o, staged[3], causal_offset=off)
    assert bp.route == "wgmma" and [bp.maps[11 * i] for i in range(4)] == [d] * 4
    # o stays as the forward wrote it: the D_i pass reads the contiguous rows
    with pytest.raises(ValueError, match="multiples of 8 elements"):
        fa.plan(q, k, v)
    with pytest.raises(ValueError, match="layout"):
        fa.plan_bwd(*staged[:3], o, do)
    # dO in rows wider than tma_width(D): TMA reads it, the D_i pass would not
    wide = torch.zeros((b, sq, hq, 2 * fa.tma_width(d)), dtype=dtype)[..., :d]
    assert fa._tma_ready(wide)
    with pytest.raises(ValueError, match="layout"):
        fa.plan_bwd(*staged[:3], o, wide)


@pytest.mark.parametrize("dtype", list(HALF))
@pytest.mark.parametrize("d", [16, 24, 36, 250])
def test_lse_path_matches_jax_vjp(d, dtype):
    b, sq, sk, hq, hkv, off = SHAPE
    tdt = HALF[dtype]
    q, k, v, do = (torch.from_numpy(a).to(tdt) for a in _inputs(b, sq, sk, hq, hkv, d, 7))
    o = fa.gqa_flash_plain(q, k, v, off)
    lse = fa.gqa_flash_lse_plain(q, k, off)
    got = fa.gqa_flash_bwd_lse_plain(q, k, v, o, do, lse, off, round_bf16=True)
    q32, k32, v32, do32 = (jnp.asarray(t.float().numpy()) for t in (q, k, v, do))
    for fn in (lambda a, b_, c: jchunked_attention(a, b_, c, off, 16),
               lambda a, b_, c: flash_attention_ref(a, b_, c, off)):
        _, vjp = jax.vjp(fn, q32, k32, v32)
        for g, w in zip(got, vjp(do32)):
            w = np.asarray(w)
            assert g.dtype == tdt and g.shape == w.shape
            np.testing.assert_allclose(g.float().numpy(), w, rtol=ROUNDED_TOL, atol=ROUNDED_TOL)
            assert _rel_l2(g.float().numpy(), w) <= ROUNDED_REL


def _mma_model(q, k, v, o, do, lse, off):
    """The mma route's two kernels' loops in float64: dQ blocks of 64 rows
    over the key tiles they need, a warp's 16 rows skipping the tiles none of
    them sees and masking those that cross the diagonal or the end of K;
    dK/dV blocks of 64 keys over the group's 64-row query tiles from the one
    holding the first row that sees the block's first key, a warp's 16 keys
    skipping the tiles none of its keys is seen in (or past Sk) and masking
    the rest unless every (key, row) pair is live.  Rows past Sq and keys
    past Sk load as zeros, their LSE and D_i as 0."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g, scale = hq // hkv, 1.0 / math.sqrt(d)
    q, k, v, o, do, lse = (t.double() for t in (q, k, v, o, do, lse))
    dvec = (do * o).sum(-1).permute(0, 2, 1)        # (B, Hq, Sq)

    def rows(t, h, r0, n):
        out = torch.zeros((b, 64, d), dtype=torch.float64)
        m = max(0, min(64, n - r0))
        out[:, :m] = t[:, r0:r0 + m, h]
        return out

    def stats(x, h, r0):
        out = torch.zeros((b, 64), dtype=torch.float64)
        m = max(0, min(64, sq - r0))
        out[:, :m] = x[:, h, r0:r0 + m]
        return out

    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for h in range(hq):
        for q0 in range(0, sq, 64):
            last = min(q0 + 64, sq) - 1
            n_tiles = -(-min(sk, off + last + 1) // 64)
            qt, dot = rows(q, h, q0, sq), rows(do, h, q0, sq)
            lse_t, di_t = stats(lse, h, q0), stats(dvec, h, q0)
            acc = torch.zeros((b, 64, d), dtype=torch.float64)
            for j in range(n_tiles):
                k0 = 64 * j
                kt, vt = rows(k, h // g, k0, sk), rows(v, h // g, k0, sk)
                for w in range(4):
                    first = off + q0 + 16 * w
                    if k0 > first + 15:
                        continue
                    sl = slice(16 * w, 16 * w + 16)
                    s = torch.einsum("brd,bkd->brk", qt[:, sl], kt) * scale
                    p = torch.exp(s - lse_t[:, sl, None])
                    if not (k0 + 64 <= sk and k0 + 63 <= first):
                        key = k0 + torch.arange(64)[None, :]
                        pos = first + torch.arange(16)[:, None]
                        p = torch.where((key < sk) & (pos >= key), p, 0.0)
                    ds = p * (torch.einsum("brd,bkd->brk", dot[:, sl], vt) - di_t[:, sl, None])
                    acc[:, sl] += torch.einsum("brk,bkd->brd", ds, kt)
            m = min(64, sq - q0)
            dq[:, q0:q0 + m, h] = (acc * scale)[:, :m]
    n_q = -(-sq // 64)
    for hk in range(hkv):
        for k0 in range(0, sk, 64):
            first_row = max(0, k0 - off)
            t0 = n_q if first_row >= sq else first_row // 64
            kt, vt = rows(k, hk, k0, sk), rows(v, hk, k0, sk)
            acc_k = torch.zeros((b, 64, d), dtype=torch.float64)
            acc_v = torch.zeros((b, 64, d), dtype=torch.float64)
            for j in range(g * (n_q - t0)):
                h, r0 = hk * g + j // (n_q - t0), (t0 + j % (n_q - t0)) * 64
                qt, dot = rows(q, h, r0, sq), rows(do, h, r0, sq)
                lse_t, di_t = stats(lse, h, r0), stats(dvec, h, r0)
                first = off + r0
                for w in range(4):
                    kw = k0 + 16 * w
                    if first + 63 < kw or kw >= sk:
                        continue
                    sl = slice(16 * w, 16 * w + 16)
                    st = torch.einsum("bkd,brd->bkr", kt[:, sl], qt) * scale
                    pt = torch.exp(st - lse_t[:, None, :])
                    if not (r0 + 64 <= sq and kw + 15 < sk and first >= kw + 15):
                        key = kw + torch.arange(16)[:, None]
                        row = r0 + torch.arange(64)[None, :]
                        pt = torch.where((key < sk) & (row < sq) & (off + row >= key), pt, 0.0)
                    dst = pt * (torch.einsum("bkd,brd->bkr", vt[:, sl], dot) - di_t[:, None, :])
                    acc_v[:, sl] += torch.einsum("bkr,brd->bkd", pt, dot)
                    acc_k[:, sl] += torch.einsum("bkr,brd->bkd", dst, qt)
            m = min(64, sk - k0)
            dk[:, k0:k0 + m, hk] = (acc_k * scale)[:, :m]
            dv[:, k0:k0 + m, hk] = acc_v[:, :m]
    return dq, dk, dv


@pytest.mark.parametrize("shape", [(1, 200, 200, 4, 2, 16, 0), (1, 5, 300, 2, 1, 16, 290),
                                   (1, 130, 65, 2, 2, 32, 0), (1, 3, 200, 2, 2, 24, 3),
                                   (2, 150, 170, 4, 1, 5, 40), (1, 70, 260, 2, 2, 32, 200)],
                         ids=str)
def test_mma_loops_model_matches_plain(shape):
    b, sq, sk, hq, hkv, d, off = shape
    q, k, v, do = map(torch.from_numpy, _inputs(b, sq, sk, hq, hkv, d, 5))
    o = fa.gqa_flash_plain(q, k, v, off)
    lse = fa.gqa_flash_lse_plain(q, k, off)
    got = _mma_model(q, k, v, o, do, lse, off)
    want = fa.gqa_flash_bwd_lse_plain(q, k, v, o, do, lse, off)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,d,products,staged", [
    (torch.bfloat16, 16, 7, False), (torch.float16, 24, 7, False),
    (torch.bfloat16, 36, 7, True), (torch.float16, 250, 7, True),
    (torch.bfloat16, 128, 7, False), (torch.float32, 16, 7, False),
    (torch.float32, 250, 7, False), (torch.float64, 36, 7, False)], ids=str)
def test_kernel_work_by_route(dtype, d, products, staged):
    b, sq, sk, hq, hkv, off = SHAPE
    q = torch.empty((b, sq, hq, d), dtype=dtype, device="meta")
    k = torch.empty((b, sk, hkv, d), dtype=dtype, device="meta")
    pairs = sum(min(off + i + 1, sk) for i in range(sq))
    product = 2 * d * hq * b * pairs
    qb, kb = q.numel() * q.element_size(), k.numel() * k.element_size()
    rows = 4 * b * hq * sq
    flops, nbytes = fa.kernel_work(q, k, off, False, lse=True)
    assert flops == 2 * product
    assert nbytes == 2 * qb + 2 * kb + rows + (2 * (qb + 2 * kb) if staged else 0)
    flops, nbytes = fa.kernel_work(q, k, off, True)
    assert flops == products * product
    assert nbytes == 4 * qb + 6 * kb + 2 * rows + (2 * qb if staged else 0)


def test_mma_tiling_constants_match_the_cuda_source():
    src = (Path(fa.__file__).resolve().parents[1] / "csrc"
           / "flash_attention_bwd.cu").read_text()
    mm = src[src.index("namespace mm {"):src.index("}  // namespace mm")]

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", mm).group(1))

    assert (const("ROWS"), const("KEYS"), 32 * const("WARPS")) == (
        fa.BWD_MMA_ROWS, fa.BWD_MMA_KEYS, fa.BWD_MMA_THREADS)
    assert "return sizeof(uint16_t) * 6 * ROWS * (DP + 8);" in mm
    assert "return dq_smem_bytes<DP>() + sizeof(float) * 2 * 2 * ROWS;" in mm
    assert "d <= 16 ? mm::launch<__half, 16>" in src      # padded widths 16 and 32
    assert fa.BWD_MMA_KERNELS == ("bwd_mma_dq", "bwd_mma_dkdv")
    fwd = (Path(fa.__file__).resolve().parents[1] / "csrc" / "flash_attention.cu").read_text()
    # flash_mma_kernel writes the natural LSE the mma route reads
    assert "= m[r] + logf(l[r]);" in fwd
