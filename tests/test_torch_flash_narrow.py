"""``gqa_flash`` at 16-bit head dims <= 32 on the Hopper kernels' narrow
tiles, on the CPU.

bf16 and fp16 at D <= 32 run the wgmma kernels of every other 16-bit D
(``csrc/flash_attention.cu`` namespace ``hopper``, ``csrc/flash_attention_bwd.cu``
namespace ``wg``) on tiles 16 (D <= 16) or 32 (D in 17..32) columns wide:
TMA boxes as wide as the tile under the 32- or 64-byte swizzle, wgmma
descriptors of the matching layout, O += P V at N 16 or 32, no producer
warpgroup and two blocks an SM (``hopper.cuh::RolesOf``).  The mma.sync
forward and the "mma" backward they replaced run only by name.  Here,
without a card, at bf16 and fp16 D 1, 5, 8, 16, 24 and 32 on inputs drawn
with numpy from one seed:

- the forward (the plain version, what the kernel is held to on the card)
  against the reference's Pallas ``gqa_flash`` in interpret mode and
  ``kernels/ref.py::flash_attention_ref``, and the plain LSE path
  (``gqa_flash_lse_plain``, ``gqa_flash_bwd_lse_plain`` rounding P and dS as
  the kernels do) against ``jax.vjp`` of the reference's
  ``chunked_attention`` and of ``flash_attention_ref``: within 1e-2 relative
  L2 and 5e-2 elementwise (``tests/test_torch_flash_mma_bwd.py``'s limits:
  bf16 keeps 8 bits, a relative 2^-9 a rounded value, fp16 11; the outputs
  and gradients are of order 1 on unit-normal inputs);
- the route tables, the tensor maps' box widths and swizzle codes, the
  plans' shared memory (two blocks an SM), a walk of the three kernels'
  grids storing each output element once at ragged Sq / Sk and causal
  offsets, a float64 model of the narrow loops (the forward's tile order,
  masks, online softmax in the log2 domain and LSE; the dQ and dK/dV
  accumulations) against the plain versions, ``kernel_work``'s seven
  products, and the constants against the CUDA sources.
"""
import math
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

HALF = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float16": (torch.float16, jnp.float16)}
NARROW_DIMS = (1, 5, 8, 16, 24, 32)
REL, TOL = 1e-2, 5e-2
# (B, Sq, Sk, Hq, Hkv, causal offset): Sq != Sk, a group of 2, ragged tiles
SHAPE = (1, 37, 70, 4, 2, 33)
SMEM_LIMIT = 232_448           # a block's dynamic shared memory on an H100
SM_SMEM = 233_472              # an SM's shared memory, 1 KB of it reserved per block
CSRC = Path(fa.__file__).resolve().parents[1] / "csrc"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, d, seed):
    b, sq, sk, hq, hkv, _ = shape
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, hq, d))]


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# --- against the JAX package -----------------------------------------------------

@pytest.mark.parametrize("dtype", list(HALF))
@pytest.mark.parametrize("d", NARROW_DIMS)
def test_forward_matches_pallas_and_ref(d, dtype):
    tdt, jdt = HALF[dtype]
    q, k, v, _ = _inputs(SHAPE, d, seed=d)
    off = SHAPE[-1]
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    pallas = ops.flash_attention(jq, jk, jv, causal_offset=off, interpret=True,
                                 block_q=64, block_k=64)
    expect = ref.flash_attention_ref(jq, jk, jv, causal_offset=off)
    out = fa.gqa_flash(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal_offset=off)
    assert out.dtype == tdt and out.shape == q.shape
    for want in (pallas, expect):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(out.float().numpy(), want, rtol=TOL, atol=TOL)
        assert _rel_l2(out.float().numpy(), want) <= REL


@pytest.mark.parametrize("dtype", list(HALF))
@pytest.mark.parametrize("d", NARROW_DIMS)
def test_lse_backward_matches_jax_vjp(d, dtype):
    tdt = HALF[dtype][0]
    b, sq, sk, hq, hkv, off = SHAPE
    q, k, v, do = (torch.from_numpy(a).to(tdt) for a in _inputs(SHAPE, d, seed=d + 7))
    o = fa.gqa_flash_plain(q, k, v, off)
    lse = fa.gqa_flash_lse_plain(q, k, off)
    got = fa.gqa_flash_bwd_lse_plain(q, k, v, o, do, lse, off, round_bf16=True)
    q32, k32, v32, do32 = (jnp.asarray(t.float().numpy()) for t in (q, k, v, do))
    for fn in (lambda a, b_, c: jchunked_attention(a, b_, c, off, 16),
               lambda a, b_, c: ref.flash_attention_ref(a, b_, c, off)):
        _, vjp = jax.vjp(fn, q32, k32, v32)
        for g, w in zip(got, vjp(do32)):
            w = np.asarray(w)
            assert g.dtype == tdt and g.shape == w.shape
            np.testing.assert_allclose(g.float().numpy(), w, rtol=TOL, atol=TOL)
            assert _rel_l2(g.float().numpy(), w) <= REL


# --- routes, maps, plans ----------------------------------------------------------

def test_route_table_and_yardsticks_by_name():
    for d in range(1, fa.MAX_HEAD_DIM + 1):
        for dtype in (torch.bfloat16, torch.float16):
            assert (fa.route(dtype, d), fa.bwd_route(dtype, d)) == ("wgmma", "wgmma")
            q = torch.empty((1, 3, 4, d), dtype=dtype, device="meta")
            k = torch.empty((1, 5, 2, d), dtype=dtype, device="meta")
            assert fa.plan(q, k, k, kernel="mma_sync").route == "mma_sync"
            if d <= fa.BWD_MMA_MAX_DIM:
                assert fa.plan_bwd(q, k, k, q, q, route="mma").route == "mma"
            else:
                with pytest.raises(ValueError, match="does not take"):
                    fa.plan_bwd(q, k, k, q, q, route="mma")
    q = torch.empty((1, 3, 4, 16), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="does not take"):
        fa.plan(q, q, q, kernel="wgmma")
    assert fa.route(torch.float32, 16) == "fp32" and fa.bwd_route(torch.float32, 16) == "tiled"


def _staged(shape, dtype=torch.bfloat16):
    """A meta tensor laid out as ``fa.stage`` lays one out."""
    *lead, d = shape
    return torch.empty((*lead, fa.tma_width(d)), dtype=dtype, device="meta")[..., :d]


@pytest.mark.parametrize("d", list(range(1, 33)) + [33, 64, 65, 128, 200, 256])
def test_tensor_map_box_widths_and_swizzle(d):
    """Each map's box is as wide as the tiles up to 64 columns (16 at D <=
    16, 32 at D <= 32) and its swizzle spans the box's row: 32, 64 or 128
    bytes (CU_TENSOR_MAP_SWIZZLE_32B / 64B / 128B = 1, 2, 3); the extent is
    D, so TMA zero-fills the tile's columns past it."""
    tile = fa.wgmma_tile_dim(d)
    box = fa.tma_box_cols(d)
    assert tile == (16 if d <= 16 else 32 if d <= 32 else -(-d // 64) * 64)
    assert box == min(tile, 64) and tile % box == 0 and 0 <= tile - d < (16 if d <= 32 else 64)
    assert fa.tma_swizzle(d) == {16: 1, 32: 2, 64: 3}[box]
    q = _staged((2, 130, 4, d))
    pl = fa.plan(q, q, q)
    # the K/V boxes as high as a tile's keys (the wide kernels' past 128), Q's
    # boxes as high where those divide its 128 rows
    keys = fa.wide_keys(d) if fa.wide_kernel(q.dtype, d) else fa.wgmma_keys(d)
    for i in range(3):
        m = pl.maps[11 * i:11 * i + 11]
        assert m[0] == d and m[7] == box and m[8] == m[10] == 1
        assert m[9] == (fa.wgmma_q_rows(keys) if i == 0 else keys)
        assert all(s % 16 == 0 for s in m[4:7])
    bp = fa.plan_bwd(q, q, q, q, q)
    assert all(bp.maps[11 * i + 7] == box and bp.maps[11 * i + 9] == fa.bwd_wgmma_box_rows(d)
               for i in range(4))


@pytest.mark.parametrize("d", range(1, 33))
def test_narrow_plans_fit_two_blocks_an_sm(d):
    """The narrow kernels run two blocks an SM: each block's dynamic shared
    memory, plus the 1 KB the card reserves a block, twice, within an SM's
    228 KB; the forward's ring 4 deep, the backward's dQ keys and dK/dV rows
    64."""
    q = _staged((2, 130, 4, d))
    pl, bp = fa.plan(q, q, q), fa.plan_bwd(q, q, q, q, q)
    row = 2 * fa.wgmma_tile_dim(d)
    assert fa.wgmma_stages(d) == fa.WGMMA_NARROW_STAGES == 4
    assert pl.smem == fa.wgmma_smem_bytes(d) == 1024 + 128 * row + 2 * 4 * 128 * row + 8 * 13
    assert bp.smem == fa.bwd_wgmma_smem_bytes(d)
    assert (fa.bwd_wgmma_dq_keys(d), fa.BWD_WGMMA_KV_ROWS) == (64, 64)
    for smem in (pl.smem, *bp.smem):
        assert smem <= SMEM_LIMIT and 2 * (smem + 1024) <= SM_SMEM


# --- the kernels' grids, walked --------------------------------------------------

WALK_SHAPES = [(2, 130, 333, 4, 2, 0), (1, 1, 200, 4, 1, 199), (2, 200, 70, 3, 1, 133),
               (1, 257, 257, 2, 2, 0)]


def _pairs(d, cols):
    """Columns stored at head dim d: columns 8n + 2t and + 1 for n < the
    tile's width / 8 where 8n < d, each of the pair only below d (store2)."""
    return [c for c in cols if c < d]


@pytest.mark.parametrize("d", [1, 5, 8, 13, 16, 24, 29, 32])
@pytest.mark.parametrize("shape", WALK_SHAPES, ids=str)
def test_grid_walks_store_each_output_once(shape, d):
    """The forward (block (h, b, z): query rows q0 + 64c + 16w + g + 8r, q0
    the z-th tile from the last), dQ (the same rows) and dK/dV (block (hk,
    b, z): keys 64z + 16w + g + 8r; consumer 0 stores dV, 1 dK), each thread
    (consumer c, warp w, lane 4g + t) storing columns 8n + 2t, 8n + 2t + 1
    below D: every output element once, none past D."""
    b, sq, sk, hq, hkv, off = shape
    q, k = _staged((b, sq, hq, d)), _staged((b, sk, hkv, d))
    pl, bp = fa.plan(q, k, k, off), fa.plan_bwd(q, k, k, q, q, off)
    tile = fa.wgmma_tile_dim(d)
    c, w, g, t, r, n = np.meshgrid(np.arange(2), np.arange(4), np.arange(8), np.arange(4),
                                   np.arange(2), np.arange(tile // 8), indexing="ij")
    rows = (64 * c + 16 * w + g + 8 * r).ravel()
    cols = (8 * n + 2 * t).ravel()
    keep_n = (8 * n < d).ravel()
    for grid, n_rows, heads, per_block, heavy_first, outputs in (
            (pl.grid, sq, hq, fa.WGMMA_ROWS, True, 1),
            (bp.grids[0], sq, hq, fa.BWD_WGMMA_DQ_ROWS, True, 1),
            (bp.grids[1], sk, hkv, fa.BWD_WGMMA_KV_KEYS, False, 2)):
        gx, gy, gz = grid
        assert (gx, gy) == (heads, b) and gz == -(-n_rows // per_block)
        hits = np.zeros((outputs, b, n_rows, heads, tile), dtype=np.int64)
        for z in range(gz):
            base = ((gz - 1 - z) if heavy_first else z) * per_block
            # dK/dV: 64 keys a block, both consumers over them, one output each
            rr = base + (rows if outputs == 1 else (16 * w + g + 8 * r).ravel())
            which = np.zeros_like(rr) if outputs == 1 else c.ravel()
            for col in (cols, cols + 1):
                keep = (rr < n_rows) & keep_n & (col < d)
                for h in range(gx):
                    for bb in range(gy):
                        np.add.at(hits, (which[keep], bb, rr[keep], h, col[keep]), 1)
        assert (hits[..., :d] == 1).all() and not hits[..., d:].any()


# --- float64 models of the loops ---------------------------------------------------

NEG = -1e30
LOG2E = 1.4426950408889634


def _tile(t, h, r0, rows, n):
    """Rows [r0, r0 + rows) of head h, zero past n (TMA's fill), float64."""
    out = torch.zeros((t.shape[0], rows, t.shape[3]), dtype=torch.float64)
    m = max(0, min(rows, n - r0))
    out[:, :m] = t[:, r0:r0 + m, h].double()
    return out


def _forward_model(q, k, v, off):
    """The narrow forward's loops in float64: blocks of 128 query rows
    (heaviest first), each consumer's 64 over the K/V tiles of 128 keys up to
    the block's last visible key, masking only tiles that cross the diagonal
    or Sk (-1e30), the online softmax in the log2 domain (m the row's max of
    the unscaled scores, corr = 2^((m_old - m) scale log2 e), P = 2^(s scale
    log2 e - m scale log2 e), l the running sum), O = acc / max(l, 1e-30),
    LSE = (m scale log2 e + log2 l) ln 2.  Rows past Sq are computed on zero
    queries and not stored."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g, scale_log2 = hq // hkv, LOG2E / math.sqrt(d)
    rows, keys = fa.WGMMA_ROWS, fa.wgmma_keys(d)
    out = torch.zeros(q.shape, dtype=torch.float64)
    lse = torch.zeros((b, hq, sq), dtype=torch.float64)
    gz = -(-sq // rows)
    for h in range(hq):
        for z in range(gz):
            q0 = (gz - 1 - z) * rows
            visible = min(sk, off + min(q0 + rows, sq))
            for c in range(2):
                r0 = q0 + 64 * c
                first = off + r0
                qt = _tile(q, h, r0, 64, sq)
                pos = first + torch.arange(64)[:, None]
                m = torch.full((b, 64, 1), NEG, dtype=torch.float64)
                l = torch.zeros((b, 64, 1), dtype=torch.float64)
                acc = torch.zeros((b, 64, d), dtype=torch.float64)
                for j in range(-(-visible // keys)):
                    k0 = j * keys
                    kt, vt = _tile(k, h // g, k0, keys, sk), _tile(v, h // g, k0, keys, sk)
                    s = torch.einsum("brd,bkd->brk", qt, kt)
                    if not (k0 + keys <= sk and k0 + keys - 1 <= first):
                        key = k0 + torch.arange(keys)[None, :]
                        s = torch.where((key < sk) & (pos >= key), s, NEG)
                    mx = torch.maximum(m, s.amax(-1, keepdim=True))
                    corr = torch.exp2((m - mx) * scale_log2)
                    p = torch.exp2(s * scale_log2 - mx * scale_log2)
                    m, l = mx, l * corr + p.sum(-1, keepdim=True)
                    acc = acc * corr + torch.einsum("brk,bkd->brd", p, vt)
                n = max(0, min(64, sq - r0))
                out[:, r0:r0 + n, h] = (acc / l.clamp_min(1e-30))[:, :n]
                lse[:, h, r0:r0 + n] = ((m * scale_log2 + torch.log2(l)) * math.log(2))[:, :n, 0]
    return out, lse


def _backward_model(q, k, v, o, do, lse, off):
    """The narrow backward's loops in float64, on the narrow tiling: dQ
    blocks of 128 rows (heaviest first), each consumer's 64 over K/V tiles of
    ``bwd_wgmma_dq_keys(D)`` keys, skipping the tiles none of its rows sees
    and masking those that cross the diagonal or Sk, dQ += dS K; dK/dV blocks
    of 64 keys over the group's heads and the query tiles of
    ``BWD_WGMMA_KV_ROWS`` rows from the one holding the first row that sees
    the block's first key, P^T masked where a tile crosses the diagonal, dV
    += P^T dO, dK += dS^T Q: the group summed in the block.  Rows past Sq
    take LSE and D_i 0."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g, scale = hq // hkv, 1.0 / math.sqrt(d)
    pad = torch.zeros((b, hq, 256), dtype=torch.float64)
    lse = torch.cat([lse.double(), pad], -1)
    di = torch.cat([(do.double() * o.double()).sum(-1).permute(0, 2, 1), pad], -1)
    dq, dk, dv = (torch.zeros(t.shape, dtype=torch.float64) for t in (q, k, v))
    rows_dq, keys_dq = fa.BWD_WGMMA_DQ_ROWS, fa.bwd_wgmma_dq_keys(d)
    gz = -(-sq // rows_dq)
    for h in range(hq):
        for z in range(gz):
            q0 = (gz - 1 - z) * rows_dq
            visible = min(sk, off + min(q0 + rows_dq, sq))
            for c in range(2):
                r0 = q0 + 64 * c
                first = off + r0
                qt, dot = _tile(q, h, r0, 64, sq), _tile(do, h, r0, 64, sq)
                pos = first + torch.arange(64)[:, None]
                acc = torch.zeros((b, 64, d), dtype=torch.float64)
                for j in range(-(-visible // keys_dq)):
                    k0 = j * keys_dq
                    if k0 > first + 63:
                        continue
                    kt, vt = _tile(k, h // g, k0, keys_dq, sk), _tile(v, h // g, k0, keys_dq, sk)
                    p = torch.exp(torch.einsum("brd,bkd->brk", qt, kt) * scale
                                  - lse[:, h, r0:r0 + 64, None])
                    if not (k0 + keys_dq <= sk and k0 + keys_dq - 1 <= first):
                        key = k0 + torch.arange(keys_dq)[None, :]
                        p = torch.where((key < sk) & (pos >= key), p, 0.0)
                    ds = p * (torch.einsum("brd,bkd->brk", dot, vt) - di[:, h, r0:r0 + 64, None])
                    acc += torch.einsum("brk,bkd->brd", ds, kt)
                n = max(0, min(64, sq - r0))
                dq[:, r0:r0 + n, h] = (acc * scale)[:, :n]
    rows_kv, keys_kv = fa.BWD_WGMMA_KV_ROWS, fa.BWD_WGMMA_KV_KEYS
    n_q = -(-sq // rows_kv)
    for hk in range(hkv):
        for z in range(-(-sk // keys_kv)):
            k0 = z * keys_kv
            first_row = max(0, k0 - off)
            t0 = n_q if first_row >= sq else first_row // rows_kv
            kt, vt = _tile(k, hk, k0, keys_kv, sk), _tile(v, hk, k0, keys_kv, sk)
            key = k0 + torch.arange(keys_kv)[:, None]
            acc_k = torch.zeros((b, keys_kv, d), dtype=torch.float64)
            acc_v = torch.zeros((b, keys_kv, d), dtype=torch.float64)
            for h in range(hk * g, hk * g + g):
                for tile in range(t0, n_q):
                    r0 = tile * rows_kv
                    first = off + r0
                    qt, dot = _tile(q, h, r0, rows_kv, sq), _tile(do, h, r0, rows_kv, sq)
                    pt = torch.exp(torch.einsum("bkd,brd->bkr", kt, qt) * scale
                                   - lse[:, h, None, r0:r0 + rows_kv])
                    if first < k0 + keys_kv - 1:
                        pt = torch.where(first + torch.arange(rows_kv)[None, :] >= key, pt, 0.0)
                    dst = pt * (torch.einsum("bkd,brd->bkr", vt, dot)
                                - di[:, h, None, r0:r0 + rows_kv])
                    acc_v += torch.einsum("bkr,brd->bkd", pt, dot)
                    acc_k += torch.einsum("bkr,brd->bkd", dst, qt)
            n = max(0, min(keys_kv, sk - k0))
            dk[:, k0:k0 + n, hk] = (acc_k * scale)[:, :n]
            dv[:, k0:k0 + n, hk] = acc_v[:, :n]
    return dq, dk, dv


MODEL_SHAPES = [(1, 200, 200, 4, 2, 16, 0), (1, 5, 300, 2, 1, 32, 290),
                (1, 130, 65, 2, 2, 24, 0), (2, 150, 170, 4, 1, 5, 40),
                (1, 70, 260, 2, 2, 1, 200), (1, 257, 300, 2, 1, 29, 3)]


@pytest.mark.parametrize("shape", MODEL_SHAPES, ids=str)
def test_forward_model_matches_plain(shape):
    b, sq, sk, hq, hkv, d, off = shape
    q, k, v, _ = map(torch.from_numpy, _inputs((b, sq, sk, hq, hkv, off), d, seed=3))
    out, lse = _forward_model(q, k, v, off)
    np.testing.assert_allclose(out.float().numpy(), fa.gqa_flash_plain(q, k, v, off).numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.float().numpy(), fa.gqa_flash_lse_plain(q, k, off).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", MODEL_SHAPES, ids=str)
def test_backward_model_matches_plain(shape):
    b, sq, sk, hq, hkv, d, off = shape
    q, k, v, do = map(torch.from_numpy, _inputs((b, sq, sk, hq, hkv, off), d, seed=5))
    o = fa.gqa_flash_plain(q, k, v, off)
    lse = fa.gqa_flash_lse_plain(q, k, off)
    got = _backward_model(q, k, v, o, do, lse, off)
    for g_, w in zip(got, fa.gqa_flash_bwd_lse_plain(q, k, v, o, do, lse, off)):
        assert torch.isfinite(g_).all()
        np.testing.assert_allclose(g_.float().numpy(), w.numpy(), rtol=1e-5, atol=1e-5)


# --- work and constants ------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("d", NARROW_DIMS)
def test_kernel_work_counts_seven_products(d, dtype):
    """The narrow backward runs seven products (S and dP in each kernel, dV,
    dK, dQ) over the unmasked pairs; a staged call (D off a multiple of 8)
    adds its copies."""
    b, sq, sk, hq, hkv, off = SHAPE
    q = torch.empty((b, sq, hq, d), dtype=dtype, device="meta")
    k = torch.empty((b, sk, hkv, d), dtype=dtype, device="meta")
    product = 2 * d * hq * b * sum(min(off + i + 1, sk) for i in range(sq))
    qb, kb, rows = 2 * q.numel(), 2 * k.numel(), 4 * b * hq * sq
    staged = d % 8 != 0
    assert fa.kernel_work(q, k, off, False, lse=True) == (
        2 * product, 2 * qb + 2 * kb + rows + (2 * (qb + 2 * kb) if staged else 0))
    assert fa.kernel_work(q, k, off, True) == (
        7 * product, 4 * qb + 6 * kb + 2 * rows + (2 * qb if staged else 0))


def test_constants_against_the_sources():
    hopper = (CSRC / "hopper.cuh").read_text()
    fwd = (CSRC / "flash_attention.cu").read_text()
    bwd = (CSRC / "flash_attention_bwd.cu").read_text()
    assert f"constexpr int NARROW = {fa.WGMMA_NARROW};" in hopper
    assert "using RolesOf = Roles<(D <= NARROW || (D > 192 && P::REGS == 0)), (D <= NARROW ? 2 : 1)," \
        in hopper
    assert "return d <= 16 ? 16 : d <= 32 ? 32 : (d + BOX - 1) / BOX * BOX;" in hopper
    assert all(fa.wgmma_tile_dim(d) == (16 if d <= 16 else 32 if d <= 32 else -(-d // 64) * 64)
               for d in range(1, 257))
    # the swizzle of a box's row, in the tensor maps and wgmma's descriptors
    assert "static constexpr uint64_t LAYOUT = COLS == 16 ? 3 : COLS == 32 ? 2 : 1;" in hopper
    assert re.search(r"cols == 16\s+\? CU_TENSOR_MAP_SWIZZLE_32B\s+: cols == 32 \? "
                     r"CU_TENSOR_MAP_SWIZZLE_64B\s+: CU_TENSOR_MAP_SWIZZLE_128B", hopper)
    for n in (16, 32):            # O += P V at the narrow widths
        assert f"wgmma.mma_async.sync.aligned.m64n{n}k16.f32." in hopper
    assert "static constexpr int STAGES = D <= NARROW ? 4 : D == 64 || D == 192 ? 3 : 2;" in fwd
    for src, ns in ((fwd, "launch<16, DO, T>"), (bwd, "launch<16, DO, T>(which")):
        assert "case 16:" in src and ns in src and "switch (tile_of(d))" in src
        assert "(dtype != 1 && dtype != 2) || d < 1 || d > 256)" in src
    # the yardsticks stay, by name
    assert "flash_mma_kernel(" in fwd and "flash_bwd_dq_mma_kernel(" in bwd
    assert fa.BWD_ROUTE_KERNELS["mma"] == fa.BWD_MMA_KERNELS
