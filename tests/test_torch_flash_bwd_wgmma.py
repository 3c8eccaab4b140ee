"""The wgmma route of the port's ``gqa_flash`` backward, on the CPU.

The route's two Hopper kernels (``csrc/flash_attention_bwd.cu``, namespace
``wg``) read each row's log-sum-exp from the forward kernel instead of
computing it.  Here, against the JAX package:

- ``gqa_flash_lse_plain`` against ``jax.nn.logsumexp`` of the reference's
  masked scores, built as ``kernels/ref.py::flash_attention_ref`` builds them
  (rtol = atol = 2e-5: the same fp32 products summed in another order);
- ``gqa_flash_bwd_lse_plain``, the kernels' plain version, against ``jax.vjp``
  of ``chunked_attention`` at 2e-5 without rounding, and with P and dS
  rounded to bf16 where the kernels round them within 1e-2 relative L2 and
  5e-2 elementwise (bf16 keeps 8 bits, a relative 2^-9 per rounded value; on
  unit-normal inputs the gradients are of order 1);
- ``bwd_route``'s table, ``plan_bwd``'s wgmma grids walked as the kernels
  walk them (each dQ, dK and dV element written by one block), a float64
  model of the kernels' loops (the blocks' tiles, the skipped tiles, the
  masks, the zero LSE and D_i of rows past Sq, zero-filled rows) against the
  plain version, the accumulator-to-register-A mapping that turns P and dS
  into wgmma operands, and the tiling constants against the CUDA source.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models.common import chunked_attention as jchunked_attention
from repro_torch.kernels import flash_attention as fa

TOL = 2e-5
ROUNDED_REL, ROUNDED_TOL = 1e-2, 5e-2
# (B, Sq, Sk, Hq, Hkv, D, causal_offset): the backward's CPU shapes
# (tests/test_torch_flash_bwd.py): groups 1/2/4, offsets 0 and > 0, tails
# shorter than a chunk or tile.
SHAPES = [(2, 9, 9, 2, 2, 32, 0), (1, 13, 20, 4, 2, 32, 7), (2, 17, 17, 8, 2, 16, 0),
          (1, 5, 37, 4, 1, 64, 32), (2, 70, 70, 4, 2, 32, 0)]
TRAIN = (4, 2304, 2304, 16, 8, 128, 0)       # internvl2-2b's train step
# Head dims past 128, on the wide tiles (192 and 256)
WIDE_SHAPES = [(1, 13, 20, 4, 2, 256, 7), (2, 17, 17, 8, 2, 136, 0)]


def _inputs(shape, seed=0):
    b, sq, sk, hq, hkv, d, _ = shape
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, hq, d))]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", SHAPES + WIDE_SHAPES, ids=str)
def test_lse_plain_matches_jax_logsumexp(shape):
    q, k, _, _ = _inputs(shape)
    b, sq, sk, hq, hkv, d, off = shape
    qg = jnp.asarray(q).reshape(b, sq, hkv, hq // hkv, d)
    s = jnp.einsum("bqhgd,bkhd->bhgqk", qg, jnp.asarray(k)) / np.sqrt(d)
    mask = (off + jnp.arange(sq))[:, None] >= jnp.arange(sk)[None, :]
    s = jnp.where(mask[None, None, None], s, -1e30)
    want = np.asarray(jax.nn.logsumexp(s, axis=-1)).reshape(b, hq, sq)
    got = fa.gqa_flash_lse_plain(torch.from_numpy(q), torch.from_numpy(k), off)
    assert got.dtype == torch.float32 and got.shape == (b, hq, sq)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("round_bf16", [False, True], ids=["fp32", "bf16-rounded"])
@pytest.mark.parametrize("shape", SHAPES + WIDE_SHAPES, ids=str)
def test_lse_backward_matches_jax_vjp(shape, round_bf16):
    q, k, v, do = _inputs(shape, seed=2)
    off = shape[-1]
    _, vjp = jax.vjp(lambda q, k, v: jchunked_attention(q, k, v, off, 16),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o = fa.gqa_flash_plain(tq, tk, tv, off)
    lse = fa.gqa_flash_lse_plain(tq, tk, off)
    got = fa.gqa_flash_bwd_lse_plain(tq, tk, tv, o, tdo, lse, off, round_bf16=round_bf16)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        if round_bf16:
            np.testing.assert_allclose(g.numpy(), w, rtol=ROUNDED_TOL, atol=ROUNDED_TOL)
            assert _rel_l2(g.numpy(), w) <= ROUNDED_REL
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL)


def test_bwd_route_table():
    for d in fa.HEAD_DIMS:
        assert fa.bwd_route(torch.float32, d) == "tiled"
        assert fa.bwd_route(torch.bfloat16, d) == "wgmma"
        # the backward reads the LSE exactly where the forward's route writes it
        assert (fa.bwd_route(torch.bfloat16, d) == "wgmma") == \
            (fa.route(torch.bfloat16, d) == "wgmma")
    for dtype, d in ((torch.float16, 257), (torch.bfloat16, 0)):
        with pytest.raises(ValueError, match="no backward kernel"):
            fa.bwd_route(dtype, d)


def _bf16_tensors(shape):
    b, sq, sk, hq, hkv, d, _ = shape
    q = torch.zeros((b, sq, hq, d), dtype=torch.bfloat16)
    k = torch.zeros((b, sk, hkv, d), dtype=torch.bfloat16)
    return q, k, k.clone(), q.clone(), q.clone()


def _wgmma_shapes():
    """The CPU shapes' B, S, heads and offsets at the wgmma route's head dims,
    two of them past 128 (the wide tiles), and the train step's tiling."""
    dims = (64, 112, 128)
    return [s[:5] + (dims[i % 3], s[6]) for i, s in enumerate(SHAPES)] + [TRAIN] + \
        [SHAPES[1][:5] + (160, SHAPES[1][6]), TRAIN[:5] + (256, 0)]


@pytest.mark.parametrize("shape", _wgmma_shapes(), ids=str)
def test_plan_bwd_wgmma_grids_cover_every_output_once(shape):
    b, sq, sk, hq, hkv, d, off = shape
    pl = fa.plan_bwd(*_bf16_tensors(shape), causal_offset=off)
    assert pl.route == "wgmma"
    wide = fa.wide_kernel(torch.bfloat16, d)
    assert pl.smem == fa.bwd_wgmma_smem_bytes(d, fa.wide_dq_keys(d) if wide else None)
    assert max(pl.smem) <= 232_448
    rows = fa.BWD_WGMMA_BOX_ROWS if d <= 128 else fa.BWD_WGMMA_WIDE_BOX_ROWS
    assert len(pl.maps) == 4 * 11 and all(pl.maps[11 * i + 9] == rows for i in range(4))
    # dQ: block (h, b, z) owns query rows of tile gz - 1 - z (heaviest first)
    # of head h; dK/dV: block (hk, b, z) owns keys of tile z of KV head hk.
    # The head-dim kernels (D 112 here) and the wide kernels (160, 256) run
    # 1-D grids in the L2 order (``wg::l2_unit``): the same blocks, a group
    # of KV heads at a time.
    q_tiles, k_tiles = -(-sq // fa.BWD_WGMMA_DQ_ROWS), -(-sk // fa.BWD_WGMMA_KV_KEYS)
    if any(pl.groups):
        assert fa.width_kernel(torch.bfloat16, d, backward=True) or wide
        assert pl.grids == ((b * hq * q_tiles, 1, 1), (b * hkv * k_tiles, 1, 1))
        dq_blocks = [(h, bi, (q_tiles - 1 - z) * fa.BWD_WGMMA_DQ_ROWS)
                     for h, bi, z in _l2_units(b * hq * q_tiles, q_tiles, hq, hq // hkv,
                                               pl.groups[0])]
        kv_blocks = [(hk, bi, z * fa.BWD_WGMMA_KV_KEYS)
                     for hk, bi, z in _l2_units(b * hkv * k_tiles, k_tiles, hkv, 1,
                                                pl.groups[1])]
    else:
        (gx, gy, gz), (kx, ky, kz) = pl.grids
        assert (gx, gy, kx, ky) == (hq, b, hkv, b)
        dq_blocks = [(h, bi, (gz - 1 - z) * fa.BWD_WGMMA_DQ_ROWS)
                     for h in range(gx) for bi in range(gy) for z in range(gz)]
        kv_blocks = [(hk, bi, z * fa.BWD_WGMMA_KV_KEYS)
                     for hk in range(kx) for bi in range(ky) for z in range(kz)]
    dq = np.zeros((b, sq, hq), dtype=int)
    for h, bi, q0 in dq_blocks:
        dq[bi, q0:q0 + fa.BWD_WGMMA_DQ_ROWS, h] += 1
    dkv = np.zeros((b, sk, hkv), dtype=int)
    for hk, bi, k0 in kv_blocks:
        dkv[bi, k0:k0 + fa.BWD_WGMMA_KV_KEYS, hk] += 1
    assert (dq == 1).all() and (dkv == 1).all()


def _l2_units(n, tiles, heads, group, group_kv):
    """``wg::l2_unit``: each block of a 1-D grid of n in the L2 order, (head,
    batch, the tile's place in the walk)."""
    for i in range(n):
        full = group_kv * group * tiles
        kv0 = i // full * group_kv
        m = min(group_kv, n // (group * tiles) - kv0) * group
        r = i % full
        kv = kv0 + r % m // group
        hkv = heads // group
        yield kv % hkv * group + r % group, kv // hkv, r // m


def test_plan_bwd_wgmma_checks():
    q, k, v, o, do = _bf16_tensors((1, 8, 8, 4, 2, 64, 0))
    assert fa.plan_bwd(q, k, v, o, do, route="fma").route == "fma"
    with pytest.raises(ValueError, match="does not take"):
        fa.plan_bwd(*(t.float() for t in (q, k, v, o, do)), route="wgmma")
    with pytest.raises(ValueError, match="does not take"):
        fa.plan_bwd(*_bf16_tensors((1, 8, 8, 4, 2, 64, 0)), route="mma")
    shifted = torch.zeros(do.numel() + 1, dtype=do.dtype)[1:].view(do.shape)
    with pytest.raises(ValueError, match="layout"):       # a start 2 bytes off 16
        fa.plan_bwd(q, k, v, o, shifted)


def test_wgmma_tiling_constants_match_the_cuda_source():
    src = (Path(fa.__file__).resolve().parents[1] / "csrc"
           / "flash_attention_bwd.cu").read_text()
    wg = src[src.index("namespace wg {"):src.index("}  // namespace wg")]

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", wg).group(1))

    assert (const("BOX_ROWS"), const("DQ_ROWS"), const("DQ_KEYS"), const("KV_KEYS"),
            const("KV_ROWS"), const("STAGES")) == (
        fa.BWD_WGMMA_BOX_ROWS, fa.BWD_WGMMA_DQ_ROWS, fa.BWD_WGMMA_DQ_KEYS,
        fa.BWD_WGMMA_KV_KEYS, fa.BWD_WGMMA_KV_ROWS, fa.BWD_WGMMA_STAGES)
    # dQ: two consumers of one box of rows each; dK/dV: one box of keys,
    # which both consumers share; the forward's box width
    assert const("DQ_ROWS") == 2 * const("BOX_ROWS")
    assert const("KV_KEYS") == const("DQ_KEYS") == const("KV_ROWS") == const("BOX_ROWS") == 64
    # past width 128: dQ's key tiles and every box 32 rows; the rings' depths
    assert (const("WIDE_DQ_KEYS"), const("WIDE_BOX_ROWS")) == (
        fa.BWD_WGMMA_WIDE_DQ_KEYS, fa.BWD_WGMMA_WIDE_BOX_ROWS) == (32, 32)
    assert "static constexpr int DQ_STAGES = D == 256 ? 3 : STAGES;" in wg
    assert "static constexpr int KV_STAGES = D == 256 ? 2 : D == 192 ? 3 : STAGES;" in wg
    assert [fa.bwd_wgmma_stages(t) for t in (64, 128, 192, 256)] == [(4, 4), (4, 4), (4, 3),
                                                                      (3, 2)]
    hopper = (Path(fa.__file__).resolve().parents[1] / "csrc" / "hopper.cuh").read_text()
    assert f"constexpr int BOX = {fa.TMA_BOX_COLS};" in hopper


def _accumulator(w, g, t, i):
    """(row, column) of element i of wgmma m64nNk16's accumulator held by lane
    4g + t of warp w of the warpgroup."""
    return 16 * w + g + 8 * ((i >> 1) & 1), 8 * (i >> 2) + 2 * t + (i & 1)


def _register_a(w, g, t, kk, j):
    """(row, the two columns) of register j of the register-A fragment of the
    kk-th 16 columns of a 64 x 64 bf16 operand (PTX's wgmma A layout)."""
    col = 16 * kk + 2 * t + 8 * (j >> 1)
    return 16 * w + g + 8 * (j & 1), (col, col + 1)


def test_accumulator_pairs_are_register_a_fragments():
    """P, dS (dQ kernel) and P^T, dS^T (dK/dV kernel) leave the product in
    the accumulator layout and enter the next as A: register i packs
    elements 2i, 2i + 1, and the kernels' row and column of each pair (the
    dQ kernel's key k0 + 8 (i >> 1) + 2t of row row + 8 (i & 1); the dK/dV
    kernel's query row 8 (i >> 1) + 2t of key key + 8 (i & 1)) are the
    layout's.  Every element of the 64 x 64 tile has one holder."""
    seen = np.zeros((64, 64), dtype=int)
    for w in range(4):
        for g in range(8):
            for t in range(4):
                for i in range(16):
                    r0, c0 = _accumulator(w, g, t, 2 * i)
                    r1, c1 = _accumulator(w, g, t, 2 * i + 1)
                    assert r0 == r1 and c1 == c0 + 1
                    assert _register_a(w, g, t, i // 4, i % 4) == (r0, (c0, c1))
                    assert (r0, c0) == (16 * w + g + 8 * (i & 1), 8 * (i >> 1) + 2 * t)
                    seen[r0, c0] += 1
                    seen[r1, c1] += 1
    assert (seen == 1).all()


def _tile(t, h, r0, rows, n):
    """Rows [r0, r0 + rows) of head h, zero past n (TMA's fill), float64."""
    out = torch.zeros((t.shape[0], rows, t.shape[3]), dtype=torch.float64)
    m = max(0, min(rows, n - r0))
    out[:, :m] = t[:, r0:r0 + m, h].double()
    return out


def _wgmma_model(q, k, v, o, do, lse, off):
    """The two kernels' loops in float64: the dQ kernel's blocks of 128 rows
    (heaviest first), each consumer's 64 rows over key tiles of
    ``bwd_wgmma_dq_keys(D)`` (64, or 32 past width 128) up to the block's
    last visible key, skipping tiles none of its rows sees, masking
    tiles that cross the diagonal or Sk; D_i from o and do; then the dK/dV
    kernel's blocks of 64 keys over the group's heads and the 64-row query
    tiles from the one holding the first row that sees the block's first key
    (each of which sees it), P^T then dS^T from it, masking tiles that cross
    the diagonal.  Rows past Sq take LSE and D_i 0 (their Q and dO are
    zeros)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g, scale = hq // hkv, 1.0 / math.sqrt(d)
    lse = torch.cat([lse.double(), torch.zeros((b, hq, 256), dtype=torch.float64)], -1)
    di = torch.cat([(do.double() * o.double()).sum(-1).permute(0, 2, 1),
                    torch.zeros((b, hq, 256), dtype=torch.float64)], -1)
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
                    kt = _tile(k, h // g, k0, keys_dq, sk)
                    vt = _tile(v, h // g, k0, keys_dq, sk)
                    p = torch.exp(torch.einsum("brd,bkd->brk", qt, kt) * scale
                                  - lse[:, h, r0:r0 + 64, None])
                    if not (k0 + keys_dq <= sk and k0 + keys_dq - 1 <= first):
                        key = k0 + torch.arange(keys_dq)[None, :]
                        p = torch.where((key < sk) & (pos >= key), p, 0.0)
                    ds = p * (torch.einsum("brd,bkd->brk", dot, vt) - di[:, h, r0:r0 + 64, None])
                    acc += torch.einsum("brk,bkd->brd", ds, kt)
                m = max(0, min(64, sq - r0))
                dq[:, r0:r0 + m, h] = (acc * scale)[:, :m]
    rows_kv, keys_kv = fa.BWD_WGMMA_KV_ROWS, fa.BWD_WGMMA_KV_KEYS
    n_q = -(-sq // rows_kv)
    for hk in range(hkv):
        for z in range(-(-sk // keys_kv)):
            k0 = z * keys_kv
            first_row = max(0, k0 - off)
            t0 = n_q if first_row >= sq else first_row // rows_kv
            kt, vt = _tile(k, hk, k0, 64, sk), _tile(v, hk, k0, 64, sk)
            key = k0 + torch.arange(64)[:, None]
            acc_k = torch.zeros((b, 64, d), dtype=torch.float64)
            acc_v = torch.zeros((b, 64, d), dtype=torch.float64)
            for h in range(hk * g, hk * g + g):
                for tile in range(t0, n_q):
                    r0 = tile * rows_kv
                    first = off + r0
                    assert first + 63 >= k0             # the tile sees key k0
                    qt, dot = _tile(q, h, r0, 64, sq), _tile(do, h, r0, 64, sq)
                    pt = torch.exp(torch.einsum("bkd,brd->bkr", kt, qt) * scale
                                   - lse[:, h, None, r0:r0 + 64])
                    if first < k0 + 63:
                        pos = first + torch.arange(64)[None, :]
                        pt = torch.where(pos >= key, pt, 0.0)
                    dst = pt * (torch.einsum("bkd,brd->bkr", vt, dot)
                                - di[:, h, None, r0:r0 + 64])
                    acc_v += torch.einsum("bkr,brd->bkd", pt, dot)
                    acc_k += torch.einsum("bkr,brd->bkd", dst, qt)
            m = max(0, min(64, sk - k0))
            dk[:, k0:k0 + m, hk] = (acc_k * scale)[:, :m]
            dv[:, k0:k0 + m, hk] = acc_v[:, :m]
    return dq, dk, dv


@pytest.mark.parametrize("shape", [(1, 200, 200, 4, 2, 16, 0), (1, 5, 300, 2, 1, 16, 290),
                                   (1, 130, 65, 2, 2, 16, 0), (1, 3, 200, 2, 2, 16, 3),
                                   (2, 260, 300, 4, 1, 16, 40), (1, 200, 235, 4, 2, 200, 35),
                                   (1, 130, 130, 2, 1, 256, 0)], ids=str)
def test_wgmma_loops_model_matches_plain(shape):
    q, k, v, do = map(torch.from_numpy, _inputs(shape, seed=5))
    off = shape[-1]
    o = fa.gqa_flash_plain(q, k, v, off)
    lse = fa.gqa_flash_lse_plain(q, k, off)
    got = _wgmma_model(q, k, v, o, do, lse, off)
    want = fa.gqa_flash_bwd_lse_plain(q, k, v, o, do, lse, off)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), rtol=1e-5, atol=1e-5)


def test_function_saves_no_lse_on_the_cpu():
    """On the CPU the forward is the plain version, which writes no LSE, and
    the backward is ``gqa_flash_bwd_plain``."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(SHAPES[1]))
    out, lse = fa._forward(q, k, v, 7, with_lse=True)
    assert lse is None and torch.equal(out, fa.gqa_flash_plain(q, k, v, 7))
