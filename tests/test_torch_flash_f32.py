"""``gqa_flash`` in fp32 and fp64 on the "fp32" forward and the "tiled"
backward, on the CPU.

fp32 (and fp64, on fp32 copies) runs ``flash_tiled_kernel`` forward: 16 x
16 threads, each owning 8 x 8 scores up to width 112 (8 x 4 at 128, 4 x 4
past it) and the matching rows of O, S-like products over the least
multiple of 8 that holds D, K and V tiles by cp.async in turns, P^T through
one buffer in chunks of 64 keys, the LSE written for the backward; and the
"tiled" backward: ``flash_bwd_dq_tiled_kernel`` (D_i, then dQ) and
``flash_bwd_dkdv_tiled_kernel`` (K and V resident, the group summed in the
block) on that LSE (``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``,
``csrc/f32_tiles.cuh``).  The first design's kernels stay as yardsticks,
named: ``kernel="fp32_simple"`` forward, ``route="fma"`` backward.  Here,
without a card:

- the route table for fp32 and fp64 at every D 1..256, the yardsticks still
  planning;
- the plain LSE path the kernels are held to on the card
  (``gqa_flash_lse_plain`` + ``gqa_flash_bwd_lse_plain``, unrounded) against
  ``jax.vjp`` of the reference's ``chunked_attention`` and of
  ``kernels/ref.py::flash_attention_ref``, and the LSE against a JAX
  logsumexp of the masked, scaled scores, at D 1, 32, 100 and 250 in fp32
  and fp64 on a ragged shape with a causal offset (the fp32 limits: 2e-5
  forward and LSE, 1e-4 elementwise and 2e-5 relative L2 backward);
- a float64 model of the three kernels' loops (heaviest-first order, the
  tiles skipped after the last visible key, the tiles a warp skips, the
  masked tiles, the width rounded to a multiple of 8, zero rows and keys
  past Sq and Sk) against the plain versions;
- ``plan`` and ``plan_bwd``'s grids walked as the kernels walk them: each
  output element written once, shared memory within 232,448 bytes;
- the tiling constants against the CUDA source.
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

FLOATS = {"float32": torch.float32, "float64": torch.float64}
FLASH_TOL = 2e-5                  # forward and LSE, elementwise
BWD_TOL, BWD_REL = 1e-4, 2e-5     # backward: elementwise, relative L2
# (B, Sq, Sk, Hq, Hkv, causal offset): Sq != Sk, a group of 2, ragged tiles
SHAPE = (1, 37, 70, 4, 2, 33)
CSRC = Path(fa.__file__).resolve().parents[1] / "csrc"


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


# --- routes ------------------------------------------------------------------

def test_route_table_of_fp32_and_fp64_at_every_head_dim():
    for d in range(1, 257):
        for dtype in FLOATS.values():
            assert (fa.route(dtype, d), fa.bwd_route(dtype, d)) == ("fp32", "tiled")
            q = torch.empty((1, 3, 4, d), dtype=dtype, device="meta")
            k = torch.empty((1, 5, 2, d), dtype=dtype, device="meta")
            pl = fa.plan(q, k, k, causal_offset=2)
            t = fa.tiled_fwd_tiling(d)
            assert pl == fa.Plan("fp32", grid=(4, 1, 1), smem=t.smem)
            bp = fa.plan_bwd(q, k, k, q, q, causal_offset=2)
            assert bp.route == "tiled" and bp.maps is None
            assert bp.smem == (fa.tiled_dq_tiling(d).smem, fa.tiled_dkdv_tiling(d).smem)
            # the yardsticks: the first design's forward and backward, by name
            assert fa.plan(q, k, k, 2, kernel="fp32_simple") == fa.Plan("fp32_simple",
                                                                        grid=(1, 4, 1))
            assert fa.plan_bwd(q, k, k, q, q, 2, route="fma").route == "fma"
    assert fa.BWD_ROUTE_KERNELS["tiled"] == fa.BWD_TILED_KERNELS == ("bwd_tiled_dq",
                                                                     "bwd_tiled_dkdv")
    for name in ("fp32", "fp32_simple", "bwd_tiled_dq", "bwd_tiled_dkdv", "bwd_stats"):
        assert name in fa.launches
    q16 = torch.empty((1, 3, 4, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="does not take"):
        fa.plan(q16, q16[:, :, :2], q16[:, :, :2], kernel="fp32")
    with pytest.raises(ValueError, match="does not take"):
        fa.plan_bwd(q16, q16[:, :, :2], q16[:, :, :2], q16, q16, route="tiled")


def test_tiled_widths_and_slots():
    for d in range(1, 257):
        j, w = fa.tiled_slots(d), fa.tiled_width(d)
        assert w - 8 < d <= w <= 16 * j and w % 8 == 0
        if d <= 128:                                   # the least that holds D
            assert 16 * (j - 1) < d and w in (16 * j - 8, 16 * j)
        else:                                          # past 128: an even count
            assert j % 2 == 0 and 16 * (j - 2) < d
        rs = fa.tiled_row_stride(d)
        assert rs == 16 * j + 4 and (rs // 4) % 2 == 1
        # eight lanes reading 16 bytes each from eight consecutive rows: 8
        # distinct groups of 4 banks
        assert len({(r * rs) % 32 // 4 for r in range(8)}) == 8
    assert (fa.tiled_width(100), fa.tiled_slots(100)) == (104, 7)
    assert sorted({fa.tiled_slots(d) for d in range(1, 257)}) == [1, 2, 3, 4, 5, 6, 7, 8,
                                                                   10, 12, 14, 16]


# --- the plain LSE path against JAX ------------------------------------------

@pytest.mark.parametrize("dtype", list(FLOATS))
@pytest.mark.parametrize("d", [1, 32, 100, 250])
def test_lse_path_matches_jax_vjp(d, dtype):
    b, sq, sk, hq, hkv, off = SHAPE
    tdt = FLOATS[dtype]
    q, k, v, do = (torch.from_numpy(a).to(tdt) for a in _inputs(b, sq, sk, hq, hkv, d, 11))
    o = fa.gqa_flash_plain(q, k, v, off)
    lse = fa.gqa_flash_lse_plain(q, k, off)
    got = fa.gqa_flash_bwd_lse_plain(q, k, v, o, do, lse, off, round_bf16=False)
    q32, k32, v32, do32 = (jnp.asarray(t.float().numpy()) for t in (q, k, v, do))
    # the LSE: a logsumexp of the masked, scaled scores (B, Hq, Sq)
    g = hq // hkv
    s = jnp.einsum("bqhgd,bkhd->bhgqk", q32.reshape(b, sq, hkv, g, d), k32) / math.sqrt(d)
    live = (off + jnp.arange(sq))[:, None] >= jnp.arange(sk)[None, :]
    want_lse = jax.nn.logsumexp(jnp.where(live, s, -jnp.inf), axis=-1).reshape(b, hq, sq)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=FLASH_TOL,
                               atol=FLASH_TOL)
    np.testing.assert_allclose(o.double().numpy(), np.asarray(flash_attention_ref(
        q32, k32, v32, off)), rtol=FLASH_TOL, atol=FLASH_TOL)
    for fn in (lambda a, b_, c: jchunked_attention(a, b_, c, off, 16),
               lambda a, b_, c: flash_attention_ref(a, b_, c, off)):
        _, vjp = jax.vjp(fn, q32, k32, v32)
        for gr, w in zip(got, vjp(do32)):
            w = np.asarray(w)
            assert gr.dtype == tdt and gr.shape == w.shape
            np.testing.assert_allclose(gr.double().numpy(), w, rtol=BWD_TOL, atol=BWD_TOL)
            assert _rel_l2(gr.double().numpy(), w) <= BWD_REL


# --- a float64 model of the kernels' loops -----------------------------------

def _tile(t, h, r0, n, rows, cols):
    """Rows [r0, r0 + rows) of head h of t (B, S, H, D) as the kernels load
    them: (B, rows, cols) float64, zero at rows >= n and columns >= D."""
    b, _, _, d = t.shape
    out = torch.zeros((b, rows, cols), dtype=torch.float64)
    m = max(0, min(rows, n - r0))
    out[:, :m, :d] = t[:, r0:r0 + m, h].double()
    return out


def _stats(x, h, r0, n, rows):
    out = torch.zeros((x.shape[0], rows), dtype=torch.float64)
    m = max(0, min(rows, n - r0))
    out[:, :m] = x[:, h, r0:r0 + m].double()
    return out


def _fwd_model(q, k, v, off):
    """``flash_tiled_kernel``'s loops in float64: blocks of R query rows in
    the grid's order (heaviest first), key tiles up to the last key the
    block's last row sees, each warp's 2 RT rows skipping the tiles none of
    them sees and masking only those that cross the diagonal or the end of
    K; S over ``tiled_width(D)`` columns, the online softmax in the log2
    domain.  Returns the output, the LSE and each block's tile count in
    launch order."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    t = fa.tiled_fwd_tiling(d)
    rows, keys, rt = t.rows, t.cols, t.rt
    cols, w = 16 * fa.tiled_slots(d), fa.tiled_width(d)
    scale_log2 = 1.0 / math.log(2.0) / math.sqrt(d)
    out = torch.zeros((b, sq, hq, d), dtype=torch.float64)
    lse = torch.zeros((b, hq, sq), dtype=torch.float64)
    gx, gy, gz = fa.plan(q, k, v, off).grid
    order = []
    for z in range(gz):
        q0 = (gz - 1 - z) * rows
        n_tiles = -(-min(sk, off + min(q0 + rows, sq)) // keys)
        order.append(n_tiles)
        for h in range(gx):
            qt = _tile(q, h, q0, sq, rows, cols)
            assert not qt[..., w:].any()
            m = torch.full((b, rows), -1e30, dtype=torch.float64)
            l = torch.zeros((b, rows), dtype=torch.float64)
            acc = torch.zeros((b, rows, cols), dtype=torch.float64)
            for j in range(n_tiles):
                k0 = j * keys
                kt, vt = _tile(k, h // (hq // hkv), k0, sk, keys, cols), \
                    _tile(v, h // (hq // hkv), k0, sk, keys, cols)
                for wp in range(rows // (2 * rt)):
                    wr0 = q0 + 2 * rt * wp
                    if wr0 >= sq or k0 > off + min(wr0 + 2 * rt, sq) - 1:
                        continue
                    sl = slice(2 * rt * wp, 2 * rt * wp + 2 * rt)
                    s = torch.einsum("brc,bkc->brk", qt[:, sl, :w], kt[..., :w]) * scale_log2
                    if not (k0 + keys <= sk and k0 + keys - 1 <= off + wr0):
                        key = k0 + torch.arange(keys)[None, :]
                        pos = off + q0 + torch.arange(sl.start, sl.stop)[:, None]
                        s = torch.where((key < sk) & (pos >= key), s, -1e30)
                    mx = torch.maximum(m[:, sl], s.amax(-1))
                    corr = torch.exp2(m[:, sl] - mx)
                    p = torch.exp2(s - mx[..., None])
                    l[:, sl] = l[:, sl] * corr + p.sum(-1)
                    acc[:, sl] = acc[:, sl] * corr[..., None] + torch.einsum("brk,bkc->brc", p, vt)
                    m[:, sl] = mx
            n = max(0, min(rows, sq - q0))
            out[:, q0:q0 + n, h] = (acc / l.clamp_min(1e-30)[..., None])[:, :n, :d]
            lse[:, h, q0:q0 + n] = ((m + torch.log2(l)) * math.log(2.0))[:, :n]
    return out, lse, order


def _dq_model(q, k, v, o, do, lse, off):
    """``flash_bwd_dq_tiled_kernel``'s loops: blocks of R query rows (the
    grid's order, heaviest first) over the key tiles their rows see, each
    warp's 2 RT rows skipping the tiles none of them sees and masking only
    those that cross the diagonal or the end of K; D_i of the rows; P from
    the LSE in the log2 domain, dS = P (dP - D_i), dQ += dS K."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    t = fa.tiled_dq_tiling(d)
    rows, keys, rt = t.rows, t.cols, t.rt
    cols, w, scale = 16 * fa.tiled_slots(d), fa.tiled_width(d), 1.0 / math.sqrt(d)
    log2e = 1.0 / math.log(2.0)
    dvec = (do.double() * o.double()).sum(-1).permute(0, 2, 1)        # (B, Hq, Sq)
    dq = torch.zeros((b, sq, hq, d), dtype=torch.float64)
    gx, gy, gz = fa.plan_bwd(q, k, v, o, do, off).grids[0]
    for z in range(gz):
        q0 = (gz - 1 - z) * rows
        n_tiles = -(-min(sk, off + min(q0 + rows, sq)) // keys)
        for h in range(gx):
            qt, dot = _tile(q, h, q0, sq, rows, cols), _tile(do, h, q0, sq, rows, cols)
            lse2, di = _stats(lse, h, q0, sq, rows) * log2e, _stats(dvec, h, q0, sq, rows)
            acc = torch.zeros((b, rows, cols), dtype=torch.float64)
            for j in range(n_tiles):
                k0 = j * keys
                kt, vt = _tile(k, h // (hq // hkv), k0, sk, keys, cols), \
                    _tile(v, h // (hq // hkv), k0, sk, keys, cols)
                for wp in range(rows // (2 * rt)):
                    wr0 = q0 + 2 * rt * wp
                    if wr0 >= sq or k0 > off + min(wr0 + 2 * rt, sq) - 1:
                        continue
                    sl = slice(2 * rt * wp, 2 * rt * wp + 2 * rt)
                    s = torch.einsum("brc,bkc->brk", qt[:, sl, :w], kt[..., :w])
                    dp = torch.einsum("brc,bkc->brk", dot[:, sl, :w], vt[..., :w])
                    p = torch.exp2(s * scale * log2e - lse2[:, sl, None])
                    if not (k0 + keys <= sk and k0 + keys - 1 <= off + wr0):
                        key = k0 + torch.arange(keys)[None, :]
                        pos = off + q0 + torch.arange(sl.start, sl.stop)[:, None]
                        p = torch.where((key < sk) & (pos >= key), p, 0.0)
                    ds = p * (dp - di[:, sl, None])
                    acc[:, sl] += torch.einsum("brk,bkc->brc", ds, kt)
            n = max(0, min(rows, sq - q0))
            dq[:, q0:q0 + n, h] = (acc * scale)[:, :n, :d]
    return dq


def _dkdv_model(q, k, v, o, do, lse, off):
    """``flash_bwd_dkdv_tiled_kernel``'s loops: blocks of KEYS keys over the
    group's query tiles of ROWS rows from the one holding the first row that
    sees the block's first key, each warp's 2 RT keys skipping the tiles in
    which none of them is seen (or past Sk) and masking unless every (key,
    row) pair is live; P^T from the LSE, dS^T = P^T (dP^T - D_i), dV += P^T
    dO, dK += dS^T Q, the group summed in the block."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    t = fa.tiled_dkdv_tiling(d)
    kb, rows, rt = t.rows, t.cols, t.rt
    cols, w, scale = 16 * fa.tiled_slots(d), fa.tiled_width(d), 1.0 / math.sqrt(d)
    log2e = 1.0 / math.log(2.0)
    dvec = (do.double() * o.double()).sum(-1).permute(0, 2, 1)
    dk = torch.zeros((b, sk, hkv, d), dtype=torch.float64)
    dv = torch.zeros_like(dk)
    gx, gy, gz = fa.plan_bwd(q, k, v, o, do, off).grids[1]
    n_q = -(-sq // rows)
    for z in range(gz):
        k0 = z * kb
        first_row = max(0, k0 - off)
        t0 = n_q if first_row >= sq else first_row // rows
        for hk in range(gx):
            kt, vt = _tile(k, hk, k0, sk, kb, cols), _tile(v, hk, k0, sk, kb, cols)
            acc_k = torch.zeros((b, kb, cols), dtype=torch.float64)
            acc_v = torch.zeros_like(acc_k)
            for j in range(g * (n_q - t0)):
                h, r0 = hk * g + j // (n_q - t0), (t0 + j % (n_q - t0)) * rows
                qt, dot = _tile(q, h, r0, sq, rows, cols), _tile(do, h, r0, sq, rows, cols)
                lse2, di = _stats(lse, h, r0, sq, rows) * log2e, _stats(dvec, h, r0, sq, rows)
                first, last = off + r0, off + min(r0 + rows, sq) - 1
                for wp in range(kb // (2 * rt)):
                    wk0 = k0 + 2 * rt * wp
                    if wk0 >= sk or last < wk0:
                        continue
                    sl = slice(2 * rt * wp, 2 * rt * wp + 2 * rt)
                    st = torch.einsum("bkc,brc->bkr", kt[:, sl, :w], qt[..., :w])
                    dpt = torch.einsum("bkc,brc->bkr", vt[:, sl, :w], dot[..., :w])
                    pt = torch.exp2(st * scale * log2e - lse2[:, None, :])
                    if not (r0 + rows <= sq and wk0 + 2 * rt - 1 < sk
                            and first >= wk0 + 2 * rt - 1):
                        key = wk0 + torch.arange(2 * rt)[:, None]
                        row = r0 + torch.arange(rows)[None, :]
                        pt = torch.where((key < sk) & (row < sq) & (off + row >= key), pt, 0.0)
                    dst = pt * (dpt - di[:, None, :])
                    acc_v[:, sl] += torch.einsum("bkr,brc->bkc", pt, dot)
                    acc_k[:, sl] += torch.einsum("bkr,brc->bkc", dst, qt)
            n = max(0, min(kb, sk - k0))
            dk[:, k0:k0 + n, hk] = (acc_k * scale)[:, :n, :d]
            dv[:, k0:k0 + n, hk] = acc_v[:, :n, :d]
    return dk, dv


@pytest.mark.parametrize("shape", [
    (1, 200, 200, 4, 2, 100, 0), (1, 5, 300, 2, 1, 16, 290), (1, 130, 65, 2, 2, 33, 0),
    (1, 150, 170, 4, 1, 5, 40), (1, 70, 260, 2, 2, 128, 200), (1, 90, 140, 2, 1, 136, 50),
    (1, 80, 100, 2, 2, 250, 20), (1, 140, 140, 2, 2, 200, 0),
    # a warp's first row sees all but the tile's last key: the mask's edge
    (1, 100, 180, 2, 1, 40, 14), (1, 70, 150, 2, 2, 160, 54)], ids=str)
def test_tiled_loops_model_matches_plain(shape):
    b, sq, sk, hq, hkv, d, off = shape
    q, k, v, do = map(torch.from_numpy, _inputs(b, sq, sk, hq, hkv, d, 5))
    o, lse, order = _fwd_model(q, k, v, off)
    assert order == sorted(order, reverse=True)            # heaviest tiles first
    np.testing.assert_allclose(o.numpy(), fa.gqa_flash_plain(q, k, v, off).numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), fa.gqa_flash_lse_plain(q, k, off).numpy(),
                               rtol=1e-5, atol=1e-5)
    o32, lse32 = fa.gqa_flash_plain(q, k, v, off), fa.gqa_flash_lse_plain(q, k, off)
    got = (_dq_model(q, k, v, o32, do, lse32, off), *_dkdv_model(q, k, v, o32, do, lse32, off))
    want = fa.gqa_flash_bwd_lse_plain(q, k, v, o32, do, lse32, off)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)


# --- the grids, walked -------------------------------------------------------

@pytest.mark.parametrize("dtype,d", [(torch.float32, 1), (torch.float32, 16),
                                     (torch.float32, 33), (torch.float32, 100),
                                     (torch.float32, 128), (torch.float64, 129),
                                     (torch.float32, 200), (torch.float64, 256)], ids=str)
def test_tiled_grids_write_each_output_once(dtype, d):
    """Forward and dQ: block (h, b, z) owns query rows (gz - 1 - z) R + RT ty
    + i (i < RT) of head h, thread (ty, tx) of 16 x 16 stores columns tx +
    16 j below D (j < J) of its rows below Sq, tx 0 each row's LSE; dK/dV:
    block (hk, b, z) owns keys z K + RT ty + i, stored the same way.  Shared
    memory within a block's 232,448 bytes."""
    b, sq, sk, hq, hkv, off = 2, 150, 170, 4, 2, 26
    q = torch.empty((b, sq, hq, d), dtype=dtype, device="meta")
    k = torch.empty((b, sk, hkv, d), dtype=dtype, device="meta")
    j = fa.tiled_slots(d)
    ft, qt_, kt_ = fa.tiled_fwd_tiling(d), fa.tiled_dq_tiling(d), fa.tiled_dkdv_tiling(d)
    pl, bp = fa.plan(q, k, k, off), fa.plan_bwd(q, k, k, q, q, off)
    assert pl.smem == ft.smem and bp.smem == (qt_.smem, kt_.smem)
    assert max(pl.smem, *bp.smem) <= fa.SMEM_LIMIT
    for t in (ft, qt_, kt_):
        assert t.rows == 16 * t.rt and t.ct == t.cols // 16 and t.cols in (32, 64, 128)
        assert fa.TILED_THREADS == 16 * 16 == (t.rows // t.rt) * 16
        assert t.rt * t.ct >= (32 if t is ft and j <= 8 else 4)
    ty, tx, i, jj = np.meshgrid(np.arange(16), np.arange(16), np.arange(32),
                                np.arange(j), indexing="ij")
    for (gx, gy, gz), t, n_rows, heads, reverse in (
            (pl.grid, ft, sq, hq, True), (bp.grids[0], qt_, sq, hq, True),
            (bp.grids[1], kt_, sk, hkv, False)):
        assert (gx, gy) == (heads, b) and gz == -(-n_rows // t.rows)
        sel = i < t.rt
        rows, cols = (t.rt * ty + i)[sel], (tx + 16 * jj)[sel]
        hits = np.zeros((b, n_rows, heads, 16 * j), dtype=np.int64)
        lse_hits = np.zeros((b, heads, n_rows), dtype=np.int64)
        for z in range(gz):
            r = ((gz - 1 - z) if reverse else z) * t.rows + rows
            keep = (r < n_rows) & (cols < d)
            for h in range(gx):
                for bb in range(gy):
                    np.add.at(hits, (bb, r[keep], h, cols[keep]), 1)
                    first = (r < n_rows) & (tx[sel] == 0) & (jj[sel] == 0)
                    np.add.at(lse_hits, (bb, h, r[first]), 1)
        assert (hits[..., :d] == 1).all() and not hits[..., d:].any()
        assert (lse_hits == 1).all()


def test_tiled_shared_memory_at_every_width():
    for d in range(1, 257):
        for t in (fa.tiled_fwd_tiling(d), fa.tiled_dq_tiling(d), fa.tiled_dkdv_tiling(d)):
            assert t.smem <= fa.SMEM_LIMIT
    # D 100 (the head-dim path's fp32 case): 128-row forward and dQ blocks on
    # 64-key tiles, 64-key dK/dV blocks on 64-row query tiles
    assert fa.tiled_fwd_tiling(100) == fa.Tiling(128, 128, 8, 8, 4 * (384 * 116 + 64 * 132))
    assert fa.tiled_fwd_tiling(128) == fa.Tiling(128, 64, 8, 4, 4 * (256 * 132 + 64 * 132))
    assert fa.tiled_dq_tiling(100) == fa.Tiling(128, 64, 8, 4, 4 * (384 * 116 + 64 * 132))
    assert fa.tiled_dkdv_tiling(100) == fa.Tiling(128, 64, 8, 4,
                                                  4 * (448 * 116 + 32 * 132 + 256))
    assert fa.tiled_dkdv_tiling(128) == fa.Tiling(64, 64, 4, 4,
                                                  4 * (320 * 132 + 64 * 68 + 256))
    # past width 128 the rows (forward, dQ) or keys (dK/dV) a thread halve
    assert fa.tiled_fwd_tiling(256) == fa.Tiling(64, 64, 4, 4, 217_088)
    assert fa.tiled_dq_tiling(256) == fa.Tiling(64, 32, 4, 2, 208_384)
    assert fa.tiled_dkdv_tiling(256) == fa.Tiling(32, 32, 2, 2, 171_520)


def test_tiled_constants_match_the_cuda_source():
    src = (CSRC / "f32_tiles.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr \w+ {name} = ([\d ]+?)[;*]", src).group(1))

    assert const("TX") == 16 and const("MAX_J") == 16
    # every kernel 16 x 16 threads, one block an SM
    assert src.count("static constexpr int TY = 16, THREADS = TY * TX, BLOCKS = 1;") == 3
    assert fa.TILED_THREADS == 256 and fa.TILED_MAX_SLOTS == const("MAX_J")
    assert const("SMEM_MAX") == fa.SMEM_LIMIT
    assert "return (d + 7) / 8 * 8;" in src
    assert "return (d + 15) / 16 > 8 ? ((d + 15) / 16 + 1) / 2 * 2 : (d + 15) / 16;" in src
    assert "return with_slots<J < 8 ? J + 1 : J + 2>(j, fn);" in src
    assert "return 16 * j + 4;" in src
    # the forward's and dQ's rows a thread, dK/dV's keys a thread
    assert src.count("static constexpr int RT = J > 8 ? 4 : 8;") == 2
    assert "static constexpr int RT = J > 8 ? 2 : J == 8 ? 4 : 8;" in src
    assert "static constexpr int NCH = RT == 8 ? 2 : 1;" in src
    # the shared memory each tiling counts, as the wrapper counts it
    assert "((ROWS + 2 * keys) * RS + (keys > 64 ? 64 : keys) * PS)" in src
    assert "static constexpr int KEYS = RT == 8 && bytes(128) <= SMEM_MAX ? 128" in src
    assert "((2 * ROWS + 2 * keys) * RS + keys * XS)" in src
    assert "((2 * KEYS + 3 * rows) * RS + rows / NCH * XS + 4 * rows)" in src
    assert src.count("bytes(64) <= SMEM_MAX ? 64 : 32") == 2
    fwd = (CSRC / "flash_attention.cu").read_text()
    bwd = (CSRC / "flash_attention_bwd.cu").read_text()
    # the forward writes the natural LSE from its log2-domain statistics
    assert "(m[i] + log2f(sum)) * tiled::LN2" in fwd
    assert '#include "f32_tiles.cuh"' in fwd and '#include "f32_tiles.cuh"' in bwd
    assert "tl::DQ" in bwd and "enum Kernel { DQ = 0, DKDV = 1 };" in bwd
