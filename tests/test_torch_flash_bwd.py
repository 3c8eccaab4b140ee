"""The backward of the port's ``gqa_flash`` against the JAX package, on the CPU.

The reference's Pallas ``gqa_flash`` has no gradient (``jax.grad`` through
it raises), so the reference trains with XLA's autodiff of
``chunked_attention``; the port's plain backward ``gqa_flash_bwd_plain`` and
the ``FlashAttention`` Function (which runs the plain forward and backward
on CPU tensors) are held against ``jax.vjp`` of ``chunked_attention`` and of
``kernels/ref.py::flash_attention_ref`` in fp32: rtol = atol = 2e-5 (the
same fp32 products summed in another order; the chunked form also rescales
by its running max).  ``plan_bwd``'s grids are walked as the kernels walk
them, and a Python model of the kernels' tile loops (the first query tile a
key tile needs, the key tiles a query tile needs, the masks of ragged
tiles) is held against the plain version to 1e-5.
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

TOL = 2e-5
# (B, Sq, Sk, Hq, Hkv, D, causal_offset): groups 1/2/4, offsets 0 and > 0,
# tails shorter than a chunk or tile.
SHAPES = [(2, 9, 9, 2, 2, 32, 0), (1, 13, 20, 4, 2, 32, 7), (2, 17, 17, 8, 2, 16, 0),
          (1, 5, 37, 4, 1, 64, 32), (2, 70, 70, 4, 2, 32, 0), (2, 70, 90, 4, 2, 16, 20)]


def _inputs(shape, seed=0):
    b, sq, sk, hq, hkv, d, _ = shape
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, hq, d))]


def _jax_grads(fn, q, k, v, do):
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small tensor ops: with one intra-op thread they
    run as fast serially and do not thrash when test workers share cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_backward_matches_jax_vjp(shape):
    q, k, v, do = _inputs(shape)
    off = shape[-1]
    want_chunked = _jax_grads(lambda q, k, v: jchunked_attention(q, k, v, off, 16),
                              q, k, v, do)
    want_ref = _jax_grads(lambda q, k, v: flash_attention_ref(q, k, v, off), q, k, v, do)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o = fa.gqa_flash_plain(tq, tk, tv, off)
    got = fa.gqa_flash_bwd_plain(tq, tk, tv, o, tdo, off)
    for g, wc, wr in zip(got, want_chunked, want_ref):
        np.testing.assert_allclose(g.numpy(), wc, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(g.numpy(), wr, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", SHAPES[:3], ids=str)
def test_function_wiring_on_the_cpu(shape):
    """``gqa_flash`` with inputs that need grad runs the Function: its grads
    (saved tensors, GQA sum, offset) are the plain backward's and jax's."""
    q, k, v, do = _inputs(shape, seed=1)
    off = shape[-1]
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    fa.reset_launches()
    out = fa.gqa_flash(*leaves, causal_offset=off)
    assert isinstance(out.grad_fn, fa.FlashAttention._backward_cls)
    out.backward(torch.from_numpy(do))
    assert all(n == 0 for n in fa.launches.values())         # CPU: plain versions
    want = _jax_grads(lambda q, k, v: jchunked_attention(q, k, v, off, 16), q, k, v, do)
    direct = fa.gqa_flash_bwd_plain(*(t.detach() for t in leaves), out.detach(),
                                    torch.from_numpy(do), off)
    for leaf, g, w in zip(leaves, direct, want):
        assert torch.equal(leaf.grad, g)
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=TOL, atol=TOL)


def test_serving_path_unchanged():
    q, k, v, _ = _inputs(SHAPES[1])
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    plain = fa.gqa_flash_plain(tq, tk, tv, 7)
    assert fa.gqa_flash(tq, tk, tv, 7).grad_fn is None      # nothing needs grad
    with torch.no_grad():
        out = fa.gqa_flash(tq.requires_grad_(), tk, tv, 7)
    assert out.grad_fn is None and torch.equal(out, plain)


def test_bf16_function_keeps_dtypes():
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _inputs(SHAPES[2]))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.gqa_flash(*leaves).backward(do)
    assert all(t.grad.dtype == torch.bfloat16 for t in leaves)
    want = fa.gqa_flash_bwd_plain(q, k, v, fa.gqa_flash_plain(q, k, v), do)
    assert all(torch.equal(t.grad, w) for t, w in zip(leaves, want))


# ---------------------------------------------------------------------------
# the launch plan and the kernels' loops


def _grid_shapes():
    return [(1, 1, 1, 2, 2, 32, 0), (2, 63, 65, 4, 2, 64, 0), (1, 130, 200, 8, 4, 128, 70),
            (3, 200, 65, 4, 1, 112, 0), (1, 64, 64, 16, 8, 128, 0), (4, 128, 128, 4, 2, 16, 0)]


def _tensors(shape, dtype=torch.float32):
    b, sq, sk, hq, hkv, d, _ = shape
    q = torch.zeros((b, sq, hq, d), dtype=dtype)
    k = torch.zeros((b, sk, hkv, d), dtype=dtype)
    return q, k, k.clone(), q.clone(), q.clone()


@pytest.mark.parametrize("shape", _grid_shapes(), ids=str)
def test_plan_bwd_grids_cover_every_output_once(shape):
    b, sq, sk, hq, hkv, d, off = shape
    pl = fa.plan_bwd(*_tensors(shape), causal_offset=off, route="fma")   # the yardstick
    assert pl.smem == fa.bwd_smem_bytes(d) and max(pl.smem) <= 232_448
    rows, keys = fa.BWD_ROWS, fa.BWD_KEYS
    # stats and dQ: block (x, h, b) owns query rows of tile x (dQ: the tiles
    # reversed, heaviest first) of head h; dK/dV: block (x, hk, b) owns keys
    # of tile x of KV head hk.
    for which, n_rows, heads in (("bwd_stats", sq, hq), ("bwd_dq", sq, hq),
                                 ("bwd_dkdv", sk, hkv)):
        gx, gy, gz = pl.grids[fa.BWD_KERNELS.index(which)]
        assert (gy, gz) == (heads, b)
        count = np.zeros((b, n_rows, heads), dtype=int)
        for x in range(gx):
            tile = gx - 1 - x if which == "bwd_dq" else x
            r0 = tile * (keys if which == "bwd_dkdv" else rows)
            for h in range(gy):
                for bi in range(gz):
                    count[bi, r0:r0 + rows, h] += 1
        assert (count == 1).all(), which


@pytest.mark.parametrize("b,sq,sk,hq,hkv", [(4, 128, 128, 4, 2), (2, 128, 128, 4, 2),
                                             (1, 65, 130, 2, 1)])
def test_bf16_head_dim_16_runs_the_fma_kernels_over_every_column_once(b, sq, sk, hq, hkv):
    """The tiny trainer's backward shapes (bf16, D 16: B 4 and a rank's 2, S
    128, Hq 4, Hkv 2) on the fma route, the yardstick of the mma route they
    take by default: its plan's grids and shared memory are those of
    ``bwd_smem_bytes(16)``; each kernel's thread (ty, tx) writes columns tx
    + 16j for j < D / 16 of its rows (dQ) or keys (dK, dV), so at D 16 the 16
    lanes of a half warp cover the row's columns once."""
    d = 16
    q, k, v, o, do = (t.bfloat16() for t in _tensors((b, sq, sk, hq, hkv, d, 0)))
    assert fa.bwd_route(torch.bfloat16, d) == "mma"
    pl = fa.plan_bwd(q, k, v, o, do, route="fma")
    tiles_q, tiles_k = -(-sq // fa.BWD_ROWS), -(-sk // fa.BWD_KEYS)
    assert pl.route == "fma" and pl.maps is None
    assert pl.grids == ((tiles_q, hq, b), (tiles_k, hkv, b), (tiles_q, hq, b))
    assert pl.smem == fa.bwd_smem_bytes(d) == (4 * 2 * 64 * 17,
                                              4 * (4 * 64 * 17 + 2 * 64 * 65 + 2 * 64),
                                              4 * (4 * 64 * 17 + 64 * 65))
    tx, j = np.meshgrid(np.arange(16), np.arange(d // 16), indexing="ij")
    cols = np.bincount((tx + 16 * j).ravel(), minlength=d)
    assert (cols == 1).all()


@pytest.mark.parametrize("b,sq,sk,hq,hkv", [(4, 128, 128, 4, 2), (2, 128, 128, 4, 2),
                                             (1, 65, 130, 2, 1)])
@pytest.mark.parametrize("d", [16, 5, 24, 32])
def test_bf16_head_dim_16_runs_the_mma_kernels_over_every_column_once(b, sq, sk, hq, hkv, d):
    """The same shapes on the mma route, the tiny trainer's (and at D 5, 24
    and 32 the route's other padded widths and a D off a multiple of 8):
    dQ blocks (x, h, b) own query rows 64 (gx - 1 - x) + 16w + g (+ 8) of
    warp w < 4, lane 4g + t, dK/dV blocks (x, hk, b) the keys 64x + 16w + g
    (+ 8); each thread stores columns 8n + 2t and 8n + 2t + 1 below D for n <
    DP / 8 (``store2``), and only rows or keys below Sq or Sk: every
    gradient element is stored once.  Shared memory: six tiles of 64 rows of
    DP + 8 elements, and dK/dV's two buffers of 64 LSEs and 64 D_i."""
    q, k, v, o, do = (t.bfloat16() for t in _tensors((b, sq, sk, hq, hkv, d, 0)))
    assert fa.bwd_route(torch.bfloat16, d) == "mma"
    pl = fa.plan_bwd(q, k, v, o, do)
    dp = fa.padded_dim(d)
    assert pl.route == "mma" and pl.maps is None and dp in (16, 32)
    assert pl.grids == ((-(-sq // 64), hq, b), (-(-sk // 64), hkv, b))
    assert pl.smem == fa.bwd_mma_smem_bytes(d) == (2 * 6 * 64 * (dp + 8),
                                                  2 * 6 * 64 * (dp + 8) + 4 * 4 * 64)
    assert fa.BWD_ROUTE_KERNELS["mma"] == ("bwd_mma_dq", "bwd_mma_dkdv")
    w, g, t, r, n = np.meshgrid(np.arange(4), np.arange(8), np.arange(4), np.arange(2),
                                np.arange(dp // 8), indexing="ij")
    rows = (16 * w + g + 8 * r).ravel()
    base = (8 * n + 2 * t).ravel()
    for which, n_rows, heads in (("bwd_mma_dq", sq, hq), ("bwd_mma_dkdv", sk, hkv)):
        gx, gy, gz = pl.grids[fa.BWD_MMA_KERNELS.index(which)]
        assert (gy, gz) == (heads, b)
        hits = np.zeros((b, n_rows, heads, dp), dtype=np.int64)
        for x in range(gx):
            tile = gx - 1 - x if which == "bwd_mma_dq" else x
            rr = tile * 64 + rows
            for col in (base, base + 1):
                keep = (rr < n_rows) & (col < d)
                for h in range(gy):
                    for bi in range(gz):
                        np.add.at(hits, (bi, rr[keep], h, col[keep]), 1)
        assert (hits[..., :d] == 1).all() and not hits[..., d:].any(), which


def test_plan_bwd_checks():
    q, k, v, o, do = _tensors((1, 8, 8, 4, 2, 64, 0))
    with pytest.raises(ValueError, match="shaped as q"):
        fa.plan_bwd(q, k, v, o[:, :4], do)
    with pytest.raises(ValueError, match="shaped as q"):
        fa.plan_bwd(q, k, v, o, do.bfloat16())
    with pytest.raises(TypeError):
        fa.plan_bwd(*(t.int() for t in (q, k, v, o, do)))
    with pytest.raises(ValueError, match="head dim"):
        fa.plan_bwd(*_tensors((1, 8, 8, 4, 2, 257, 0)))
    with pytest.raises(ValueError, match="causal_offset"):
        fa.plan_bwd(q, k, v, o, do, causal_offset=-1)


def test_tiling_constants_match_the_cuda_source():
    src = (Path(fa.__file__).resolve().parents[1] / "csrc"
           / "flash_attention_bwd.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("BQ"), const("BK"), const("THREADS")) == (
        fa.BWD_ROWS, fa.BWD_KEYS, fa.BWD_THREADS)
    assert "constexpr int PS = BK + 1;" in src


def _kernel_model(q, k, v, o, do, off):
    """The three kernels' loops in float64: the stats pass's online LSE over
    the key tiles a query tile needs, dK/dV from the first query tile that
    sees a key tile, dQ over the needed key tiles; masks as the kernels'."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g, scale = hq // hkv, 1.0 / math.sqrt(d)
    R, K = fa.BWD_ROWS, fa.BWD_KEYS
    q, k, v, o, do = (t.double() for t in (q, k, v, o, do))

    def n_key_tiles(q0):
        last = min(q0 + R, sq) - 1
        return -(-min(sk, off + last + 1) // K)

    def live(r0, k0):
        rows = torch.arange(r0, r0 + R)[:, None]
        keys = torch.arange(k0, k0 + K)[None, :]
        return (rows < sq) & (keys < sk) & (off + rows >= keys)

    def tile(t, h, r0, n):
        out = torch.zeros((b, R, d), dtype=torch.float64)
        out[:, :max(0, min(R, n - r0))] = t[:, r0:r0 + R, h]
        return out

    lse = torch.zeros((b, hq, sq), dtype=torch.float64)
    dvec = (do * o).sum(-1).permute(0, 2, 1)
    for h in range(hq):
        for r0 in range(0, sq, R):
            m = torch.full((b, R), -1e30, dtype=torch.float64)
            lsum = torch.zeros((b, R), dtype=torch.float64)
            for t in range(n_key_tiles(r0)):
                s = torch.einsum("brd,bkd->brk", tile(q, h, r0, sq),
                                 tile(k, h // g, t * K, sk)) * scale
                s = torch.where(live(r0, t * K), s, -1e30)
                m_new = torch.maximum(m, s.amax(-1))
                lsum = lsum * torch.exp(m - m_new) + torch.exp(s - m_new[..., None]).sum(-1)
                m = m_new
            n = min(R, sq - r0)
            lse[:, h, r0:r0 + n] = (m + torch.log(lsum))[:, :n]
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)

    def p_ds(h, r0, k0):
        lse_t = torch.zeros((b, R), dtype=torch.float64)
        dv_t = torch.zeros((b, R), dtype=torch.float64)
        n = max(0, min(R, sq - r0))
        lse_t[:, :n], dv_t[:, :n] = lse[:, h, r0:r0 + n], dvec[:, h, r0:r0 + n]
        qt, dot = tile(q, h, r0, sq), tile(do, h, r0, sq)
        kt, vt = tile(k, h // g, k0, sk), tile(v, h // g, k0, sk)
        s = torch.einsum("brd,bkd->brk", qt, kt) * scale
        p = torch.where(live(r0, k0), torch.exp(s - lse_t[..., None]), 0.0)
        ds = p * (torch.einsum("brd,bkd->brk", dot, vt) - dv_t[..., None])
        return p, ds, qt, dot, kt
    for hk in range(hkv):
        for k0 in range(0, sk, K):
            first = max(0, k0 - off)
            acc_k = torch.zeros((b, K, d), dtype=torch.float64)
            acc_v = torch.zeros((b, K, d), dtype=torch.float64)
            for h in range(hk * g, hk * g + g):
                for r0 in range((first // R) * R if first < sq else sq, sq, R):
                    p, ds, qt, dot, _ = p_ds(h, r0, k0)
                    acc_v += torch.einsum("brk,brd->bkd", p, dot)
                    acc_k += torch.einsum("brk,brd->bkd", ds, qt)
            n = min(K, sk - k0)
            dk[:, k0:k0 + n, hk] = (acc_k * scale)[:, :n]
            dv[:, k0:k0 + n, hk] = acc_v[:, :n]
    for h in range(hq):
        for r0 in range(0, sq, R):
            acc = torch.zeros((b, R, d), dtype=torch.float64)
            for t in range(n_key_tiles(r0)):
                _, ds, _, _, kt = p_ds(h, r0, t * K)
                acc += torch.einsum("brk,bkd->brd", ds, kt)
            n = min(R, sq - r0)
            dq[:, r0:r0 + n, h] = (acc * scale)[:, :n]
    return dq, dk, dv


@pytest.mark.parametrize("shape", [(1, 70, 70, 4, 2, 16, 0), (1, 5, 150, 2, 1, 16, 100),
                                   (1, 130, 65, 2, 2, 16, 0), (1, 3, 200, 2, 2, 16, 3)],
                         ids=str)
def test_kernel_loops_model_matches_plain(shape):
    q, k, v, do = map(torch.from_numpy, _inputs(shape, seed=3))
    off = shape[-1]
    o = fa.gqa_flash_plain(q, k, v, off)
    got = _kernel_model(q, k, v, o, do, off)
    want = fa.gqa_flash_bwd_plain(q, k, v, o, do, off)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), rtol=1e-5, atol=1e-5)
