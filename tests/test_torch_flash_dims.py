"""``gqa_flash`` at every head dim 1..256 and every float dtype, against the
JAX package, on the CPU.

The reference's Pallas ``gqa_flash`` takes any dtype and any head dim (its
body casts to fp32 and back); the port routes each (dtype, D) to a
hand-written kernel: "wgmma" for bf16 and fp16 at every D (off a multiple
of 8 on staged inputs), "fp32" for fp32 and fp64 (fp64 on fp32 copies);
"mma_sync" only by name.  Here, without a card:

- the plain forward against the Pallas kernel in interpret mode and
  ``flash_attention_ref`` at D in {8, 33, 96, 160, 256} x {fp32, bf16,
  fp16}, Sq != Sk, an offset: 2e-5 in fp32, 5e-2 in bf16 (the reference's
  kernel tolerances, ``tests/test_kernels.py``), 1e-2 in fp16 (11
  significant bits against bf16's 8: one output rounding is 5e-4 at 1);
- the plain backward against ``jax.vjp`` of ``chunked_attention`` and of
  ``flash_attention_ref`` on the same (rounded) inputs in fp32: 2e-5 in
  fp32; 1e-2 for bf16 and fp16, whose gradients are rounded once to the
  type (bf16 at most 2^-9 relative);
- a reduced llama3-8b at head dim 24 with fp16 compute, logits against the
  reference's on its Pallas backend;
- ``route`` and ``bwd_route`` at every (dtype, D), the pinned pairs
  unchanged, D 257 refused; the launch plans' grids walked as the kernels
  walk them (each output element stored once, none past D), the tensor
  maps' zero-filled columns, every instantiation's shared memory within a
  block's 227 KB; the dry-run's ``meta`` route at new head dims.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.kernels import ops, ref
from repro.launch.mesh import make_mesh
from repro.models import LogicalRules
from repro.models import api as japi
from repro.models.common import chunked_attention as jchunked_attention
from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import op_analysis
from repro_torch.models import api

DIMS = (8, 33, 96, 160, 256)
DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 5e-2),
          "float16": (torch.float16, jnp.float16, 1e-2)}
BWD_TOL = {"float32": 2e-5, "bfloat16": 1e-2, "float16": 1e-2}
# B, Sq, Sk, Hq, Hkv, causal offset: Sq != Sk, ragged against every tile
SHAPE = (1, 37, 70, 4, 2, 33)
SMEM_LIMIT = 232_448          # a block's dynamic shared memory on an H100
FLOATS = (torch.float16, torch.bfloat16, torch.float32, torch.float64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor ops: one intra-op thread runs them as fast serially
    and does not thrash when test workers share cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(d, seed):
    b, sq, sk, hq, hkv, _ = SHAPE
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, hq, d))]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", DIMS)
def test_plain_forward_matches_pallas_and_ref(d, dtype):
    tdt, jdt, tol = DTYPES[dtype]
    q, k, v, _ = _inputs(d, seed=d)
    off = SHAPE[-1]
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    pallas = ops.flash_attention(jq, jk, jv, causal_offset=off, interpret=True,
                                 block_q=64, block_k=64)
    expect = ref.flash_attention_ref(jq, jk, jv, causal_offset=off)
    out = fa.gqa_flash(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal_offset=off)
    assert out.dtype == tdt and out.shape == q.shape
    for want in (pallas, expect):
        np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", DIMS)
def test_plain_backward_matches_jax_vjp(d, dtype):
    tdt = DTYPES[dtype][0]
    tol = BWD_TOL[dtype]
    q, k, v, do = (torch.from_numpy(a).to(tdt) for a in _inputs(d, seed=d + 1))
    off = SHAPE[-1]
    q32, k32, v32, do32 = (jnp.asarray(t.float().numpy()) for t in (q, k, v, do))
    o = fa.gqa_flash_plain(q, k, v, off)
    got = fa.gqa_flash_bwd_plain(q, k, v, o, do, off)
    for fn in (lambda a, b, c: jchunked_attention(a, b, c, off, 16),
               lambda a, b, c: ref.flash_attention_ref(a, b, c, off)):
        _, vjp = jax.vjp(fn, q32, k32, v32)
        for g, w in zip(got, vjp(do32)):
            assert g.dtype == tdt
            np.testing.assert_allclose(g.float().numpy(), np.asarray(w), rtol=tol, atol=tol)


def test_fp64_runs_as_fp32_and_casts_back():
    """float64 inputs: the plain versions compute in fp32 (as the reference's
    kernel body) and return float64."""
    q, k, v, do = (torch.from_numpy(a).double() for a in _inputs(33, seed=3))
    off = SHAPE[-1]
    out = fa.gqa_flash(q, k, v, off)
    assert out.dtype == torch.float64
    assert torch.equal(out, fa.gqa_flash_plain(q.float(), k.float(), v.float(), off).double())
    grads = fa.gqa_flash_bwd(q, k, v, out, do, off)
    want = fa.gqa_flash_bwd_plain(*(t.float() for t in (q, k, v, out, do)), off)
    assert all(g.dtype == torch.float64 and torch.equal(g, w.double())
               for g, w in zip(grads, want))


def _reduced_fp16(backend, jbackend):
    cfg = dataclasses.replace(configs.reduced(configs.ARCHS["llama3-8b"]), head_dim=24,
                              compute_dtype=torch.float16, attention_backend=backend)
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.ARCHS["llama3-8b"]), head_dim=24,
                               compute_dtype=jnp.float16, attention_backend=jbackend)
    return cfg, jcfg


def test_reduced_config_head_dim_24_fp16_matches_reference():
    """Reduced llama3-8b at head dim 24 and fp16 compute: the port's forward
    (the plain flash on the CPU) against the reference's on its Pallas
    backend, from the same weights.  The two packages round fp16 at other
    places around the attention (the reference's own Pallas and XLA
    backends differ by 2.1e-3 relative L2 here; fp32 compute agrees to
    1.2e-5), so the logits are held within 1e-2 relative L2 (reading
    4.9e-3); the attention itself, the port's flash against its chunked
    attention in the same model, within 2e-3 (reading 5.2e-4)."""
    cfg, jcfg = _reduced_fp16("flash", "pallas")
    jparams = japi.init_params(jcfg, jax.random.key(0))
    params = api.params_from_reference(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 40))
    rules = LogicalRules(make_mesh((1, 1), ("data", "model")))
    want = np.asarray(japi.forward(jparams, jnp.asarray(toks, jnp.int32), jcfg, rules),
                      np.float32)
    got = api.forward(params, torch.from_numpy(toks), cfg).float().numpy()
    chunked = api.forward(params, torch.from_numpy(toks),
                          dataclasses.replace(cfg, attention_backend="chunked")).float().numpy()
    assert got.shape == (2, 40, cfg.vocab_size) and np.isfinite(got).all()
    assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)
    assert np.linalg.norm(got - chunked) <= 2e-3 * np.linalg.norm(chunked)


# --- routing and launch arithmetic ---------------------------------------------

def _staged(shape, dtype):
    """A meta tensor laid out as ``fa.stage`` lays one out: the [..., :D]
    view of rows ``tma_width(D)`` wide (contiguous where D is a multiple of
    8)."""
    *lead, d = shape
    return torch.empty((*lead, fa.tma_width(d)), dtype=dtype, device="meta")[..., :d]


def test_route_at_every_head_dim_and_dtype():
    for dtype in FLOATS:
        for d in range(1, 257):
            half = dtype in (torch.float16, torch.bfloat16)
            want = "wgmma" if half else "fp32"
            assert fa.route(dtype, d) == want, (dtype, d)
            assert fa.bwd_route(dtype, d) == ("wgmma" if half else "tiled")
            q, k = _staged((1, 3, 4, d), dtype), _staged((1, 5, 2, d), dtype)
            assert fa.plan(q, k, k, causal_offset=2).route == want
            assert fa.plan_bwd(q, k, k, q, q, causal_offset=2).route == fa.bwd_route(dtype, d)
        for d in (0, 257, 512):
            with pytest.raises(ValueError, match="head dims 1..256"):
                fa.route(dtype, d)
            with pytest.raises(ValueError, match="head dims 1..256"):
                fa.bwd_route(dtype, d)
    for (dtype, d), kernel in fa.ROUTES.items():       # the model configs' pairs, pinned
        assert fa.route(dtype, d) == kernel
    assert fa.WGMMA_TILE_DIM == {64: 64, 112: 128, 128: 128}
    q = torch.empty((1, 3, 4, 257), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="head dim 257"):
        fa.plan(q, q, q)


def _walk_forward(pl, b, sq, hq, d, dp):
    """Each output element's stores under ``pl``, as the kernel of its route
    stores them (columns up to the tile's width, those past d skipped)."""
    hits = np.zeros((b, sq, hq, dp), dtype=np.int64)
    gx, gy, gz = pl.grid
    if pl.route == "wgmma":
        c, w, g, t, r, n = np.meshgrid(np.arange(2), np.arange(4), np.arange(8), np.arange(4),
                                       np.arange(2), np.arange(dp // 8), indexing="ij")
        keep_n = (8 * n < d).ravel()
        for z in range(gz):
            rows = ((gz - 1 - z) * fa.WGMMA_ROWS + 64 * c + 16 * w + g + 8 * r).ravel()
            cols = (8 * n + 2 * t).ravel()
            for h in range(gx):
                for bb in range(gy):
                    # store2: each of the pair's columns only below d
                    for col in (cols, cols + 1):
                        keep = (rows < sq) & keep_n & (col < d)
                        np.add.at(hits, (bb, rows[keep], h, col[keep]), 1)
        return hits
    if pl.route == "mma_sync":
        w, g, t, r, n = np.meshgrid(np.arange(4), np.arange(8), np.arange(4), np.arange(2),
                                    np.arange(dp // 8), indexing="ij")
        rows = (16 * w + g + 8 * r).ravel()
        base = (8 * n + 2 * t).ravel()
        keep_n = (8 * n < d).ravel()
        cols = [(base, keep_n & (base < d)), (base + 1, keep_n & (base + 1 < d))]
    else:
        # the tiled kernel (fp32, fp64): grid (Hq, B, query tiles, heaviest
        # first), thread (ty, tx) owning rows RT ty + i and columns tx + 16 j
        t = fa.tiled_fwd_tiling(d)
        ty, tx, i, j = np.meshgrid(np.arange(16), np.arange(16), np.arange(t.rt),
                                   np.arange(fa.tiled_slots(d)), indexing="ij")
        rows, c = (t.rt * ty + i).ravel(), (tx + 16 * j).ravel()
        for z in range(gz):
            r = (gz - 1 - z) * t.rows + rows
            for h in range(gx):
                for bb in range(gy):
                    keep = (c < d) & (r < sq)
                    np.add.at(hits, (bb, r[keep], h, c[keep]), 1)
        return hits
    for x in range(gx):
        r = x * fa.FWD_ROWS + rows
        for h in range(gy):
            for bb in range(gz):
                for col, ok in cols:
                    keep = ok & (r < sq)
                    np.add.at(hits, (bb, r[keep], h, col[keep]), 1)
    return hits


@pytest.mark.parametrize("dtype,d", [
    (torch.bfloat16, 40), (torch.float16, 72), (torch.bfloat16, 96), (torch.float16, 120),
    (torch.float16, 8), (torch.bfloat16, 33), (torch.float16, 100), (torch.bfloat16, 256),
    (torch.float32, 1), (torch.float32, 33), (torch.float32, 160), (torch.float64, 256),
    (torch.float16, 136), (torch.bfloat16, 192), (torch.bfloat16, 200), (torch.float16, 256)],
    ids=str)
def test_forward_grid_stores_each_output_once(dtype, d):
    b, sq, hq = 2, 130, 3
    q = _staged((b, sq, hq, d), dtype)
    pl = fa.plan(q, q, q)
    dp = fa.wgmma_tile_dim(d) if pl.route == "wgmma" else fa.padded_dim(d)
    hits = _walk_forward(pl, b, sq, hq, d, dp)
    assert (hits[..., :d] == 1).all() and not hits[..., d:].any()
    if pl.route == "wgmma":
        # TMA's boxes (16, 32 or 64 columns) cover the tile; the maps' extent d makes
        # every column at or past d a zero
        extent, box = pl.maps[0], pl.maps[7]
        loaded = np.arange(fa.wgmma_tile_dim(d) // box * box)
        assert extent == d and set(loaded[loaded < extent]) == set(range(d))
        assert fa.wgmma_tile_dim(d) - d < box and pl.smem == fa.wgmma_smem_bytes(d)
        assert pl.smem <= SMEM_LIMIT and fa.wgmma_tile_dim(d) % box == 0
        assert all(s % 16 == 0 for s in pl.maps[4:7])     # TMA's byte strides
        # boxes of the K/V tiles' keys: 128 up to width 128, 64 past it
        rows = 128 if d <= 128 else 64
        assert fa.wgmma_keys(d) == rows and all(pl.maps[11 * i + 9] == rows for i in range(3))


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 256), (torch.float16, 160),
                                     (torch.float32, 200), (torch.float16, 24),
                                     (torch.float32, 33)], ids=str)
def test_fma_grids_cover_each_gradient_once(dtype, d):
    """The fma route at a head dim: stats and dQ over query tiles of R =
    ``bwd_tile_rows(d)`` (dQ heaviest first), dK/dV over key tiles; thread
    (ty, tx) of each tile owns rows ty + 16i (i < R / 16) and stores columns
    tx + 16j below d (j < DP / 16)."""
    b, sq, sk, hq, hkv = 2, 75, 101, 4, 2
    q = torch.empty((b, sq, hq, d), dtype=dtype, device="meta")
    k = torch.empty((b, sk, hkv, d), dtype=dtype, device="meta")
    pl = fa.plan_bwd(q, k, k, q, q, causal_offset=26, route="fma")
    r, dp = fa.bwd_tile_rows(d), fa.padded_dim(d)
    assert pl.route == "fma" and r == (32 if dp == 256 else 64)
    assert pl.smem == fa.bwd_smem_bytes(d) and max(pl.smem) <= SMEM_LIMIT
    ty, tx, i, j = np.meshgrid(np.arange(16), np.arange(16), np.arange(r // 16),
                               np.arange(dp // 16), indexing="ij")
    rows, cols = (ty + 16 * i).ravel(), (tx + 16 * j).ravel()
    for which, n_rows, heads in (("bwd_dq", sq, hq), ("bwd_dkdv", sk, hkv)):
        gx, gy, gz = pl.grids[fa.BWD_KERNELS.index(which)]
        assert (gy, gz) == (heads, b)
        hits = np.zeros((b, n_rows, heads, dp), dtype=np.int64)
        for x in range(gx):
            tile = gx - 1 - x if which == "bwd_dq" else x
            rr = tile * r + rows
            keep = (rr < n_rows) & (cols < d)
            for h in range(gy):
                for bb in range(gz):
                    np.add.at(hits, (bb, rr[keep], h, cols[keep]), 1)
        assert (hits[..., :d] == 1).all() and not hits[..., d:].any(), which


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 40), (torch.float16, 72),
                                     (torch.bfloat16, 96), (torch.float16, 128),
                                     (torch.bfloat16, 200), (torch.float16, 256)], ids=str)
def test_wgmma_backward_plan_at_a_run_time_head_dim(dtype, d):
    b, sq, sk, hq, hkv = 2, 130, 200, 4, 2
    q = torch.empty((b, sq, hq, d), dtype=dtype, device="meta")
    k = torch.empty((b, sk, hkv, d), dtype=dtype, device="meta")
    pl = fa.plan_bwd(q, k, k, q, q, causal_offset=70)
    assert pl.route == "wgmma"
    assert pl.grids == ((hq, b, -(-sq // fa.BWD_WGMMA_DQ_ROWS)),
                        (hkv, b, -(-sk // fa.BWD_WGMMA_KV_KEYS)))
    assert pl.smem == fa.bwd_wgmma_smem_bytes(d) and max(pl.smem) <= SMEM_LIMIT
    assert [pl.maps[11 * i] for i in range(4)] == [d] * 4      # each map's extent: d
    rows = fa.BWD_WGMMA_BOX_ROWS if d <= 128 else fa.BWD_WGMMA_WIDE_BOX_ROWS
    assert all(pl.maps[11 * i + 9] == rows == fa.bwd_wgmma_box_rows(d) for i in range(4))


def test_every_instantiation_fits_a_block():
    for d in fa.PADDED_DIMS:
        assert fa.mma_smem_bytes(d) <= SMEM_LIMIT and fa.f32_smem_bytes(d) <= SMEM_LIMIT
        assert max(fa.bwd_smem_bytes(d)) <= SMEM_LIMIT
    for tile in (64, 128, 192, 256):
        assert fa.wgmma_smem_bytes(tile) <= SMEM_LIMIT
        assert max(fa.bwd_wgmma_smem_bytes(tile)) <= SMEM_LIMIT
    # width 256: Q (128 rows, 64 KiB) and two stages of K and V tiles of 64
    # keys; the backward's dQ: Q and dO (128 KiB) and three stages of 32
    # keys, its dK/dV: K and V, two stages of Q and dO, two fp32 P^T buffers
    assert fa.wgmma_smem_bytes(256) == 1024 + 65536 + 2 * 2 * 32768 + 8 * 7 == 197_688
    assert fa.bwd_wgmma_smem_bytes(256) == (1024 + 131072 + 3 * 32768 + 8 * 7,
                                            1024 + 65536 + 2 * (65536 + 512) + 32768 + 8 * 5)
    assert fa.bwd_wgmma_stages(192) == (4, 3) and fa.wgmma_stages(192) == 3
    # width 256: Q stays in shared memory beside two buffers each of K and V
    # (rows of 264 16-bit elements); fp32 tiles of 32 rows in the backward
    assert fa.mma_smem_bytes(256) == 2 * 5 * 64 * 264 == 168_960
    assert fa.f32_smem_bytes(256) == 4 * (192 * 257 + 64 * 65) == 214_016
    assert fa.bwd_smem_bytes(256) == (4 * 2 * 32 * 257, 4 * (4 * 32 * 257 + 2 * 32 * 33 + 64),
                                      4 * (4 * 32 * 257 + 32 * 33))
    # at 64 rows the dK/dV kernel's tiles of width 256 would not fit
    assert 4 * (4 * 64 * 257 + 2 * 64 * 65 + 128) > SMEM_LIMIT


def test_source_constants_and_routes():
    """The padded widths, the fma tiles' rows and the wgmma entry's dtypes
    and head dims are those the CUDA sources declare."""
    from pathlib import Path

    csrc = Path(fa.__file__).resolve().parents[1] / "csrc"
    fwd = (csrc / "flash_attention.cu").read_text()
    bwd = (csrc / "flash_attention_bwd.cu").read_text()
    widths = "d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256"
    assert widths in fwd and widths in bwd
    assert fa.PADDED_DIMS == (16, 32, 64, 128, 256)
    assert "return DP > 128 ? 32 : BQ;" in bwd and fa.BWD_WIDE_ROWS == 32
    for src, ns in ((fwd, "hopper"), (bwd, "wg")):
        assert "(dtype != 1 && dtype != 2) || d < 1 || d > 256)" in src   # the wgmma entries
        # any D in [1, 256]: off a multiple of 8 on the guarded instantiations
        assert f"d % 8 != 0 ? {ns}::by_tile<-1, __half>" in src
        assert f"d % 8 != 0 ? {ns}::by_tile<-1, __nv_bfloat16>" in src
        assert "CU_TENSOR_MAP_DATA_TYPE_FLOAT16" not in src      # in hopper.cuh
    assert "(dtype != 1 && dtype != 2) || d < 1 || d > 32)" in bwd      # the mma entry
    assert fa.BWD_MMA_MAX_DIM == 32
    assert "constexpr int keys_of(int d) { return d > 128 ? WIDE_KEYS : KEYS; }" in fwd
    assert "constexpr int WIDE_KEYS = 64;" in fwd and fa.WGMMA_WIDE_KEYS == 64
    assert "static constexpr int STAGES = D <= NARROW ? 4 : D == 64 || D == 192 ? 3 : 2;" in fwd
    assert [fa.wgmma_stages(t) for t in (16, 32, 64, 128, 192, 256)] == [4, 4, 3, 2, 3, 2]
    hopper = (csrc / "hopper.cuh").read_text()
    assert "CU_TENSOR_MAP_DATA_TYPE_FLOAT16" in hopper
    # mma.sync, shared by the forward's flash_mma_kernel and the mma backward
    assert "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32" in hopper


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 96), (torch.float16, 24),
                                     (torch.bfloat16, 256), (torch.float64, 40)], ids=str)
def test_meta_route_reports_new_head_dims(dtype, d):
    """The dry-run's ``meta`` route at head dims off the pinned routes: one
    kernel record a call with ``kernel_work``'s FLOPs and bytes."""
    b, s, hq, hkv = 2, 64, 4, 2
    q = torch.empty((b, s, hq, d), dtype=dtype, device="meta")
    k = torch.empty((b, s, hkv, d), dtype=dtype, device="meta")
    with op_analysis.OpCounter() as counter:
        out = fa.gqa_flash(q, k, k)
        grads = fa.gqa_flash_bwd(q, k, k, out, out)
    assert out.shape == q.shape and out.dtype == dtype and out.device.type == "meta"
    assert [g.shape for g in grads] == [q.shape, k.shape, k.shape]
    pairs = s * (s + 1) // 2
    fwd, bwd = counter.stats.by_op["gqa_flash"], counter.stats.by_op["gqa_flash_bwd"]
    assert fwd[0] == bwd[0] == 1
    assert fwd[1] == fa.kernel_work(q, k, 0, False)[0] == 2 * 2 * d * hq * b * pairs
    products = 8 if fa.bwd_route(dtype, d) == "fma" else 7
    assert bwd[1] == fa.kernel_work(q, k, 0, True)[0] == products * 2 * d * hq * b * pairs


def test_layout_copies_on_the_cpu_stay_uncounted():
    """On CPU tensors the plain version reads any layout; nothing is copied
    or counted.  A plan for the Hopper route refuses what TMA cannot read;
    the other routes need only unit stride along D."""
    base = torch.zeros((1, 10, 2, 97), dtype=torch.bfloat16)
    q = base[..., :96]                          # rows 194 bytes apart
    fa.reset_launches()
    fa.gqa_flash(q, q, q)
    assert fa.launches["layout_copy"] == 0
    with pytest.raises(ValueError, match="multiples of 8 elements"):
        fa.plan(q, q, q)
    odd = base[..., :33]                        # D 33: the Hopper route, rows 194 bytes apart
    with pytest.raises(ValueError, match="multiples of 8 elements"):
        fa.plan(odd, odd, odd)
    assert fa.plan(odd, odd, odd, kernel="mma_sync").route == "mma_sync"
    every_other = torch.zeros((1, 10, 2, 66), dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="unit stride"):
        fa.plan(every_other, odd, odd)
