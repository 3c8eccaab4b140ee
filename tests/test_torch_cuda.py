"""The hand-written CUDA kernels of the PyTorch port against their plain
versions, on the card.  Every test here is marked ``cuda`` and skips
without a CUDA device; the file imports neither JAX nor ``repro``, so it
runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

KNN tolerances: distances rtol/atol 1e-5 (fp32 sums of 13..256 squared terms
in another order than the plain version); for the batch kernel atol 1e-4,
because its plain version uses the norm expansion, whose float32
cancellation error is about eps * (||q||^2 + ||x||^2) in d2.  Indices are
equal up to ties.  Flash attention: rtol = atol = 2e-5 in fp32 (TF32 off)
and 5e-2 in bf16, the JAX package's kernel tolerances, and the whole output
within a relative L2 of 2e-5 (fp32) and 1e-2 (bf16) of the plain version:
outputs of long causal rows are small beside the bf16 atol, and the
relative L2 catches a kernel whose outputs are all off by a common factor.
Each of the three flash kernels (Hopper wgmma, mma.sync, fp32) is held to
these on the shapes its route gives it.
DAG gating: integer counts, equal exactly.  Score matrix: one IEEE
division per element in both versions, equal exactly.  Oracle greedy pass:
the same float32 adds in the same order, equal bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.knowledge import KnowledgeBase
from repro_torch.core.policy import learn_window
from repro_torch.experiment import Scenario
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gating, knn, oracle_greedy, ops, score

WEEK = 24 * 7
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}
FLASH_REL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


def _inputs(n, d, q=None, seed=0):
    rng = np.random.default_rng(seed)
    cases = rng.normal(size=(n, d)).astype(np.float32)
    if q is None:
        return cases, rng.normal(size=(d,)).astype(np.float32)
    return cases, rng.normal(size=(q, d)).astype(np.float32)


def _assert_flash_close(got, want, what):
    tol, rel_tol = FLASH_TOL[want.dtype], FLASH_REL[want.dtype]
    got, want = got.float().cpu(), want.float().cpu()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol, atol=tol,
                               err_msg=what)
    rel = (torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)).item()
    assert rel <= rel_tol, f"{what}: relative L2 {rel}"


def _assert_topk_close(dist, idx, dist_ref, idx_ref, cases, queries,
                       rtol=1e-5, atol=1e-5):
    dist, dist_ref = np.asarray(dist), np.asarray(dist_ref)
    idx, idx_ref = np.atleast_2d(np.asarray(idx)), np.atleast_2d(np.asarray(idx_ref))
    np.testing.assert_allclose(dist, dist_ref, rtol=rtol, atol=atol)
    q64 = np.atleast_2d(queries).astype(np.float64)
    c64 = cases.astype(np.float64)
    for r, j in zip(*np.nonzero(idx != idx_ref)):
        a = np.linalg.norm(c64[idx[r, j]] - q64[r])
        b = np.linalg.norm(c64[idx_ref[r, j]] - q64[r])
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    knn.build()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 257, 1344, 2048, 2049, 9000])
@pytest.mark.parametrize("k", [1, 5, 8])
def test_kernel_topk_matches_plain(cuda, n, k):
    if k > n:
        pytest.skip("k > N")
    cases, q = _inputs(n, 13, seed=n + k)
    c, qq = torch.from_numpy(cases).to(cuda), torch.from_numpy(q).to(cuda)
    knn.reset_launches()
    dist, idx = knn.knn_topk(c, qq, k)
    torch.cuda.synchronize()
    assert knn.launches["knn_topk"] == 1
    dr, ir = knn.knn_topk_plain(c, qq, k)
    _assert_topk_close(dist.cpu(), idx.cpu(), dr.cpu(), ir.cpu(), cases, q[None])


def _batch_inputs(q, n, d, seed):
    """Queries and cases; past 8 rows a tie of four across the cluster
    kernel's slices (rows 1, rows-1, rows and 2 rows of ``batch_plan``, or
    the last rows where those pass the end), nearest to query 0 (0.05 off in every feature: away from
    0, where the plain version's norm expansion loses ~1e-3 through the
    sqrt), and a NaN row."""
    cases, qs = _inputs(n, d, q=q, seed=seed)
    if n > 8:
        rows = knn.batch_plan(n, d, q, 1)["rows"]
        tied = list(dict.fromkeys(min(r, n - 1) for r in (1, rows - 1, rows, 2 * rows,
                                                           n - 1, n - 2, n - 3)))[:4]
        cases[tied] = cases[1]
        qs[0] = cases[1] + np.float32(0.05)
        cases[n // 2 + 1] = np.nan
    return cases, qs


@pytest.mark.cuda
@pytest.mark.parametrize("q,n,d", [(1, 5, 13), (3, 5, 13), (168, 1344, 13), (170, 1344, 13),
                                   (1344, 1344, 13), (13, 4099, 13), (37, 3000, 64),
                                   (9, 700, 256)])
@pytest.mark.parametrize("k", [1, 5, 8])
def test_kernel_topk_batch_matches_plain(cuda, q, n, d, k):
    """The cluster kernel against the plain version, and bit for bit against
    ``knn_topk`` on every query: Q not a multiple of the group, N=5 against 8
    slices (6 of them empty), a base that outgrows a block (3000 x 64: 8
    chunks over 7 slices), a tie of four across slices and a NaN row."""
    if k > n:
        pytest.skip("k > N")
    torch.backends.cuda.matmul.allow_tf32 = False
    cases, qs = _batch_inputs(q, n, d, seed=q + n)
    c, qq = torch.from_numpy(cases).to(cuda), torch.from_numpy(qs).to(cuda)
    knn.reset_launches()
    dist, idx = knn.knn_topk_batch(c, qq, k)
    torch.cuda.synchronize()
    assert knn.launches["knn_topk_batch"] == knn.launches["cluster"] == 1
    dr, ir = knn.knn_topk_batch_plain(c, qq, k)
    _assert_topk_close(dist.cpu(), idx.cpu(), dr.cpu(), ir.cpu(), cases, qs,
                       rtol=1e-5, atol=1e-4)
    if n > 8:                               # the tie, in index order
        tied = np.flatnonzero((cases == cases[1]).all(axis=1))
        assert len(tied) == 4 and idx[0, :min(k, 4)].tolist() == tied[:k].tolist()
    # the batch kernel adds the same fmaf chain as the single-query one
    for i in range(q):
        d1, i1 = knn.knn_topk(c, qq[i].contiguous(), k)
        assert torch.equal(d1, dist[i]) and torch.equal(i1, idx[i]), i


@pytest.mark.cuda
@pytest.mark.parametrize("q,n,d", [(1, 5, 13), (168, 1344, 13), (37, 3000, 64), (9, 700, 256)])
@pytest.mark.parametrize("k", [1, 5, 8])
def test_kernel_topk_batch_routes_agree(cuda, q, n, d, k):
    """The previous batch kernel (``route="warp"``) equals the cluster
    kernel bit for bit; each launch counts on its route."""
    if k > n:
        pytest.skip("k > N")
    cases, qs = _batch_inputs(q, n, d, seed=2 * q + n)
    c, qq = torch.from_numpy(cases).to(cuda), torch.from_numpy(qs).to(cuda)
    knn.reset_launches()
    new = knn.knn_topk_batch(c, qq, k)
    old = knn.knn_topk_batch(c, qq, k, route="warp")
    torch.cuda.synchronize()
    assert knn.launches == {"knn_topk": 0, "knn_topk_batch": 2, "cluster": 1, "warp": 1}
    assert all(torch.equal(a, b) for a, b in zip(new, old))
    with pytest.raises(ValueError, match="route"):
        knn.knn_topk_batch(c, qq, k, route="tiles")


@pytest.mark.cuda
def test_kernel_ties_and_checks(cuda):
    cases = torch.zeros((3000, 4), device=cuda)
    cases[[5, 2100, 2999]] = 1.0
    q = torch.ones(4, device=cuda)
    _, idx = knn.knn_topk(cases, q, 3)
    assert idx.tolist() == [5, 2100, 2999]
    _, bidx = knn.knn_topk_batch(cases, q[None].contiguous(), 3)
    assert bidx.tolist() == [[5, 2100, 2999]]
    with pytest.raises(TypeError):
        knn.knn_topk(cases.double(), q.double(), 3)
    with pytest.raises(ValueError):
        knn.knn_topk(cases, q, 9)
    with pytest.raises(ValueError):
        knn.knn_topk(cases.t(), q[:3].contiguous(), 3)
    with pytest.raises(ValueError):
        knn.knn_topk(cases, q.cpu(), 3)


def _device_query_lookup(cases, q, k):
    """The per-slot lookup from device tensors: the query copied to the
    card, the kernel, indices and float64 distances copied back one after
    the other."""
    dist, idx = knn.knn_topk(cases, torch.as_tensor(q, dtype=torch.float32).to(cases.device), k)
    return dist.double().cpu().numpy(), idx.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 257, 1344, 4099])
@pytest.mark.parametrize("k", [1, 5, 8])
def test_kernel_lookup_matches_plain_and_device_query(cuda, n, k):
    """``knn_lookup`` (query as the launch parameter, neighbours written into
    pinned host memory): one launch per call, distances within the plain
    version's tolerance and bit for bit those of the device-query protocol,
    ties (duplicated rows) to the lower index."""
    if k > n:
        pytest.skip("k > N")
    cases, q = _inputs(n, 13, seed=3 * n + k)
    if n > 8:
        cases[[n // 3, n // 2, n - 1]] = cases[1]          # a tie of four
        q = cases[1] + np.float32(1e-3)
    c = torch.from_numpy(cases).to(cuda)
    knn.reset_launches()
    dist, idx = knn.knn_lookup(c, q.astype(np.float64), k)
    assert knn.launches == {"knn_topk": 1, "knn_topk_batch": 0, "cluster": 0, "warp": 0}
    assert dist.dtype == np.float64 and idx.dtype == np.int64 and dist.shape == (k,)
    dp, ip = knn.knn_topk_plain(c, torch.from_numpy(q).to(cuda), k)
    _assert_topk_close(dist, idx, dp.cpu(), ip.cpu(), cases, q[None])
    dq, iq = _device_query_lookup(c, q, k)
    np.testing.assert_array_equal(dist, dq)
    np.testing.assert_array_equal(idx, iq)
    if n > 8 and k >= 4:
        assert idx[:4].tolist() == [1, n // 3, n // 2, n - 1]


@pytest.mark.cuda
def test_kernel_lookup_tiling_and_checks(cuda):
    lib = knn._lib
    for d in (1, 13, 64, 255, 256):
        for n in (1, 2048, 2049, 4099, 50_000):
            assert lib.knn_topk_blocks(n, d) == knn.query_blocks(n, d)
    cases = torch.from_numpy(_inputs(3000, 256)[0]).to(cuda)
    q = np.ones(256)
    dist, idx = knn.knn_lookup(cases, q, 8)           # D = 256: 16 blocks and the merge
    dr, ir = knn.knn_topk_plain(cases, torch.ones(256, device=cuda), 8)
    np.testing.assert_allclose(dist, dr.double().cpu().numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="host memory"):
        knn.knn_lookup(cases, torch.ones(256, device=cuda), 3)
    with pytest.raises(ValueError):
        knn.knn_lookup(cases, np.ones(255), 3)
    with pytest.raises(ValueError):
        knn.knn_lookup(cases, q, 9)
    with pytest.raises(TypeError):
        knn.knn_lookup(cases.double(), q, 3)


@pytest.mark.cuda
def test_kb_on_cuda_matches_cpu_neighbours(cuda):
    mat = Scenario(capacity=8, learn_weeks=3, family="alibaba",
                   seed=101).materialize()
    cpu = KnowledgeBase(device="cpu")
    learn_window(cpu, mat.hist, mat.ci, 0, WEEK, mat.cluster,
                 offsets=(0, WEEK, 2 * WEEK))
    kb = KnowledgeBase.from_windows(list(cpu._windows), device="cuda")
    assert kb.case_matrix().device.type == "cuda"
    assert kb.case_matrix().dtype == torch.float32
    X = np.concatenate([w[0] for w in cpu._windows])
    rng = np.random.default_rng(7)
    states = X[rng.integers(len(X), size=120)] \
        * (1.0 + 0.05 * rng.normal(size=(120, X.shape[1])))
    knn.reset_launches()
    m, r, d = kb.query_batch(states)
    for i, s in enumerate(states):
        m1, r1, d1 = kb.query(s)
        _, _, dc = cpu.query(s)
        np.testing.assert_allclose(d1, dc, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(d1, d[i])
        np.testing.assert_array_equal(m1, m[i])
        k, q = kb._prepare(s, None)
        dq, iq = _device_query_lookup(kb.case_matrix(), q, k)
        np.testing.assert_array_equal(d1, dq)
        np.testing.assert_array_equal(m1, kb._Y[iq, 0])
    # one lookup launch per query, one batch launch, and the protocol's launches
    assert knn.launches == {"knn_topk": 2 * len(states), "knn_topk_batch": 1,
                            "cluster": 1, "warp": 0}


@pytest.fixture
def cuda_flash():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    fa.build()
    return torch.device("cuda")


FLASH_GRID = [(sq, extra, hq, group, d)
              for sq in (1, 17, 64, 130) for extra in (0, 37, 200)
              for hq, group in ((2, 1), (4, 2), (8, 4)) for d in (32, 64, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_kernel_flash_matches_plain(cuda_flash, dtype):
    for sq, extra, hq, group, d in FLASH_GRID:
        rng = np.random.default_rng(sq + extra + hq + d)
        sk = sq + extra
        q, k, v = (torch.from_numpy(rng.normal(size=(2, n, h, d)).astype(np.float32))
                   .to(cuda_flash, dtype) for n, h in ((sq, hq), (sk, hq // group),
                                                        (sk, hq // group)))
        fa.reset_launches()
        out = fa.gqa_flash(q, k, v, causal_offset=extra)
        torch.cuda.synchronize()
        assert fa.launches["gqa_flash"] == 1
        assert fa.launches[fa.route(dtype, d)] == 1
        assert out.dtype == dtype and out.shape == q.shape
        want = fa.gqa_flash_plain(q, k, v, causal_offset=extra)
        _assert_flash_close(out, want, str((sq, extra, hq, group, d, dtype)))


def _flash_qkv(device, b, sq, sk, hq, hkv, d, seed, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(b, n, h, d)).astype(np.float32))
                 .to(device, dtype) for n, h in ((sq, hq), (sk, hkv), (sk, hkv)))


# Rows and keys that are not multiples of the Hopper kernel's 128-row tiles,
# Sk up to Sq + 200 (the offset), at both of its head dims.
@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,extra", [(1, 0), (1, 200), (17, 37), (130, 0), (130, 200),
                                      (2047, 0), (2047, 131)])
def test_kernel_flash_wgmma_ragged(cuda_flash, sq, extra, d):
    q, k, v = _flash_qkv(cuda_flash, 2, sq, sq + extra, 8, 2, d, seed=sq + extra + d)
    fa.reset_launches()
    out = fa.gqa_flash(q, k, v, causal_offset=extra)
    torch.cuda.synchronize()
    assert fa.launches == {"gqa_flash": 1, "wgmma": 1, "mma_sync": 0, "fp32": 0}
    _assert_flash_close(out, fa.gqa_flash_plain(q, k, v, causal_offset=extra),
                        f"Sq={sq} Sk={sq + extra} D={d}")


# The serving path's shapes: the llama3-8b prefill (on the Hopper kernel and
# on the retained mma.sync kernel) and a decode-like single row over a long
# cache.
@pytest.mark.cuda
@pytest.mark.parametrize("shape,kernel", [
    ((4, 2048, 2048, 32, 8, 128, 0), "wgmma"),
    ((4, 2048, 2048, 32, 8, 128, 0), "mma_sync"),
    ((4, 1, 2112, 32, 8, 128, 2111), "wgmma"),
])
def test_kernel_flash_serving_shapes(cuda_flash, shape, kernel):
    b, sq, sk, hq, hkv, d, off = shape
    q, k, v = _flash_qkv(cuda_flash, b, sq, sk, hq, hkv, d, seed=sq)
    fa.reset_launches()
    out = fa.launch(q, k, v, off, kernel=kernel)
    torch.cuda.synchronize()
    assert fa.launches["gqa_flash"] == fa.launches[kernel] == 1
    _assert_flash_close(out, fa.gqa_flash_plain(q, k, v, causal_offset=off),
                        f"{shape} {kernel}")


@pytest.mark.cuda
def test_kernel_flash_routes(cuda_flash):
    """The prefill's shape and D = 64 count under the Hopper kernel's
    route; bf16 at D = 32 stays on the mma.sync kernel, fp32 on its own."""
    cases = [((1, 256, 256, 32, 8, 128), torch.bfloat16, "wgmma"),
             ((1, 256, 256, 8, 2, 64), torch.bfloat16, "wgmma"),
             ((1, 256, 256, 8, 2, 32), torch.bfloat16, "mma_sync"),
             ((1, 256, 256, 8, 2, 128), torch.float32, "fp32")]
    for (b, sq, sk, hq, hkv, d), dtype, kernel in cases:
        q, k, v = _flash_qkv(cuda_flash, b, sq, sk, hq, hkv, d, seed=d, dtype=dtype)
        fa.reset_launches()
        out = fa.gqa_flash(q, k, v)
        torch.cuda.synchronize()
        assert fa.launches["gqa_flash"] == fa.launches[kernel] == 1, (d, dtype, fa.launches)
        _assert_flash_close(out, fa.gqa_flash_plain(q, k, v), f"D={d} {dtype}")
    with pytest.raises(ValueError, match="does not take"):
        fa.launch(q, k, v, kernel="wgmma")


@pytest.mark.cuda
def test_kernel_flash_strided_and_checks(cuda_flash):
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.normal(size=(2, 70, 3, 8, 64)).astype(np.float32)) \
        .to(cuda_flash, torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1, :4], qkv[:, :, 2, :4]   # strided views
    want = fa.gqa_flash_plain(q, k, v, causal_offset=5)
    fa.reset_launches()
    got = fa.gqa_flash(q, k, v, causal_offset=5)
    assert fa.launches["wgmma"] == 1
    _assert_flash_close(got, want, "strided views")
    wide = torch.from_numpy(rng.normal(size=(2, 150, 3, 8, 128)).astype(np.float32)) \
        .to(cuda_flash, torch.bfloat16)                        # the same at D = 128
    q, k, v = wide[:, :, 0], wide[:, :, 1, :2], wide[:, :, 2, 2:4]
    _assert_flash_close(fa.gqa_flash(q, k, v, causal_offset=9),
                        fa.gqa_flash_plain(q, k, v, causal_offset=9), "strided views D=128")
    ok = q.contiguous(), k.contiguous(), v.contiguous()
    with pytest.raises(ValueError, match="head dim"):
        x = torch.zeros((1, 4, 2, 96), device=cuda_flash)
        fa.gqa_flash(x, x, x)
    with pytest.raises(TypeError):
        fa.gqa_flash(*(t.half() for t in ok))
    with pytest.raises(TypeError):
        fa.gqa_flash(ok[0].float(), ok[1], ok[2])
    with pytest.raises(ValueError, match="unit stride"):
        fa.gqa_flash(ok[0].transpose(1, 3).contiguous().transpose(1, 3), ok[1], ok[2])
    with pytest.raises(ValueError, match="CUDA device"):
        fa.gqa_flash(ok[0], ok[1].cpu(), ok[2])
    with pytest.raises(ValueError, match="causal_offset"):
        fa.gqa_flash(*ok, causal_offset=-1)


@pytest.fixture
def cuda_gating():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gating.build()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_edges,batch", [(256, 0, 1), (256, 37, 1),
                                             (1024, 3000, 3), (6144, 5924, 64)])
def test_kernel_gating_matches_plain(cuda_gating, n, n_edges, batch):
    """Exact int32 counts against the plain versions, with duplicate edges
    and one row of in-degree 90."""
    rng = np.random.default_rng(n + n_edges + batch)
    parents = np.concatenate([rng.integers(0, n - 1, n_edges),
                              rng.integers(0, n - 1, 90)])
    children = np.concatenate([rng.integers(0, n - 1, n_edges), np.full(90, 3)])
    parents = np.concatenate([parents, parents[:n_edges // 3]])
    children = np.concatenate([children, children[:n_edges // 3]])
    fin = torch.from_numpy(rng.random((batch, n)) < 0.3).to(cuda_gating)
    graph = gating.dep_graph(parents, children, n, device=cuda_gating)
    gating.reset_launches()
    got = gating.dep_decrement_csr(fin, graph)
    torch.cuda.synchronize()
    assert gating.launches["dep_decrement"] == 1
    p, c = (torch.from_numpy(x).to(cuda_gating) for x in (parents, children))
    want = gating.dep_decrement_plain(fin, p, c, n)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(gating.dep_decrement(fin[0], p, c, n), want[0])
    assert torch.equal(gating.dep_decrement_csr(fin.to(torch.uint8), graph), want)


@pytest.mark.cuda
def test_kernel_gating_checks(cuda_gating):
    graph = gating.dep_graph(np.array([0, 1]), np.array([2, 2]), 4, device=cuda_gating)
    fin = torch.zeros(4, dtype=torch.bool, device=cuda_gating)
    with pytest.raises(TypeError, match="bool or uint8"):
        gating.dep_decrement_csr(fin.int(), graph)
    with pytest.raises(TypeError, match="int32"):
        gating.dep_decrement_csr(fin, gating.DepGraph(graph.pred_ptr.long(),
                                                      graph.pred_idx.long()))
    with pytest.raises(TypeError, match="int32 or int64"):
        gating.dep_decrement(fin, torch.tensor([0], device=cuda_gating).short(),
                             torch.tensor([2], device=cuda_gating).short(), 4)
    with pytest.raises(ValueError, match="same CUDA device"):
        gating.dep_decrement_csr(fin, gating.dep_graph(np.array([0]), np.array([2]), 4,
                                                       device="cpu"))
    with pytest.raises(ValueError, match=r"\(n,\) or \(B, n\)"):
        gating.dep_decrement_csr(torch.zeros(5, dtype=torch.bool, device=cuda_gating),
                                 graph)
    with pytest.raises(ValueError, match="contiguous"):
        gating.dep_decrement_csr(torch.zeros((4, 3), dtype=torch.bool,
                                             device=cuda_gating).t(), graph)


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_edges,batch", [(256, 0, 1), (256, 37, 64),
                                             (1024, 3000, 1), (6144, 5924, 64)])
def test_kernel_release_matches_plain(cuda_gating, n, n_edges, batch):
    """``dep_release_csr`` against its plain version, exact: duplicate
    edges, a row of in-degree 90, rows of in-degree 0 and (in a batch)
    all-zero rows of fin and arrived; one launch, no ``dep_decrement``
    launch."""
    rng = np.random.default_rng(7 * n + n_edges + batch)
    parents = np.concatenate([rng.integers(0, n - 1, n_edges), rng.integers(0, n - 1, 90)])
    children = np.concatenate([rng.integers(0, n - 1, n_edges), np.full(90, 3)])
    parents = np.concatenate([parents, parents[:n_edges // 3]])
    children = np.concatenate([children, children[:n_edges // 3]])
    deg = np.bincount(children, minlength=n)
    assert (deg == 0).any()
    fin = rng.random((batch, n)) < 0.3
    arrived = rng.random((batch, n)) < 0.7
    if batch > 1:
        fin[0], arrived[-1] = False, False            # empty rows
    pred = (deg - np.minimum(rng.integers(0, 3, (batch, n)), deg)).astype(np.int32)
    args = [torch.from_numpy(x).to(cuda_gating) for x in (fin, arrived, pred)]
    graph = gating.dep_graph(parents, children, n, device=cuda_gating)
    gating.reset_launches()
    pred2, pending = gating.dep_release_csr(*args, graph)
    torch.cuda.synchronize()
    assert gating.launches == {"dep_decrement": 0, "dep_release": 1}
    want = gating.dep_release_csr_plain(*args, graph)
    assert pred2.dtype == torch.int32 and pending.dtype == torch.bool
    assert torch.equal(pred2, want[0]) and torch.equal(pending, want[1])
    assert (n_edges == 0 or pending.any()) and (batch == 1 or not pending[-1].any())
    one = gating.dep_release_csr(*(a[0] for a in args), graph)     # (n,)
    assert torch.equal(one[0], want[0][0]) and torch.equal(one[1], want[1][0])
    with pytest.raises(TypeError, match="int32"):
        gating.dep_release_csr(args[0], args[1], args[2].long(), graph)
    with pytest.raises(ValueError, match="must all be"):
        gating.dep_release_csr(args[0], args[1][:, :-1].contiguous(), args[2], graph)
    with pytest.raises(ValueError, match="same CUDA device"):
        gating.dep_release_csr(args[0], args[1].cpu(), args[2], graph)


@pytest.mark.cuda
def test_dag_scan_on_cuda_equals_cpu(cuda_gating):
    """A small DAG week through the device slot loop on the card and on the
    CPU: equal bit for bit, the release kernel launched once per slot step."""
    from repro_torch.core import scan_engine
    from repro_torch.experiment import run
    from repro_torch.traces import DagConfig

    kw = dict(dag=DagConfig(), engine="scan", capacity=12, learn_weeks=1, seed=7)
    cpu = run(Scenario(**kw), device="cpu")
    scan_engine.reset_stats()
    gating.reset_launches()
    card = run(Scenario(**kw), device="cuda")
    assert gating.launches["dep_release"] == scan_engine.stats["dag_steps"] >= 3 * WEEK
    assert gating.launches["dep_decrement"] == 0
    for name in card.policies:
        for a, b in zip(cpu.weekly[name], card.weekly[name], strict=True):
            assert a.carbon_g == b.carbon_g and a.energy_kwh == b.energy_kwh
            np.testing.assert_array_equal(a.completion, b.completion)
            np.testing.assert_array_equal(a.wait_slots, b.wait_slots)
            np.testing.assert_array_equal(a.violations, b.violations)
            assert [vars(x) for x in a.slots] == [vars(y) for y in b.slots]


@pytest.fixture
def cuda_oracle():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    score.build()
    oracle_greedy.build()
    return torch.device("cuda")


def _same(a, b):
    """Equal exactly, NaN where the other is NaN."""
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(a.masked_fill(nan, 0),
                                                       b.masked_fill(nan, 0))


def _score_inputs(j, t, seed, device):
    rng = np.random.default_rng(seed)
    marg = rng.uniform(0, 1, j).astype(np.float32)
    ci = rng.uniform(20, 600, t).astype(np.float32)
    ci[::4] = np.array([0.0, 1e-9, 1e-12, -3.0], np.float32)[np.arange(len(ci[::4])) % 4]
    if t > 5:
        ci[5] = np.nan                      # stays NaN inside a window
    ts = rng.integers(0, t, j).astype(np.int32)
    te = rng.integers(0, t + 5, j).astype(np.int32)
    te[::3] = t + 40
    ts[1::5] = te[1::5]
    ts[2::7], te[2::7] = te[2::7] + 1, ts[2::7].copy()    # start after end
    return [torch.from_numpy(x).to(device) for x in (marg, ci, ts, te)]


@pytest.mark.cuda
@pytest.mark.parametrize("j,t", [(1, 1), (1, 777), (1000, 1), (257, 129),
                                 (3000, 168), (2500, 552), (6945, 168), (6801, 552),
                                 (100, 168), (1000, 4096), (3, 3070), (5, 20001)])
def test_kernel_score_matches_plain(cuda_oracle, j, t):
    """Equal exactly, on shapes no tile divides (6945 and 6801 rows: a
    ragged last block of 1), 1 and 2 rows a block, T no multiple of 4 or
    above ROW_FLOATS (the columns route), windows past the end, empty or
    reversed, and intensities at or below the 1e-9 floor or NaN."""
    args = _score_inputs(j, t, j + t, cuda_oracle)
    score.reset_launches()
    got = ops.score_matrix(*args)
    torch.cuda.synchronize()
    route = score.plan(j, t)["route"]
    assert route == ("rows" if t % 4 == 0 and t <= score.ROW_FLOATS else "columns")
    assert score.launches["score_matrix"] == score.launches[route] == 1
    want = score.score_matrix_plain(*args)
    assert got.dtype == torch.float32 and got.shape == (j, t)
    assert _same(got, want)
    assert _same(got.cpu(), score.score_matrix_plain(*(a.cpu() for a in args)))


@pytest.mark.cuda
@pytest.mark.parametrize("j,t", [(1, 1), (257, 129), (6945, 168), (6800, 552), (3, 3070),
                                 (7, 777)])
def test_kernel_score_routes_agree(cuda_oracle, j, t):
    """The previous kernel (``route="flat"``) and the columns route equal the
    default route bit for bit, NaN where it is NaN."""
    args = _score_inputs(j, t, 3 * j + t, cuda_oracle)
    score.reset_launches()
    outs = {r: score.score_matrix(*args, route=r) for r in ("flat", "columns")}
    outs["default"] = score.score_matrix(*args)
    torch.cuda.synchronize()
    assert score.launches["score_matrix"] == 3 and score.launches["flat"] == 1
    for r, out in outs.items():
        assert _same(out, outs["default"]), r


@pytest.mark.cuda
def test_kernel_score_unaligned_ci_takes_columns(cuda_oracle):
    """A ``ci`` that starts off a 16-byte boundary (a view) cannot be read
    as float4s: the wrapper takes the columns route, equal to the plain
    version; the rows route refuses it."""
    args = _score_inputs(300, 168, 5, cuda_oracle)
    wide = torch.zeros(169, device=cuda_oracle)
    wide[1:] = args[1]
    args[1] = wide[1:]
    score.reset_launches()
    got = score.score_matrix(*args)
    torch.cuda.synchronize()
    assert score.launches["columns"] == 1
    assert _same(got, score.score_matrix_plain(*args))
    with pytest.raises(ValueError, match="aligned"):
        score.score_matrix(*args, route="rows")


@pytest.mark.cuda
def test_kernel_score_checks(cuda_oracle):
    marg, ci = torch.ones(3, device=cuda_oracle), torch.ones(5, device=cuda_oracle)
    ts = torch.zeros(3, dtype=torch.int32, device=cuda_oracle)
    te = torch.full((3,), 4, dtype=torch.int32, device=cuda_oracle)
    with pytest.raises(TypeError, match="marginals"):
        score.score_matrix(marg.double(), ci, ts, te)
    with pytest.raises(TypeError, match="t_end"):
        score.score_matrix(marg, ci, ts, te.long())
    with pytest.raises(ValueError, match="same CUDA device"):
        score.score_matrix(marg, ci.cpu(), ts, te)
    with pytest.raises(ValueError, match="must match"):
        score.score_matrix(marg, ci, ts[:2], te)
    with pytest.raises(ValueError, match="contiguous"):
        score.score_matrix(torch.ones(6, device=cuda_oracle)[::2], ci, ts, te)
    score.reset_launches()
    assert score.score_matrix(marg[:0], ci, ts[:0], te[:0]).shape == (0, 5)
    assert score.launches["score_matrix"] == 0


def _greedy_inputs(device, capacity, cut=None):
    """The entries of a learning window of a small scenario, packed as the
    device pass hands them over, with kmin, lengths and the largest scale."""
    from repro_torch.core import oracle

    mat = Scenario(capacity=8, learn_weeks=1, family="alibaba", seed=101).materialize()
    jobs = [j for j in mat.hist if j.arrival < WEEK][:cut]
    j, t, k, g, _ = oracle._build_entries(jobs, mat.ci.trace[:WEEK], WEEK)
    args = oracle_greedy.upload(j, t, k, g, [x.k_min for x in jobs],
                                [x.length for x in jobs], device)
    return list(args), capacity, WEEK, int(k.max())


def _greedy_equal(got, want, what):
    for name, a, b in zip(("alloc", "used", "work", "walked"), got, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b), f"{what}: {name}"


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["smem", "l2"])
@pytest.mark.parametrize("capacity,cut", [(8, None), (3, None), (40, 30)])
def test_kernel_greedy_matches_plain(cuda_oracle, capacity, cut, route):
    """Bit for bit against the plain pass on each route: the full window, an
    overloaded capacity, and few jobs on a large cluster, where every job
    finishes and both stop early."""
    args, cap, horizon, k_max = _greedy_inputs(cuda_oracle, capacity, cut)
    oracle_greedy.reset_launches()
    got = oracle_greedy.greedy_pass(*args, cap, horizon, k_max, route=route)
    torch.cuda.synchronize()
    assert oracle_greedy.launches == {"greedy_pass": 1, "smem": route == "smem",
                                      "l2": route == "l2"}
    want = oracle_greedy.greedy_pass_plain(*(a.cpu() for a in args), cap, horizon)
    _greedy_equal(got, want, route)
    if cut is not None:
        assert 0 < want[3].item() < args[0].shape[0]


def _synthetic_window(n, horizon, n_entries, seed, k_max=4, length=3.0):
    """Seeded random entries over n jobs x horizon slots, mixed k_min."""
    rng = np.random.default_rng(seed)
    kmin = rng.integers(1, 3, n)
    j = rng.integers(0, n, n_entries)
    k = np.minimum(kmin[j] + rng.integers(0, 3, n_entries), k_max)
    return oracle_greedy.upload(j, rng.integers(0, horizon, n_entries), k,
                                rng.uniform(0.1, 0.9, n_entries), kmin,
                                rng.uniform(0.5, length, n), "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,horizon", [(883, WEEK), (884, WEEK), (923, WEEK), (924, WEEK),
                                       (48, 400), (1, 1)])
def test_kernel_greedy_route_boundary(cuda_oracle, n, horizon):
    """At the largest window the smem route holds with every job's window
    the whole horizon (883 jobs; the dense layout before it held 923), one
    job more, the extension solve's shape and the smallest: the planned
    route, its shared memory equal to the library's, and both routes (where
    they fit) equal to the plain pass, through an early exit on the last."""
    args = list(_synthetic_window(n, horizon, 30_000, seed=n + horizon))
    plan = oracle_greedy.plan(n, horizon, 4)
    assert plan["route"] == ("smem" if n <= 883 else "l2")
    lib = oracle_greedy._lib
    for i, route in enumerate(oracle_greedy.ROUTES):
        fits = lib.greedy_smem_bytes(i, n, horizon, n * horizon)
        assert fits == (oracle_greedy.smem_bytes(route, n, horizon)
                        if oracle_greedy.smem_bytes(route, n, horizon)
                        <= oracle_greedy.SMEM_MAX else -1)
    want = oracle_greedy.greedy_pass_plain(*(a.cpu() for a in args), 5, horizon)
    oracle_greedy.reset_launches()
    got = oracle_greedy.greedy_pass(*args, 5, horizon, 4)
    torch.cuda.synchronize()
    assert oracle_greedy.launches[plan["route"]] == 1
    _greedy_equal(got, want, f"{n} x {horizon} on {plan['route']}")
    if plan["route"] == "smem":
        _greedy_equal(oracle_greedy.greedy_pass(*args, 5, horizon, 4, route="l2"),
                      want, f"{n} x {horizon} on l2")
    if (n, horizon) == (1, 1):
        assert want[3].item() < 30_000      # the one job finishes: early exit


def _synthetic_span(n, horizon, n_entries, seed, k_max=4, width=(8, 40), start=(-5, None)):
    """Seeded random jobs with admissible windows of the given widths and
    starts and entries only inside them, uploaded with the windows; and
    their cells."""
    rng = np.random.default_rng(seed)
    kmin = rng.integers(1, 3, n)
    t0 = rng.integers(start[0], start[1] or horizon, n)
    t1 = t0 + rng.integers(*width, n)
    windows = np.stack([t0, t1], 1)
    lo, hi, _, cells = oracle_greedy.ragged_layout(windows, horizon)
    j = rng.choice(np.nonzero(hi > lo)[0], n_entries)
    t = lo[j] + (rng.random(n_entries) * (hi - lo)[j]).astype(np.int64)
    k = np.minimum(kmin[j] + rng.integers(0, 3, n_entries), k_max)
    args = oracle_greedy.upload(j, t, k, rng.uniform(0.1, 0.9, n_entries), kmin,
                                rng.uniform(0.5, 6.0, n), "cuda", windows=windows)
    return list(args), cells


def _plain_with_windows(args, capacity, horizon):
    """``greedy_pass_plain`` on the CPU copies of (entries, kmin, lengths,
    windows)."""
    entries, kmin, lengths, windows = (a.cpu() for a in args)
    return oracle_greedy.greedy_pass_plain(entries, kmin, lengths, capacity, horizon,
                                           windows=windows)


@pytest.mark.cuda
@pytest.mark.parametrize("n,horizon,n_entries", [(425, 552, 227_568), (1500, WEEK, 120_000),
                                                 (3, 9, 500)])
def test_kernel_greedy_windows_match_plain_and_l2(cuda_oracle, n, horizon, n_entries):
    """alloc laid out by window on the smem route, at a 552-slot span's
    shape and at more jobs than whole-horizon 168-slot windows fit: bit for
    bit with the plain pass and with the l2 walker given the same windows,
    and with whole-horizon windows where those fit; windows without their
    cells are refused."""
    args, cells = _synthetic_span(n, horizon, n_entries, seed=n)
    plan = oracle_greedy.plan(n, horizon, 4, cells)
    assert plan["route"] == "smem" and oracle_greedy.plan(n, horizon, 4)["route"] == \
        ("smem" if n == 3 else "l2")
    assert oracle_greedy._lib.greedy_smem_bytes(0, n, horizon, cells) == plan["smem_bytes"]
    want = _plain_with_windows(args, 5, horizon)
    assert want[1].sum().item() > 0
    oracle_greedy.reset_launches()
    got = oracle_greedy.greedy_pass(*args[:3], 5, horizon, 4, windows=args[3],
                                    cells=cells)
    torch.cuda.synchronize()
    assert oracle_greedy.launches == {"greedy_pass": 1, "smem": 1, "l2": 0}
    _greedy_equal(got, want, f"{n} x {horizon} by window on smem")
    with pytest.raises(ValueError, match="come together"):
        oracle_greedy.greedy_pass(*args[:3], 5, horizon, 4, windows=args[3])
    _greedy_equal(oracle_greedy.greedy_pass(*args[:3], 5, horizon, 4, route="l2",
                                            windows=args[3], cells=cells),
                  want, "l2 with windows")
    if n == 3:
        _greedy_equal(oracle_greedy.greedy_pass(*args[:3], 5, horizon, 4), want,
                      "whole-horizon windows")


@pytest.mark.cuda
@pytest.mark.parametrize("n,horizon,width", [(883, WEEK, WEEK), (884, WEEK, WEEK),
                                             (2000, WEEK, 50)])
def test_kernel_greedy_route_boundary_with_cells(cuda_oracle, n, horizon, width):
    """Where windows laid out whole fit and one job more does not: the
    library's byte count equals ``smem_bytes``, and the planned route
    equals the plain pass."""
    args, cells = _synthetic_span(n, horizon, 40_000, seed=width, width=(width, width + 1),
                                  start=(0, 1) if width == horizon else (-5, None))
    assert width != horizon or cells == n * horizon
    plan = oracle_greedy.plan(n, horizon, 4, cells)
    assert plan["route"] == ("l2" if n == 884 else "smem")
    fits = oracle_greedy._lib.greedy_smem_bytes(0, n, horizon, cells)
    nbytes = oracle_greedy.smem_bytes("smem", n, horizon, cells)
    assert fits == (nbytes if nbytes <= oracle_greedy.SMEM_MAX else -1)
    want = _plain_with_windows(args, 5, horizon)
    oracle_greedy.reset_launches()
    got = oracle_greedy.greedy_pass(*args[:3], 5, horizon, 4, windows=args[3], cells=cells)
    torch.cuda.synchronize()
    assert oracle_greedy.launches[plan["route"]] == 1
    _greedy_equal(got, want, f"{n} x {horizon} on {plan['route']}")


@pytest.mark.cuda
def test_kernel_greedy_bad_window_entry(cuda_oracle, monkeypatch):
    """An entry outside its job's window: walked = -1 - i on both routes, the
    plain pass and ``solve``'s device pass raise."""
    args, cells = _synthetic_span(40, 100, 5000, seed=3)
    win = args[3].cpu().numpy()
    lo, hi, _, _ = oracle_greedy.ragged_layout(win, 100)
    bad = args[0].clone()
    j = int(bad[6, 0])
    bad[6, 1] = int(hi[j]) if hi[j] < 100 else int(lo[j]) - 1
    for route in oracle_greedy.ROUTES:
        *_, walked = oracle_greedy.greedy_pass(bad, *args[1:3], 5, 100, 4, route=route,
                                               windows=args[3], cells=cells)
        assert walked.item() == -7, route
    with pytest.raises(IndexError, match="window"):
        _plain_with_windows([bad] + args[1:], 5, 100)
    *_, walked = oracle_greedy.greedy_pass(bad, *args[1:3], 5, 100, 4)   # whole horizon
    assert walked.item() >= 0

    from repro_torch.core import oracle

    mat = Scenario(capacity=8, learn_weeks=1, family="alibaba", seed=101).materialize()
    jobs = [x for x in mat.hist if x.arrival < WEEK][:30]
    build_entries = oracle._build_entries

    def moved(jobs, ci, horizon):
        """The first entry of a job whose window leaves a slot free, moved
        just outside that window."""
        out = build_entries(jobs, ci, horizon)
        t0, t1, _ = oracle._windows(jobs, horizon)
        i = next(i for i, j in enumerate(out[0]) if t0[j] > 0 or t1[j] < horizon)
        j = out[0][i]
        out[1][i] = t0[j] - 1 if t0[j] > 0 else t1[j]
        return out

    monkeypatch.setattr(oracle, "_build_entries", moved)
    with pytest.raises(RuntimeError, match="outside its job's window"):
        oracle.solve(jobs, mat.ci.trace[:WEEK], 8, backend="device", device=cuda_oracle)


@pytest.mark.cuda
def test_kernel_greedy_forwarding(cuda_oracle):
    """Runs of entries on one job, one cell and one slot back to back, so
    every entry's prefetched state must be forwarded from the one before:
    equal to the plain pass on both routes."""
    n, horizon, reps = 6, 5, 4000
    rng = np.random.default_rng(11)
    j = np.repeat(rng.integers(0, n, reps // 4), 4)
    t = np.repeat(rng.integers(0, horizon, reps // 2), 2)
    k = np.tile([1, 2, 3, 4], reps // 4)
    args = oracle_greedy.upload(j, t, k, rng.uniform(0.2, 0.9, reps), np.ones(n, int),
                                np.full(n, 400.0), "cuda")
    want = oracle_greedy.greedy_pass_plain(*(a.cpu() for a in args), 7, horizon)
    assert want[1].sum().item() > 0
    for route in oracle_greedy.ROUTES:
        _greedy_equal(oracle_greedy.greedy_pass(*args, 7, horizon, 4, route=route),
                      want, route)


@pytest.mark.cuda
def test_kernel_greedy_checks(cuda_oracle):
    args, cap, horizon, k_max = _greedy_inputs(cuda_oracle, 8, cut=20)
    bad = list(args)
    bad[2] = bad[2].double()
    with pytest.raises(TypeError, match="lengths"):
        oracle_greedy.greedy_pass(*bad, cap, horizon, k_max)
    bad = list(args)
    bad[1] = bad[1].cpu()
    with pytest.raises(ValueError, match="same CUDA device"):
        oracle_greedy.greedy_pass(*bad, cap, horizon, k_max)
    bad = list(args)
    bad[0] = bad[0][:, :3].contiguous()
    with pytest.raises(ValueError, match=r"\(E, 4\)"):
        oracle_greedy.greedy_pass(*bad, cap, horizon, k_max)
    with pytest.raises(ValueError, match="shared memory"):
        oracle_greedy.greedy_pass(*args, cap, 60_000, k_max)
    with pytest.raises(ValueError, match="shared memory"):
        oracle_greedy.greedy_pass(*args, cap, 10_000, k_max, route="smem")
    for route in oracle_greedy.ROUTES:
        bad = list(args)
        bad[0] = bad[0].clone()
        bad[0][0, 1] = horizon                # a slot index out of range
        *_, walked = oracle_greedy.greedy_pass(*bad, cap, horizon, k_max, route=route)
        assert walked.item() == -1
    bad = list(args)
    bad[0] = bad[0].clone()
    bad[0][3, 2] = 256                        # a scale no byte holds
    *_, walked = oracle_greedy.greedy_pass(*bad, cap, horizon, k_max, route="smem")
    assert walked.item() == -4


@pytest.mark.cuda
def test_solve_device_backend_on_cuda_equals_cpu(cuda_oracle):
    """``oracle.solve(backend="device")`` on the card and on the CPU, with
    deadline extensions: equal in every output, one launch per pass."""
    from repro_torch.core import oracle

    mat = Scenario(capacity=8, learn_weeks=1, family="alibaba", seed=101).materialize()
    jobs = [j for j in mat.hist if j.arrival < WEEK]
    ci = mat.ci.trace[:WEEK]
    cpu = oracle.solve(jobs, ci, 3, backend="device", device="cpu")
    oracle.reset_stats()
    oracle_greedy.reset_launches()
    card = oracle.solve(jobs, ci, 3, backend="device", device=cuda_oracle)
    assert oracle_greedy.launches["greedy_pass"] == oracle.stats["device_passes"] > 1
    assert oracle_greedy.launches["smem"] == oracle_greedy.launches["greedy_pass"]
    assert card.schedule.extended.any()
    for name in ("capacity_curve", "rho_curve", "work_done"):
        np.testing.assert_array_equal(getattr(card, name), getattr(cpu, name))
    np.testing.assert_array_equal(card.schedule.alloc, cpu.schedule.alloc)
    np.testing.assert_array_equal(card.schedule.extended, cpu.schedule.extended)


@pytest.mark.cuda
def test_ops_on_cuda_launch_the_kernels(cuda_oracle):
    knn.build()
    rng = np.random.default_rng(3)
    cases = torch.from_numpy(rng.normal(size=(500, 13)).astype(np.float32)).to(cuda_oracle)
    qs = torch.from_numpy(rng.normal(size=(4, 13)).astype(np.float32)).to(cuda_oracle)
    knn.reset_launches()
    assert all(torch.equal(a, b) for a, b in zip(ops.knn_topk(cases, qs[0], 5),
                                                 knn.knn_topk(cases, qs[0], 5)))
    assert all(torch.equal(a, b) for a, b in zip(ops.knn_topk_batch(cases, qs, 5),
                                                 knn.knn_topk_batch(cases, qs, 5)))
    assert knn.launches == {"knn_topk": 2, "knn_topk_batch": 2, "cluster": 2, "warp": 0}
