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
these on the shapes its route gives it; fp16 (P and the output rounded to
11 significant bits, bf16's 8) to 1e-2 elementwise and 2e-3 relative L2,
float64 (the fp32 kernels on copies) to fp32's, at every head dim 1..256.
DAG gating: integer counts, equal exactly.  Score matrix: one IEEE
division per element in both versions, equal exactly.  Oracle greedy pass:
the same float32 adds in the same order, equal bit for bit.  Capacity fill:
integer arithmetic, equal exactly; the golden MPC and DAG sweeps on the
card reproduce their fixture files byte for byte.  Geo walk: every float64
product and sum of the migration rule is one IEEE operation in the kernel
and in the plain walk, so the two are equal exactly; a geo-flex week on the
card's scan engine equals the CPU's vector engine in every compared field.
Resilience: an outage week (single-region, DAG, geo) on the card's scan
engine and a faulted week asked of it equal the CPU's vector engine in
every field, ``resilience`` included.  Telemetry: the events the card's
scan engine decodes from its grids equal the CPU vector engine's, tuple for
tuple, on those outage weeks; ``PhaseProfiler.sync`` waits on the card.
MoE: the card's dispatch (top-k ids, slots, kept pairs, source tokens)
equals the plain dispatch on the CPU bit for bit on the card's own router
probabilities; a bf16 block within 1e-2 relative L2 of fp32 on the same
routing; a reduced MoE serve gives the same bits twice.  The knob tuner's
quick grid on the card's scan engine equals the CPU's vector engine.
rwkv6 and zamba2: the flash kernels at zamba2-7b's head dim 112 (the
Hopper route at its forward's shape and a ragged one, mma.sync and fp32 on
the ragged one) within the flash limits; the reduced configs (fp32)
served on the card within rtol = atol = 1e-3 of the same on the CPU (fp32
products in another order, chained through the recurrence and, in zamba2,
the attention), with the same greedy tokens.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.knowledge import KnowledgeBase
from repro_torch.core.policy import learn_window
from repro_torch.experiment import Scenario
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fill, gating, geo_walk, knn, oracle_greedy, ops, score

WEEK = 24 * 7
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2, torch.float16: 1e-2,
             torch.float64: 2e-5}
FLASH_REL = {torch.float32: 2e-5, torch.bfloat16: 1e-2, torch.float16: 2e-3,
             torch.float64: 2e-5}


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


# The backward: the fma route and the plain version compute in fp32 from the
# same inputs and round once to the inputs' dtype, so bf16 differs by at most
# an ulp of the result plus fp32 sums taken in another order; fp32
# elementwise 1e-4 (dK and dV sum dS Q and P dO over up to ~1000 rows and a
# group of heads, whose cancellations leave absolute errors ~1e-6 of terms of
# order 1).  The wgmma route rounds P and dS to bf16 as well: against the
# fp32 plain version the same limits (bf16's relative 1e-2 is what a bf16 P
# costs, as in the forward); against the plain version that rounds where it
# rounds, within BWD_ROUNDED_REL (only roundings that fall the other way
# differ, by an ulp).
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2, torch.float16: 2e-2,
           torch.float64: 1e-4}
BWD_REL = {torch.float32: 2e-5, torch.bfloat16: 1e-2, torch.float16: 1e-2,
           torch.float64: 2e-5}
BWD_ROUNDED_REL = 1e-3


@pytest.fixture
def cuda_flash_bwd(cuda_flash):
    fa.build_bwd()
    return cuda_flash


def _bwd_inputs(device, b, sq, sk, hq, hkv, d, seed, dtype):
    q, k, v = _flash_qkv(device, b, sq, sk, hq, hkv, d, seed, dtype)
    do = torch.from_numpy(np.random.default_rng(seed + 1).normal(size=(b, sq, hq, d))
                          .astype(np.float32)).to(device, dtype)
    return q, k, v, do


def _assert_bwd_close(got, want, what, rel_limit=None):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        tol, rel_tol = BWD_TOL[w.dtype], rel_limit or BWD_REL[w.dtype]
        assert g.dtype == w.dtype and g.shape == w.shape, (what, name)
        g, w = g.float().cpu(), w.float().cpu()
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=tol, atol=tol,
                                   err_msg=f"{what} {name}")
        norm = torch.linalg.vector_norm(w).item()
        if norm <= 1e-3 * w.numel() ** 0.5:
            continue    # a vanishing gradient (one visible key: dq is rounding
            #             residue of ~1e-7 in both): the elementwise test holds it
        rel = torch.linalg.vector_norm(g - w).item() / norm
        assert rel <= rel_tol, f"{what} {name}: relative L2 {rel}"


BWD_CASES = [(1, 0, 2, 1), (17, 37, 4, 2), (64, 0, 8, 4), (130, 0, 4, 2), (130, 200, 8, 4),
             (70, 3, 2, 2), (300, 0, 16, 2), (257, 129, 4, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("d", [16, 32, 64, 112, 128])
def test_kernel_flash_bwd_matches_plain(cuda_flash_bwd, dtype, d):
    """The fma route at every dtype and head dim (its own route for fp32; the
    yardstick of the mma route at bf16 D 16 and 32 and of the wgmma route
    elsewhere)."""
    for sq, extra, hq, group in BWD_CASES[:6]:
        q, k, v, do = _bwd_inputs(cuda_flash_bwd, 2, sq, sq + extra, hq, hq // group, d,
                                  seed=sq + extra + d, dtype=dtype)
        o = fa.gqa_flash_plain(q, k, v, causal_offset=extra)
        fa.reset_launches()
        got = fa.launch_bwd(q, k, v, o, do, causal_offset=extra, route="fma")
        torch.cuda.synchronize()
        assert fa.launches["gqa_flash_bwd"] == 1 and all(
            fa.launches[n] == 1 for n in fa.BWD_KERNELS), fa.launches
        want = fa.gqa_flash_bwd_plain(q, k, v, o, do, causal_offset=extra)
        _assert_bwd_close(got, want, str((sq, extra, hq, group, d, dtype)))
        again = fa.launch_bwd(q, k, v, o, do, causal_offset=extra, route="fma")
        assert all(torch.equal(a, b) for a, b in zip(got, again))   # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("d", [1, 16, 33, 100, 128, 136, 256])
def test_kernel_flash_tiled_matches_plain(cuda_flash_bwd, dtype, d):
    """fp32 and fp64's routes: the tiled forward with its LSE (the output
    bit for bit with and without it) and the tiled backward on that LSE,
    against the plain versions at the fp32 limits, two runs equal bits; the
    first design's kernels, named, agree too."""
    for sq, extra, hq, group in BWD_CASES[:6]:
        what = str((sq, extra, hq, group, d, dtype))
        q, k, v, do = _bwd_inputs(cuda_flash_bwd, 2, sq, sq + extra, hq, hq // group, d,
                                  seed=sq + extra + d, dtype=dtype)
        fa.reset_launches()
        o, lse = fa.launch(q, k, v, extra, with_lse=True)
        got = fa.launch_bwd(q, k, v, o, do, causal_offset=extra, lse=lse)
        torch.cuda.synchronize()
        assert {n: c for n, c in fa.launches.items() if c} == {
            "gqa_flash": 1, "fp32": 1, "gqa_flash_bwd": 1, "bwd_tiled_dq": 1,
            "bwd_tiled_dkdv": 1}, (what, fa.launches)
        assert torch.equal(o, fa.launch(q, k, v, extra))
        _assert_flash_close(o, fa.gqa_flash_plain(q, k, v, causal_offset=extra), what)
        np.testing.assert_allclose(lse.cpu().numpy(),
                                   fa.gqa_flash_lse_plain(q, k, extra).cpu().numpy(),
                                   rtol=2e-5, atol=2e-5)
        _assert_bwd_close(got, fa.gqa_flash_bwd_plain(q, k, v, o, do, causal_offset=extra), what)
        again = fa.launch_bwd(q, k, v, o, do, causal_offset=extra, lse=lse)
        assert all(torch.equal(a, b) for a, b in zip(got, again))   # no atomics
    _assert_flash_close(fa.launch(q, k, v, extra, kernel="fp32_simple"), o, what + " simple")
    _assert_bwd_close(fa.launch_bwd(q, k, v, o, do, extra, route="fma"), got, what + " fma")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 112, 128])
def test_kernel_flash_bwd_wgmma_matches_plain(cuda_flash_bwd, d):
    """The wgmma route (bf16, the LSE from the forward kernel) against the
    fp32 plain backward and against the plain version that rounds P and dS
    to bf16 where the kernels do, on offsets, ragged tails, Sq past Sk, keys
    no row sees and one key; launches one of each kernel; two runs equal."""
    # (Sq, Sk, offset, Hq, group): the fma cases, then keys no row sees, Sq
    # past Sk and one key
    cases = [(sq, sq + extra, extra, hq, group) for sq, extra, hq, group in BWD_CASES] + \
        [(5, 300, 3, 4, 2), (200, 65, 0, 4, 2), (3, 1, 7, 2, 1)]
    for sq, sk, off, hq, group in cases:
        q, k, v, do = _bwd_inputs(cuda_flash_bwd, 2, sq, sk, hq, hq // group, d,
                                  seed=sq + sk + d, dtype=torch.bfloat16)
        o, lse = fa.launch(q, k, v, off, with_lse=True)
        what = str((sq, sk, off, hq, group, d))
        fa.reset_launches()
        got = fa.gqa_flash_bwd(q, k, v, o, do, causal_offset=off, lse=lse)
        torch.cuda.synchronize()
        assert fa.launches["gqa_flash_bwd"] == 1 and all(
            fa.launches[n] == 1 for n in fa.BWD_WGMMA_KERNELS) and not any(
            fa.launches[n] for n in fa.BWD_KERNELS), fa.launches
        _assert_bwd_close(got, fa.gqa_flash_bwd_plain(q, k, v, o, do, causal_offset=off), what)
        _assert_bwd_close(got, fa.gqa_flash_bwd_lse_plain(q, k, v, o, do, lse, off,
                                                          round_bf16=True),
                          what + " rounded", rel_limit=BWD_ROUNDED_REL)
        again = fa.gqa_flash_bwd(q, k, v, o, do, causal_offset=off, lse=lse)
        assert all(torch.equal(a, b) for a, b in zip(got, again))   # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 112, 128])
def test_kernel_flash_lse_leaves_the_output_unchanged(cuda_flash, d):
    """The Hopper forward with and without its LSE: the output bit for bit,
    the LSE against ``gqa_flash_lse_plain`` (fp32 sums in another order:
    rtol = atol = 1e-4); the other routes write none."""
    for b, sq, sk, hq, hkv, off in [(2, 300, 300, 16, 8, 0), (2, 130, 330, 8, 2, 200),
                                    (1, 1, 2112, 8, 2, 2111), (2, 2048, 2048, 4, 4, 0)]:
        q, k, v = _flash_qkv(cuda_flash, b, sq, sk, hq, hkv, d, seed=sq + d)
        fa.reset_launches()
        out, lse = fa.launch(q, k, v, off, with_lse=True)
        plain_out = fa.gqa_flash(q, k, v, causal_offset=off)
        torch.cuda.synchronize()
        assert fa.launches["wgmma"] == 2 and torch.equal(out, plain_out)
        assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
        np.testing.assert_allclose(lse.cpu().numpy(),
                                   fa.gqa_flash_lse_plain(q, k, off).cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)
    # the mma.sync kernel writes it too (the mma backward reads it), and the
    # tiled fp32 kernel (the tiled backward reads it); the first design's
    # fp32 kernel none
    out, lse = fa.launch(q, k, v, off, kernel="mma_sync", with_lse=True)
    assert torch.equal(out, fa.launch(q, k, v, off, kernel="mma_sync"))
    np.testing.assert_allclose(lse.cpu().numpy(),
                               fa.gqa_flash_lse_plain(q, k, off).cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    out32, lse32 = fa.launch(q.float(), k.float(), v.float(), off, with_lse=True)
    assert torch.equal(out32, fa.launch(q.float(), k.float(), v.float(), off))
    np.testing.assert_allclose(lse32.cpu().numpy(),
                               fa.gqa_flash_lse_plain(q.float(), k.float(), off).cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="LSE"):
        fa.launch(q.float(), k.float(), v.float(), kernel="fp32_simple", with_lse=True)
    with pytest.raises(ValueError, match="LSE"):
        fa.launch_bwd(q, k, v, out, out)     # the wgmma route needs the forward's LSE


@pytest.mark.cuda
def test_kernel_flash_bwd_offsets_and_tails(cuda_flash_bwd):
    """Keys no row sees (Sk past offset + Sq), Sq > Sk, one key; fp32's
    route reads the forward's LSE."""
    for b, sq, sk, off in [(1, 5, 300, 3), (2, 200, 65, 0), (1, 1, 1, 0), (1, 3, 1, 7)]:
        q, k, v, do = _bwd_inputs(cuda_flash_bwd, b, sq, sk, 4, 2, 64, seed=sq * sk,
                                  dtype=torch.float32)
        o, lse = fa.launch(q, k, v, off, with_lse=True)
        _assert_bwd_close(fa.gqa_flash_bwd(q, k, v, o, do, causal_offset=off, lse=lse),
                          fa.gqa_flash_bwd_plain(q, k, v, o, do, causal_offset=off),
                          str((b, sq, sk, off)))


@pytest.mark.cuda
def test_kernel_flash_autograd_on_the_card(cuda_flash_bwd):
    """The Function launches the forward route with its LSE and the wgmma
    route's two backward kernels; its gradients are the kernels' own on the
    forward's LSE; a train-shaped call (internvl2-2b's heads, a shorter
    sequence) holds the limits; under no_grad nothing is saved and no
    backward exists."""
    q, k, v, do = _bwd_inputs(cuda_flash_bwd, 2, 300, 300, 16, 8, 128, seed=1,
                              dtype=torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.reset_launches()
    o = fa.gqa_flash(*leaves)
    o.backward(do.transpose(1, 2).contiguous().transpose(1, 2))   # a strided dO
    torch.cuda.synchronize()
    assert fa.launches == {"gqa_flash": 1, "wgmma": 1, "mma_sync": 0, "fp32": 0,
                           "fp32_simple": 0, "gqa_flash_bwd": 1, "bwd_stats": 0,
                           "bwd_dkdv": 0, "bwd_dq": 0, "bwd_wgmma_dq": 1, "bwd_wgmma_dkdv": 1,
                           "bwd_mma_dq": 0, "bwd_mma_dkdv": 0, "bwd_tiled_dq": 0,
                           "bwd_tiled_dkdv": 0, "layout_copy": 0}
    out, lse = fa.launch(q, k, v, with_lse=True)
    assert torch.equal(out, o.detach())
    direct = fa.launch_bwd(q, k, v, out, do, lse=lse)
    assert all(torch.equal(t.grad, g) for t, g in zip(leaves, direct))
    _assert_bwd_close(direct, fa.gqa_flash_bwd_plain(q, k, v, out, do), "train heads")
    with torch.no_grad():
        assert fa.gqa_flash(*leaves).grad_fn is None
    with pytest.raises(TypeError):
        fa.gqa_flash_bwd(*(t.int() for t in (q, k, v, o, do)))
    with pytest.raises(ValueError, match="shaped as q"):
        fa.gqa_flash_bwd(q, k, v, o[:, :-1], do[:, :-1])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["internvl2-2b", "stablelm-1.6b"])
def test_train_step_on_the_card(cuda_flash_bwd, arch):
    """A reduced config's train step (fp32, D 32: the tiled fp32 forward and
    backward kernels) on the card against the same step on the CPU (the
    plain versions): loss rtol 1e-5, grad norm rtol 2e-3 and every leaf's
    update within 5e-2 relative L2 (fp32 sums in another order; the same
    limits as against the reference, tests/test_torch_train.py); launches
    two forwards (remat) and one backward a layer; two runs equal bits."""
    from repro_torch import configs, train
    from repro_torch.train.step import leaves
    cfg = configs.reduced(configs.ARCHS[arch])
    opt = train.OptimizerConfig(lr=3e-4, warmup_steps=1, total_steps=10)
    loader = train.PrefetchLoader(train.SyntheticLM(train.DataConfig(
        batch=2, seq_len=80, vocab_size=cfg.vocab_size, seed=1)), device="cpu", model_cfg=cfg)
    batch = next(loader)
    loader.close()
    step = train.make_train_step(cfg, opt, ce_chunk=32)
    cpu0 = train.init_state(cfg, seed=0, device="cpu")
    want_state, want = step(cpu0, batch)
    card0 = train.TrainState(**{k: (_to_device(v, cuda_flash_bwd) if k != "step" else v)
                                for k, v in vars(cpu0).items()})
    on_card = {k: v.to(cuda_flash_bwd) for k, v in batch.items()}
    fa.reset_launches()
    got_state, got = step(card0, on_card)
    torch.cuda.synchronize()
    L = cfg.num_layers
    assert fa.launches == {"gqa_flash": 2 * L, "wgmma": 0, "mma_sync": 0, "fp32": 2 * L,
                           "fp32_simple": 0, "gqa_flash_bwd": L, "bwd_stats": 0,
                           "bwd_dkdv": 0, "bwd_dq": 0, "bwd_wgmma_dq": 0, "bwd_wgmma_dkdv": 0,
                           "bwd_mma_dq": 0, "bwd_mma_dkdv": 0, "bwd_tiled_dq": L,
                           "bwd_tiled_dkdv": L, "layout_copy": 0}
    np.testing.assert_allclose(got["loss"].item(), want["loss"].item(), rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"].item(), want["grad_norm"].item(), rtol=2e-3)
    old = dict(leaves(cpu0.params))
    for (path, a), (_, w) in zip(leaves(got_state.params), leaves(want_state.params)):
        delta, ref = a.cpu() - old[path], w - old[path]
        assert (torch.linalg.vector_norm(delta - ref) / torch.linalg.vector_norm(ref)) <= 5e-2
    again_state, again = step(card0, on_card)
    assert all(torch.equal(got[k], again[k]) for k in got)
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(leaves(got_state.params), leaves(again_state.params)))


def _to_device(tree, device):
    """A nested dict of tensors moved to ``device``."""
    return {k: _to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()} if tree is not None else None


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


# zamba2-7b's head dim 112: the Hopper kernel on the D = 128 tiles at its
# forward's shape (B=4, S=2048, 32 heads, no GQA) and a ragged GQA shape;
# the mma.sync and fp32 kernels take D = 112 too.
@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,kernel", [
    ((4, 2048, 2048, 32, 32, 0), torch.bfloat16, "wgmma"),
    ((2, 130, 167, 4, 2, 37), torch.bfloat16, "wgmma"),
    ((2, 1, 300, 4, 4, 299), torch.bfloat16, "wgmma"),
    ((2, 130, 167, 4, 2, 37), torch.bfloat16, "mma_sync"),
    ((2, 130, 167, 4, 2, 37), torch.float32, "fp32"),
], ids=str)
def test_kernel_flash_head_dim_112(cuda_flash, shape, dtype, kernel):
    b, sq, sk, hq, hkv, off = shape
    q, k, v = _flash_qkv(cuda_flash, b, sq, sk, hq, hkv, 112, seed=sq + sk, dtype=dtype)
    fa.reset_launches()
    out = fa.launch(q, k, v, off, kernel=kernel) if kernel == "mma_sync" \
        else fa.gqa_flash(q, k, v, causal_offset=off)
    torch.cuda.synchronize()
    assert fa.launches["gqa_flash"] == fa.launches[kernel] == 1, fa.launches
    assert out.shape == q.shape and out.dtype == dtype
    _assert_flash_close(out, fa.gqa_flash_plain(q, k, v, causal_offset=off),
                        f"{shape} {dtype} {kernel}")


# Head dim 16, the tiny trainer of repro_torch.examples.train_carbon_aware
# (d_model 64 over 4 heads, 2 KV heads, bf16): its batch of 4 and a rank's 2
# at S 128, then edge shapes (one row, ragged tails past the 64-row tiles,
# keys no row sees); bf16 on the Hopper kernels' 16-wide tiles (the wgmma
# forward and backward), fp32 on its own tiled kernels, each against the
# plain versions.
D16_SHAPES = [(4, 128, 128, 4, 2, 0), (2, 128, 128, 4, 2, 0), (1, 1, 300, 4, 1, 299),
              (2, 130, 167, 4, 2, 37), (1, 70, 70, 2, 2, 0), (2, 5, 300, 4, 2, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("shape", D16_SHAPES, ids=str)
def test_kernel_flash_head_dim_16(cuda_flash_bwd, shape, dtype):
    b, sq, sk, hq, hkv, off = shape
    q, k, v, do = _bwd_inputs(cuda_flash_bwd, b, sq, sk, hq, hkv, 16, seed=sq + sk,
                              dtype=dtype)
    route = "wgmma" if dtype == torch.bfloat16 else "fp32"
    wg = int(route == "wgmma")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.reset_launches()
    out = fa.gqa_flash(*leaves, causal_offset=off)
    out.backward(do)
    torch.cuda.synchronize()
    assert fa.launches == {"gqa_flash": 1, "wgmma": wg, "mma_sync": 0,
                           "fp32": 1 - wg, "fp32_simple": 0, "gqa_flash_bwd": 1,
                           "bwd_stats": 0, "bwd_dkdv": 0, "bwd_dq": 0,
                           "bwd_wgmma_dq": wg, "bwd_wgmma_dkdv": wg, "bwd_mma_dq": 0,
                           "bwd_mma_dkdv": 0, "bwd_tiled_dq": 1 - wg,
                           "bwd_tiled_dkdv": 1 - wg, "layout_copy": 0}, fa.launches
    assert out.shape == q.shape and out.dtype == dtype
    _assert_flash_close(out.detach(), fa.gqa_flash_plain(q, k, v, causal_offset=off),
                        f"{shape} {dtype}")
    o = out.detach()
    want = fa.gqa_flash_bwd_plain(q, k, v, o, do, causal_offset=off)
    _assert_bwd_close([t.grad for t in leaves], want, f"{shape} {dtype} backward")
    lse = fa.launch(q, k, v, off, with_lse=True)[1]
    again = fa.launch_bwd(q, k, v, o, do, causal_offset=off, lse=lse)
    assert all(torch.equal(t.grad, g) for t, g in zip(leaves, again))   # no atomics


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
    assert fa.launches == {"gqa_flash": 1, "wgmma": 1, "mma_sync": 0, "fp32": 0,
                           "fp32_simple": 0, "gqa_flash_bwd": 0, "bwd_stats": 0,
                           "bwd_dkdv": 0, "bwd_dq": 0, "bwd_wgmma_dq": 0, "bwd_wgmma_dkdv": 0,
                           "bwd_mma_dq": 0, "bwd_mma_dkdv": 0, "bwd_tiled_dq": 0,
                           "bwd_tiled_dkdv": 0, "layout_copy": 0}
    _assert_flash_close(out, fa.gqa_flash_plain(q, k, v, causal_offset=extra),
                        f"Sq={sq} Sk={sq + extra} D={d}")


# The serving path's shapes: the llama3-8b prefill (on the Hopper kernel and
# on the retained mma.sync kernel), a decode-like single row over a long
# cache, and qwen3-moe's prefill (D = 64, 16 query heads a KV head).
@pytest.mark.cuda
@pytest.mark.parametrize("shape,kernel", [
    ((4, 2048, 2048, 32, 8, 128, 0), "wgmma"),
    ((4, 2048, 2048, 32, 8, 128, 0), "mma_sync"),
    ((4, 1, 2112, 32, 8, 128, 2111), "wgmma"),
    ((4, 2048, 2048, 64, 4, 64, 0), "wgmma"),        # qwen3-moe's prefill
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
    """The prefill's shape, D = 64 and the narrow D = 32 and 16 count under
    the Hopper kernel's route; fp32 on its own."""
    cases = [((1, 256, 256, 32, 8, 128), torch.bfloat16, "wgmma"),
             ((1, 256, 256, 8, 2, 64), torch.bfloat16, "wgmma"),
             ((1, 256, 256, 8, 2, 32), torch.bfloat16, "wgmma"),
             ((1, 256, 256, 8, 2, 16), torch.bfloat16, "wgmma"),
             ((1, 256, 256, 8, 2, 16), torch.float32, "fp32"),
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
        x = torch.zeros((1, 4, 2, 257), device=cuda_flash)
        fa.gqa_flash(x, x, x)
    with pytest.raises(TypeError):
        fa.gqa_flash(*(t.int() for t in ok))
    with pytest.raises(TypeError):
        fa.gqa_flash(ok[0].float(), ok[1], ok[2])
    # a stride along D other than 1: copied, counted, not refused
    fa.reset_launches()
    strided = ok[0].transpose(1, 3).contiguous().transpose(1, 3)
    _assert_flash_close(fa.gqa_flash(strided, ok[1], ok[2]),
                        fa.gqa_flash_plain(*ok), "a D stride other than 1")
    assert fa.launches["layout_copy"] == 1 and fa.launches["wgmma"] == 1
    with pytest.raises(ValueError, match="CUDA device"):
        fa.gqa_flash(ok[0], ok[1].cpu(), ok[2])
    with pytest.raises(ValueError, match="causal_offset"):
        fa.gqa_flash(*ok, causal_offset=-1)


# Every float dtype at head dims off the pinned routes: each route's edges
# (D 8 and 24 on the Hopper kernels' 16- and 32-wide tiles; 33, 40 and 72 on
# the Hopper kernel's 64- and 128-wide tiles, 33
# staged; 100 staged; 160 and 256 past the tensor cores' 128) on a ragged
# GQA shape, forward and backward.
DIMS_SHAPES = [(2, 130, 167, 4, 2, 37), (1, 1, 300, 4, 1, 299), (2, 200, 333, 8, 2, 133)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32,
                                   torch.float64], ids=str)
@pytest.mark.parametrize("d", [8, 24, 33, 40, 72, 100, 160, 256])
def test_kernel_flash_every_head_dim(cuda_flash_bwd, d, dtype):
    for b, sq, sk, hq, hkv, off in DIMS_SHAPES:
        q, k, v, do = _bwd_inputs(cuda_flash_bwd, b, sq, sk, hq, hkv, d, seed=sq + d,
                                  dtype=dtype)
        what = f"{(b, sq, sk, hq, hkv, off)} D={d} {dtype}"
        route, broute = fa.route(dtype, d), fa.bwd_route(dtype, d)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fa.reset_launches()
        out = fa.gqa_flash(*leaves, causal_offset=off)
        out.backward(do)
        torch.cuda.synchronize()
        # the Hopper route stages q, k, v (forward) and dO (backward) off a
        # multiple of 8
        staged = 4 if route == "wgmma" and d % 8 else 0
        assert {n: c for n, c in fa.launches.items() if c} == {
            "gqa_flash": 1, route: 1, "gqa_flash_bwd": 1,
            **dict.fromkeys(fa.BWD_ROUTE_KERNELS[broute], 1),
            **({"layout_copy": staged} if staged else {})}, (what, fa.launches)
        assert out.dtype == dtype and out.shape == q.shape
        o = out.detach()
        _assert_flash_close(o, fa.gqa_flash_plain(q, k, v, causal_offset=off), what)
        _assert_bwd_close([t.grad for t in leaves],
                          fa.gqa_flash_bwd_plain(q, k, v, o, do, causal_offset=off),
                          what + " backward")


# The wgmma route past width 128, on tiles 192 and 256 wide: D 136 and 200
# off the tiles' edges (TMA zero-fills the rest), 192 and 256 on them.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("d", [136, 192, 200, 256])
def test_kernel_flash_wgmma_wide(cuda_flash_bwd, d, dtype):
    """Forward, LSE and backward of the wide tiles on ragged GQA shapes with
    causal offsets (keys no row sees; one row over 300 keys): the output bit
    for bit with and without the LSE and within the flash limits; the LSE
    within 1e-4 of ``gqa_flash_lse_plain``; the backward within the limits of
    the fp32 plain backward and BWD_ROUNDED_REL of the plain version that
    rounds where the kernels round; two backward runs equal bit for bit.  At
    D 256 the previous routes still launch on request."""
    for b, sq, sk, hq, hkv, off in DIMS_SHAPES + [(2, 300, 300, 16, 8, 0)]:
        q, k, v, do = _bwd_inputs(cuda_flash_bwd, b, sq, sk, hq, hkv, d, seed=sq + d,
                                  dtype=dtype)
        what = f"{(b, sq, sk, hq, hkv, off)} D={d} {dtype}"
        fa.reset_launches()
        out, lse = fa.launch(q, k, v, off, with_lse=True)
        bare = fa.gqa_flash(q, k, v, causal_offset=off)
        got = fa.gqa_flash_bwd(q, k, v, out, do, causal_offset=off, lse=lse)
        torch.cuda.synchronize()
        assert {n: c for n, c in fa.launches.items() if c} == {
            "gqa_flash": 2, "wgmma": 2, "gqa_flash_bwd": 1, "bwd_wgmma_dq": 1,
            "bwd_wgmma_dkdv": 1}, (what, fa.launches)
        assert torch.equal(out, bare), what
        _assert_flash_close(out, fa.gqa_flash_plain(q, k, v, causal_offset=off), what)
        np.testing.assert_allclose(lse.cpu().numpy(),
                                   fa.gqa_flash_lse_plain(q, k, off).cpu().numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=what)
        _assert_bwd_close(got, fa.gqa_flash_bwd_plain(q, k, v, out, do, causal_offset=off),
                          what)
        _assert_bwd_close(got, fa.gqa_flash_bwd_lse_plain(q, k, v, out, do, lse, off,
                                                          round_bf16=True),
                          what + " rounded", rel_limit=BWD_ROUNDED_REL)
        again = fa.gqa_flash_bwd(q, k, v, out, do, causal_offset=off, lse=lse)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), what   # no atomics
    if d == 256:
        fa.reset_launches()
        _assert_flash_close(fa.launch(q, k, v, off, kernel="mma_sync"),
                            fa.gqa_flash_plain(q, k, v, causal_offset=off), "mma_sync")
        _assert_bwd_close(fa.launch_bwd(q, k, v, out, do, off, route="fma"),
                          fa.gqa_flash_bwd_plain(q, k, v, out, do, causal_offset=off), "fma")
        assert fa.launches["mma_sync"] == 1 and all(fa.launches[n] == 1
                                                    for n in fa.BWD_KERNELS), fa.launches


# The mma backward by name (bf16 and fp16 at D <= 32, the yardstick of the
# narrow wgmma pair, on the forward's LSE): both padded widths, D off a
# multiple of 8 (element loads), the fma cases and keys no row sees, Sq past
# Sk, one key.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("d", [5, 8, 16, 24, 32])
def test_kernel_flash_bwd_mma_matches_plain(cuda_flash_bwd, d, dtype):
    """Against the fp32 plain backward and, within BWD_ROUNDED_REL, the plain
    version that rounds P and dS where the kernels round them; one launch of
    each mma kernel and none of the fma route's; two runs equal bit for bit."""
    cases = [(sq, sq + extra, extra, hq, group) for sq, extra, hq, group in BWD_CASES] + \
        [(5, 300, 3, 4, 2), (200, 65, 0, 4, 2), (3, 1, 7, 2, 1)]
    for sq, sk, off, hq, group in cases:
        q, k, v, do = _bwd_inputs(cuda_flash_bwd, 2, sq, sk, hq, hq // group, d,
                                  seed=sq + sk + d, dtype=dtype)
        o, lse = fa.launch(q, k, v, off, with_lse=True)
        what = str((sq, sk, off, hq, group, d, dtype))
        assert torch.equal(o, fa.gqa_flash(q, k, v, causal_offset=off)), what
        np.testing.assert_allclose(lse.cpu().numpy(),
                                   fa.gqa_flash_lse_plain(q, k, off).cpu().numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=what)
        fa.reset_launches()
        got = fa.launch_bwd(q, k, v, o, do, off, lse=lse, route="mma")
        torch.cuda.synchronize()
        assert {n: c for n, c in fa.launches.items() if c} == {
            "gqa_flash_bwd": 1, "bwd_mma_dq": 1, "bwd_mma_dkdv": 1}, (what, fa.launches)
        _assert_bwd_close(got, fa.gqa_flash_bwd_plain(q, k, v, o, do, causal_offset=off), what)
        _assert_bwd_close(got, fa.gqa_flash_bwd_lse_plain(q, k, v, o, do, lse, off,
                                                          round_bf16=True),
                          what + " rounded", rel_limit=BWD_ROUNDED_REL)
        again = fa.launch_bwd(q, k, v, o, do, off, lse=lse, route="mma")
        assert all(torch.equal(a, b) for a, b in zip(got, again)), what   # no atomics


# The Hopper kernels' narrow tiles (16 and 32 wide) at every 16-bit head dim
# they take, staged off a multiple of 8, on ragged GQA shapes with causal
# offsets.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("d", range(1, 33))
def test_kernel_flash_narrow_matches_plain(cuda_flash_bwd, d, dtype):
    """Forward, LSE and backward on the narrow tiles: the output bit for bit
    with and without the LSE and within the flash limits; the LSE within
    1e-4 of ``gqa_flash_lse_plain``; the backward within the limits of the
    fp32 plain backward and BWD_ROUNDED_REL of the plain version that rounds
    where the kernels round; two runs of each equal bit for bit; only the
    wgmma kernels launched (and the staging copies off a multiple of 8)."""
    for b, sq, sk, hq, hkv, off in DIMS_SHAPES + [(4, 128, 128, 4, 2, 0)]:
        q, k, v, do = _bwd_inputs(cuda_flash_bwd, b, sq, sk, hq, hkv, d, seed=sq + d,
                                  dtype=dtype)
        what = f"{(b, sq, sk, hq, hkv, off)} D={d} {dtype}"
        fa.reset_launches()
        out, lse = fa.launch(q, k, v, off, with_lse=True)
        bare = fa.gqa_flash(q, k, v, causal_offset=off)
        got = fa.gqa_flash_bwd(q, k, v, out, do, causal_offset=off, lse=lse)
        again = fa.gqa_flash_bwd(q, k, v, out, do, causal_offset=off, lse=lse)
        torch.cuda.synchronize()
        staged = {"layout_copy": 14} if d % 8 else {}
        assert {n: c for n, c in fa.launches.items() if c} == {
            "gqa_flash": 2, "wgmma": 2, "gqa_flash_bwd": 2, "bwd_wgmma_dq": 2,
            "bwd_wgmma_dkdv": 2, **staged}, (what, fa.launches)
        assert torch.equal(out, bare), what
        assert torch.equal(out, fa.launch(q, k, v, off, with_lse=True)[0]), what
        _assert_flash_close(out, fa.gqa_flash_plain(q, k, v, causal_offset=off), what)
        np.testing.assert_allclose(lse.cpu().numpy(),
                                   fa.gqa_flash_lse_plain(q, k, off).cpu().numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=what)
        _assert_bwd_close(got, fa.gqa_flash_bwd_plain(q, k, v, out, do, causal_offset=off),
                          what)
        _assert_bwd_close(got, fa.gqa_flash_bwd_lse_plain(q, k, v, out, do, lse, off,
                                                          round_bf16=True),
                          what + " rounded", rel_limit=BWD_ROUNDED_REL)
        assert all(torch.equal(a, c) for a, c in zip(got, again)), what   # no atomics


# The Hopper route off a multiple of 8: each input staged into rows
# ceil(D / 8) * 8 wide (3 copies in the forward, q, k, v and dO in a direct
# backward, dO alone behind the Function), the stores guarded by column.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("d", [33, 100, 250])
def test_kernel_flash_wgmma_staged(cuda_flash_bwd, d, dtype):
    for b, sq, sk, hq, hkv, off in DIMS_SHAPES + [(2, 300, 300, 16, 8, 0)]:
        q, k, v, do = _bwd_inputs(cuda_flash_bwd, b, sq, sk, hq, hkv, d, seed=sq + d,
                                  dtype=dtype)
        what = f"{(b, sq, sk, hq, hkv, off)} D={d} {dtype}"
        fa.reset_launches()
        out, lse = fa.launch(q, k, v, off, with_lse=True)
        bare = fa.gqa_flash(q, k, v, causal_offset=off)
        got = fa.gqa_flash_bwd(q, k, v, out, do, causal_offset=off, lse=lse)
        torch.cuda.synchronize()
        assert {n: c for n, c in fa.launches.items() if c} == {
            "gqa_flash": 2, "wgmma": 2, "gqa_flash_bwd": 1, "bwd_wgmma_dq": 1,
            "bwd_wgmma_dkdv": 1, "layout_copy": 10}, (what, fa.launches)
        assert torch.equal(out, bare), what
        _assert_flash_close(out, fa.gqa_flash_plain(q, k, v, causal_offset=off), what)
        np.testing.assert_allclose(lse.cpu().numpy(),
                                   fa.gqa_flash_lse_plain(q, k, off).cpu().numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=what)
        _assert_bwd_close(got, fa.gqa_flash_bwd_plain(q, k, v, out, do, causal_offset=off),
                          what)
        _assert_bwd_close(got, fa.gqa_flash_bwd_lse_plain(q, k, v, out, do, lse, off,
                                                          round_bf16=True),
                          what + " rounded", rel_limit=BWD_ROUNDED_REL)
        # through the Function: the forward's staged q, k, v are saved, only
        # dO is staged again; the same gradients
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fa.reset_launches()
        o = fa.gqa_flash(*leaves, causal_offset=off)
        o.backward(do)
        torch.cuda.synchronize()
        assert fa.launches["layout_copy"] == 4 and fa.launches["gqa_flash_bwd"] == 1, \
            (what, fa.launches)
        assert torch.equal(o.detach(), out) and all(
            torch.equal(t.grad, g) for t, g in zip(leaves, got)), what
    # the yardsticks at D 250 (the width-256 instantiations)
    if d == 250:
        fa.reset_launches()
        _assert_flash_close(fa.launch(q, k, v, off, kernel="mma_sync"),
                            fa.gqa_flash_plain(q, k, v, causal_offset=off), "mma_sync")
        _assert_bwd_close(fa.launch_bwd(q, k, v, out, do, off, route="fma"),
                          fa.gqa_flash_bwd_plain(q, k, v, out, do, causal_offset=off), "fma")
        assert fa.launches["mma_sync"] == 1 and fa.launches["layout_copy"] == 0 and all(
            fa.launches[n] == 1 for n in fa.BWD_KERNELS), fa.launches


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(96, torch.bfloat16), (40, torch.float16),
                                     (33, torch.bfloat16), (100, torch.float32)], ids=str)
def test_kernel_flash_layout_copies(cuda_flash, d, dtype):
    """Views the route cannot read are copied and counted, not refused: a
    D stride other than 1, and for the Hopper kernel a head stride off 16
    bytes; a view it reads is not copied."""
    base = torch.from_numpy(np.random.default_rng(d).normal(size=(2, 70, 3, 4, d + 1))
                            .astype(np.float32)).to(cuda_flash, dtype)
    q, k, v = base[:, :, 0, :, :d], base[:, :, 1, :2, :d], base[:, :, 2, 2:, :d]
    want = fa.gqa_flash_plain(q, k, v, causal_offset=5)
    fa.reset_launches()
    _assert_flash_close(fa.gqa_flash(q, k, v, causal_offset=5), want, "odd strides")
    copies = 3 if fa.route(dtype, d) == "wgmma" else 0    # rows (d + 1) elements apart
    assert fa.launches["layout_copy"] == copies, fa.launches
    flipped = [t.transpose(1, 3).contiguous().transpose(1, 3) for t in (q, k, v)]
    fa.reset_launches()
    _assert_flash_close(fa.gqa_flash(*flipped, causal_offset=5), want, "D stride")
    assert fa.launches["layout_copy"] == 3 and fa.launches["gqa_flash"] == 1


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


# --- the variable-k capacity fill and the sweeps on the card -----------------


@pytest.fixture
def cuda_fill():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fill.build()
    return torch.device("cuda")


def _fill_inputs(seed, b, n, dev, p_cand=None, p_forced=None, k_hi=8):
    g = np.random.default_rng(seed)
    cand = g.random((b, n)) < (g.random() if p_cand is None else p_cand)
    forced = g.random((b, n)) < (g.random() if p_forced is None else p_forced)
    kreq = g.integers(1, k_hi + 1, (b, n))
    m_cap = g.integers(0, max(2, int(kreq.sum(1).max() * g.random())) + 1, b)
    return [torch.from_numpy(x).to(dev) for x in (cand, forced, kreq, m_cap)]


def _fill_check(args, route=None):
    """The kernel of ``route`` (the default when None) against the plain
    version; one launch, counted in all and on its route alone."""
    want = fill.capacity_fill_plain(*(x.cpu() for x in args))
    before = dict(fill.launches)
    got = fill.capacity_fill(*args, route=route)
    torch.cuda.synchronize()
    counted = route or "compact"
    assert fill.launches == {k: v + (k in ("capacity_fill", counted)) for k, v in before.items()}
    assert got.dtype == torch.bool and got.is_cuda
    assert torch.equal(got.cpu(), want)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("route", [None, "chunked"], ids=["compact", "chunked"])
@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("n", [256, 2048, 6144])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_fill_matches_plain(cuda_fill, b, n, seed, route):
    _fill_check(_fill_inputs(seed, b, n, cuda_fill), route)


@pytest.mark.cuda
def test_kernel_fill_smem_matches_the_plan(cuda_fill):
    for route in fill.ROUTES:
        for n in (1, 33, 1792, 6144):
            assert fill._lib.capacity_fill_smem(fill.ROUTES.index(route), n) == \
                fill.plan(1, n, route)["smem_bytes"]


@pytest.mark.cuda
@pytest.mark.parametrize("route", [None, "chunked"], ids=["compact", "chunked"])
@pytest.mark.parametrize("case", ["capacity 0", "everything fits", "nothing fits",
                                  "all forced", "one row", "sparse candidates",
                                  "requests of 0", "odd width", "one small request"])
def test_kernel_fill_edge_cases(cuda_fill, case, route):
    b, n = 64, 2048
    cand, forced, kreq, m_cap = _fill_inputs(9, b, n, cuda_fill, 0.5, 0.2)
    if case == "capacity 0":
        m_cap.zero_()
    elif case == "everything fits":
        m_cap.fill_(int(kreq.sum(1).max()))
    elif case == "nothing fits":
        kreq.fill_(1000)
        m_cap.clamp_(max=999)
    elif case == "all forced":
        forced.fill_(True)
    elif case == "one row":
        cand, forced, kreq = (x[:, :1].contiguous() for x in (cand, forced, kreq))
        cand.fill_(True)
    elif case == "sparse candidates":
        cand &= torch.rand(cand.shape, device=cuda_fill) < 0.01
    elif case == "requests of 0":
        kreq[:, ::3] = 0
    elif case == "odd width":
        cand, forced, kreq = (x[:, :1999].contiguous() for x in (cand, forced, kreq))
    elif case == "one small request":
        # the last unforced candidate is the only one that fits: the walk
        # must not stop on the forced rows' larger requests
        kreq.fill_(50)
        m_cap.fill_(49)
        cand[:, -1], forced[:, -1], kreq[:, -1] = True, False, 1
    take = _fill_check([cand, forced, kreq, m_cap], route)
    if case == "everything fits":
        assert torch.equal(take, cand.cpu())
    if case in ("capacity 0", "nothing fits"):
        assert not take.any()
    if case == "one small request":
        assert int(take.sum()) == b and take[:, -1].all()


@pytest.mark.cuda
def test_kernel_fill_checks(cuda_fill):
    cand, forced, kreq, m_cap = _fill_inputs(1, 4, 64, cuda_fill)
    with pytest.raises(TypeError):
        fill.capacity_fill(cand, forced, kreq.int(), m_cap)
    with pytest.raises(ValueError):
        fill.capacity_fill(cand, forced, kreq, m_cap[:2])
    with pytest.raises(ValueError):
        fill.capacity_fill(cand, forced, kreq.cpu(), m_cap)
    with pytest.raises(ValueError):
        fill.capacity_fill(cand[:, ::2], forced[:, ::2], kreq[:, ::2], m_cap)
    with pytest.raises(ValueError, match="route"):
        fill.capacity_fill(cand, forced, kreq, m_cap, route="other")


def _golden_sweep(name, device, engine):
    """The golden DAG or MPC grid, its oracle passes on the greedy kernel."""
    from repro_torch.core.mpc import MPCConfig
    from repro_torch.experiment import Sweep
    from repro_torch.traces import DagConfig

    base = dict(capacity=8, learn_weeks=1, family="alibaba", seed=101, engine=engine)
    if name == "golden_sweep_dag":
        return Sweep(base=Scenario(dag=DagConfig(width=3, depth=3), **base),
                     seeds=[11, 12], policies=["dag-fcfs", "dag-carbon", "dag-cap"],
                     device=device, backend="device")
    return Sweep(base=Scenario(mpc=MPCConfig(scale_rho=0.3), **base), seeds=[11, 12],
                 policies=["carbon-agnostic", "carbonflex-mpc", "carbonflex-scale",
                           "oracle-estimated"], device=device, backend="device")


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["vector", "scan"])
@pytest.mark.parametrize("name", ["golden_sweep_dag", "golden_sweep_mpc"])
def test_golden_sweeps_on_the_card(cuda_fill, name, engine):
    import os

    from repro_torch.core import scan_engine

    gating.build()
    oracle_greedy.build()
    path = os.path.join(os.path.dirname(__file__), "data", f"{name}.json")
    with open(path) as f:
        want = f.read()
    scan_engine.reset_stats()
    gating.reset_launches()
    fill.reset_launches()
    got = _golden_sweep(name, "cuda", engine).run().to_json() + "\n"
    assert got == want
    if engine == "scan":
        stats = scan_engine.stats
        if name == "golden_sweep_dag":
            assert gating.launches["dep_release"] == stats["dag_steps"] > 0
            assert stats["delegated"] == 0
        else:
            assert fill.launches["capacity_fill"] == stats["fill_steps"] > 0
            assert fill.launches["compact"] == stats["fill_steps"]
            assert fill.launches["chunked"] == 0
            assert stats["delegated"] == 2


# --- the geo slot loop's placement and capacity walk -------------------------


@pytest.fixture
def cuda_geo():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    geo_walk.build()
    return torch.device("cuda")


def _geo_inputs(seed, kind, b, n, regions, dev, mixed=False, nothing_fits=False,
                lookahead=24, mig_vals=3):
    """Random inputs of ``geo_resolve`` on ``dev``: candidates, forced,
    started, placed and migrating rows, CI values and means with ties."""
    g = np.random.default_rng(seed)
    bn = (b, n)
    kmin = g.choice([1, 2, 4], bn) if mixed else np.ones(bn, dtype=np.int64)
    if nothing_fits:
        kmin = np.full(bn, 4)
    state = dict(
        remaining=np.where(g.random(bn) < 0.3, g.integers(1, 40, bn).astype(float),
                           g.uniform(0.01, 40.0, bn)),
        slack=g.integers(-3, 30, bn), started=g.random(bn) < 0.5,
        placed=g.random(bn) < 0.4, pol_region=g.integers(0, regions, bn),
        eng_region=g.integers(0, regions, bn), mig_left=g.integers(0, 2, bn),
        moves=g.integers(0, 2, bn))
    consts = dict(kmin=kmin, ec=kmin * g.choice([1.0, 0.3, 2.5], bn),
                  mig_e=0.05 * np.maximum(1.0, g.uniform(0, 8, bn)),
                  mig_slots=g.integers(1, 4, bn), mig_idx=g.integers(0, mig_vals, bn),
                  caps=(np.ones((b, regions), dtype=np.int64) if nothing_fits
                        else g.integers(1, max(2, n // 4), (b, regions))),
                  margin_c=np.full(b, 0.75), max_moves=g.integers(1, 3, b))
    ci = np.round(g.uniform(10, 700, (b, regions)), -1)
    tables = dict(ci_now=ci, clean_order=np.argsort(ci, axis=1, kind="stable"),
                  thresh_eps=g.uniform(10, 700, (b, regions)) + 1e-9,
                  means=np.round(g.uniform(10, 700, (b, regions, lookahead)), -1),
                  movemeans=g.uniform(10, 700, (b, mig_vals, regions, lookahead)))

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return (t(g.random(bn) < 0.6), t(g.random(bn) < 0.3),
            {k: t(v) for k, v in state.items()}, {k: t(v) for k, v in consts.items()},
            {k: t(v) for k, v in tables.items() if k in geo_walk._TABLES[kind]})


def _geo_check(kind, args, route=None):
    """The kernel of ``route`` (the default when None) against the plain
    walk on every output; one launch, counted in all and on its route."""
    cpu = [{k: v.cpu() for k, v in a.items()} if isinstance(a, dict) else a.cpu()
           for a in args]
    want = geo_walk.geo_resolve_plain(kind, *cpu)
    before = dict(geo_walk.launches)
    got = geo_walk.geo_resolve(kind, *args, route=route)
    torch.cuda.synchronize()
    counted = route or "compact"
    assert geo_walk.launches == {k: v + (k in ("geo_walk", counted))
                                 for k, v in before.items()}
    for name, a, w in zip(("take", "placed", "pol_region", "eng_region", "mig_left",
                           "moves", "mig_now"), got, want):
        assert a.is_cuda and a.dtype == w.dtype, name
        assert torch.equal(a.cpu(), w), name
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("route", [None, "chunked"], ids=["compact", "chunked"])
@pytest.mark.parametrize("kind", geo_walk.KINDS)
@pytest.mark.parametrize("regions", [2, 3, 10, 16])
@pytest.mark.parametrize("mixed", [False, True], ids=["uniform-k", "mixed-k"])
def test_kernel_geo_walk_matches_plain(cuda_geo, kind, regions, mixed, route):
    for seed in range(3):
        want = _geo_check(kind, _geo_inputs(seed, kind, 4, 300, regions, cuda_geo, mixed),
                          route)
        assert want[0].any()
        if kind != "geo-static":
            assert want[6].any()                # some rows migrate


@pytest.mark.cuda
def test_kernel_geo_walk_smem_matches_the_plan(cuda_geo):
    for route in geo_walk.ROUTES:
        for n in (1, 33, 1792, 6144):
            assert geo_walk._lib.geo_walk_smem(geo_walk.ROUTES.index(route), n) == \
                geo_walk.plan(1, n, 2, route)["smem_bytes"]


@pytest.mark.cuda
@pytest.mark.parametrize("route", [None, "chunked"], ids=["compact", "chunked"])
@pytest.mark.parametrize("kind", geo_walk.KINDS)
@pytest.mark.parametrize("case", ["nothing fits", "all forced", "one row", "odd width",
                                  "B=64 n_pad=1792", "n_pad=6144 (opt-in)"])
def test_kernel_geo_walk_edge_cases(cuda_geo, kind, case, route):
    b, n, kw = 3, 256, {}
    if case == "nothing fits":
        kw["nothing_fits"] = True
    elif case == "one row":
        n = 1
    elif case == "odd width":
        n = 333
    elif case == "B=64 n_pad=1792":
        b, n = 64, 1792
    elif case == "n_pad=6144 (opt-in)":
        b, n = 2, 6144
    args = _geo_inputs(11, kind, b, n, 4, cuda_geo, mixed=True, **kw)
    if case == "all forced":
        args[1].fill_(True)
    want = _geo_check(kind, args, route)
    if case == "nothing fits":
        assert not want[0].any()


@pytest.mark.cuda
def test_kernel_geo_walk_checks(cuda_geo):
    cand, forced, state, consts, tables = _geo_inputs(1, "geo-flex", 2, 64, 3, cuda_geo)
    with pytest.raises(TypeError):
        geo_walk.geo_resolve("geo-flex", cand, forced, dict(state, slack=state["slack"].int()),
                             consts, tables)
    with pytest.raises(ValueError):
        geo_walk.geo_resolve("geo-flex", cand[:, :10], forced, state, consts, tables)
    with pytest.raises(ValueError):
        geo_walk.geo_resolve("geo-flex", cand, forced, state, consts,
                             dict(tables, means=tables["means"].transpose(1, 2)))
    with pytest.raises(ValueError):
        geo_walk.geo_resolve("geo-flex", cand, forced.cpu(), state, consts, tables)
    with pytest.raises(ValueError, match="route"):
        geo_walk.geo_resolve("geo-flex", cand, forced, state, consts, tables, route="other")


@pytest.mark.cuda
def test_geo_flex_week_on_the_card_equals_the_cpu(cuda_geo):
    from repro_torch.core import scan_engine
    from repro_torch.core.carbon import MultiRegionCarbonService
    from repro_torch.core.geo import GeoFlexPolicy
    from repro_torch.core.simulator import simulate
    from repro_torch.core.types import GeoCluster
    from repro_torch.traces import TraceSpec, generate_trace

    regions = ("south-australia", "california", "ontario")
    geo = GeoCluster.split(20, regions)
    mci = MultiRegionCarbonService.synthetic(regions, 24 * 7 * 2 + 24 * 30, seed=21)
    jobs = generate_trace(TraceSpec(family="azure", hours=24 * 7, capacity=20, seed=22),
                          geo.queues)
    scan_engine.reset_stats()
    geo_walk.reset_launches()
    got = simulate(jobs, mci, geo, GeoFlexPolicy(), horizon=24 * 7, engine="scan",
                   device="cuda")
    want = simulate(jobs, mci, geo, GeoFlexPolicy(), horizon=24 * 7)
    assert got.to_dict(include_per_job=True, include_slots=True) == \
        want.to_dict(include_per_job=True, include_slots=True)
    assert got.migrations > 0
    assert geo_walk.launches["geo_walk"] == scan_engine.stats["geo_steps"] > 0
    assert geo_walk.launches["compact"] == geo_walk.launches["geo_walk"]
    assert geo_walk.launches["chunked"] == 0


# --- resilience: faulted and outage worlds on the card -------------------------


def _resilience_world(kind):
    """A capacity-20 week with a carbon-feed outage: single-region, DAG or
    geo (cluster, ci, jobs)."""
    from repro_torch.core.carbon import CarbonService, MultiRegionCarbonService
    from repro_torch.core.faults import CarbonDataOutage
    from repro_torch.core.types import ClusterConfig, GeoCluster
    from repro_torch.traces import DagConfig, TraceSpec, generate_dag_trace, generate_trace

    outage = CarbonDataOutage(rate=0.08, mean_duration=6.0, seed=2)
    hours = WEEK * 2 + 24 * 30
    spec = TraceSpec(family="azure", hours=WEEK, capacity=20, seed=32)
    if kind == "geo":
        regions = ("south-australia", "california")
        geo = GeoCluster.split(20, regions)
        mci = MultiRegionCarbonService.synthetic(regions, hours, seed=31, outage=outage)
        return geo, mci, generate_trace(spec, geo.queues)
    cluster = ClusterConfig.default(capacity=20)
    ci = CarbonService.synthetic("south-australia", hours, seed=31, outage=outage)
    if kind == "dag":
        return cluster, ci, generate_dag_trace(spec, DagConfig(), cluster.queues)
    return cluster, ci, generate_trace(spec, cluster.queues)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,policy", [("single", "WaitAwhilePolicy"),
                                         ("dag", "DagCarbonPolicy"),
                                         ("geo", "GeoFlexPolicy")])
def test_outage_world_on_the_card_equals_the_cpu(cuda_geo, kind, policy):
    """An outage cell runs natively on the card's slot loop (its tables from
    the degraded view) and equals the port's CPU vector engine, resilience
    included."""
    from repro_torch.core import baselines, dag, geo, scan_engine
    from repro_torch.core.simulator import simulate

    gating.build()
    cls = {"WaitAwhilePolicy": baselines.WaitAwhilePolicy,
           "DagCarbonPolicy": dag.DagCarbonPolicy, "GeoFlexPolicy": geo.GeoFlexPolicy}[policy]
    cluster, ci, jobs = _resilience_world(kind)
    scan_engine.reset_stats()
    gating.reset_launches()
    geo_walk.reset_launches()
    got = simulate(jobs, ci, cluster, cls(), horizon=WEEK, engine="scan", device="cuda")
    stats = dict(scan_engine.stats)
    want = simulate(jobs, ci, cluster, cls(), horizon=WEEK, device="cpu")
    assert got.to_dict(include_per_job=True, include_slots=True) == \
        want.to_dict(include_per_job=True, include_slots=True)
    assert got.resilience.degraded_slots > 0
    assert stats["delegated"] == stats["fault_delegated"] == 0 and stats["steps"] > 0
    if kind == "dag":
        assert gating.launches["dep_release"] == stats["dag_steps"] > 0
    if kind == "geo":
        assert geo_walk.launches["geo_walk"] == stats["geo_steps"] > 0


@pytest.mark.cuda
def test_faulted_world_on_the_card_equals_the_cpu(cuda_geo):
    """A faulted cell asked of the card's scan engine runs on the vector
    engine (counted apart) and equals the CPU's, resilience included."""
    from repro_torch.core import baselines, scan_engine
    from repro_torch.core.faults import CorrelatedFaults, PreemptionFaults
    from repro_torch.core.simulator import simulate

    cluster, ci, jobs = _resilience_world("single")
    for fm in (CorrelatedFaults(rate=0.06, seed=3), PreemptionFaults(rate=0.06, seed=3)):
        scan_engine.reset_stats()
        got = simulate(jobs, ci, cluster, baselines.WaitAwhilePolicy(), horizon=WEEK,
                       faults=fm, engine="scan", device="cuda")
        assert scan_engine.stats["fault_delegated"] == 1
        assert scan_engine.stats["steps"] == 0
        want = simulate(jobs, ci, cluster, baselines.WaitAwhilePolicy(), horizon=WEEK,
                        faults=fm, device="cpu")
        assert got.to_dict(include_per_job=True, include_slots=True) == \
            want.to_dict(include_per_job=True, include_slots=True)


# --- telemetry: the card's slot loop decodes its events from its grids --------


@pytest.mark.cuda
@pytest.mark.parametrize("kind,policy", [("single", "WaitAwhilePolicy"),
                                         ("dag", "DagCarbonPolicy"),
                                         ("geo", "GeoFlexPolicy")])
def test_scan_stream_on_the_card_equals_the_cpu(cuda_geo, kind, policy):
    """The card's scan engine with a recorder: the events decoded from the
    copied grids equal the CPU vector engine's tracker, tuple for tuple, on
    an outage world (forecast reads, releases, migrations), and the result
    equals the run without a recorder."""
    from repro_torch.core import baselines, dag, geo, scan_engine
    from repro_torch.core.simulator import simulate
    from repro_torch.telemetry import MemoryRecorder, PhaseProfiler, Telemetry

    gating.build()
    cls = {"WaitAwhilePolicy": baselines.WaitAwhilePolicy,
           "DagCarbonPolicy": dag.DagCarbonPolicy, "GeoFlexPolicy": geo.GeoFlexPolicy}[policy]
    cluster, ci, jobs = _resilience_world(kind)
    tel = Telemetry(recorder=MemoryRecorder(), profiler=PhaseProfiler(), run_label="c")
    scan_engine.reset_stats()
    got = simulate(jobs, ci, cluster, cls(), horizon=WEEK, engine="scan",
                   telemetry=tel, device="cuda")
    assert scan_engine.stats["steps"] > 0 and scan_engine.stats["delegated"] == 0
    plain = simulate(jobs, ci, cluster, cls(), horizon=WEEK, engine="scan", device="cuda")
    cpu_tel = Telemetry(recorder=MemoryRecorder(), run_label="c")
    want = simulate(jobs, ci, cluster, cls(), horizon=WEEK, telemetry=cpu_tel,
                    device="cpu")
    assert tel.recorder.events == cpu_tel.recorder.events
    assert got.to_dict(include_per_job=True, include_slots=True) == \
        plain.to_dict(include_per_job=True, include_slots=True) == \
        want.to_dict(include_per_job=True, include_slots=True)
    kinds = set(tel.recorder.counts())
    assert {"admit", "forecast-read", "suspend"} <= kinds
    if kind == "geo":
        assert "migrate" in kinds
    assert set(tel.profiler.seconds) == {"decide", "execute"}


@pytest.mark.cuda
def test_profiler_sync_waits_on_a_cuda_tensor():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.telemetry import PhaseProfiler

    a = torch.randn(2048, 2048, device="cuda")
    prof = PhaseProfiler()
    for _ in range(2):
        with prof.phase("decide", sync={"out": [a, np.zeros(1)]}):
            b = a
            for _ in range(50):
                b = b @ a
            done = torch.cuda.Event()
            done.record()
        assert done.query()             # the bracket waited for the queued work
    b = a
    for _ in range(50):
        b = b @ a
    done = torch.cuda.Event()
    done.record()
    PhaseProfiler.sync([b, None])
    assert done.query()
    assert prof.calls == {"decide": 2} and prof.seconds["decide"] > 0


# --- the MoE block on the card -------------------------------------------------

def _moe_cfg(**kw):
    """Reduced qwen3-moe in bf16 with 16 experts, top 4."""
    import dataclasses

    from repro_torch import configs

    return dataclasses.replace(
        configs.reduced(configs.ARCHS["qwen3-moe-235b-a22b"]), num_experts=16,
        experts_per_token=4, compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16,
        **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("planted", ["none", "two-equal-columns", "all-equal-columns"])
def test_moe_dispatch_on_card_equals_cpu(cuda_flash, planted):
    """Every dispatch of a bf16 MoE forward on the card (top-k ids, sort
    order, slots, kept pairs, source tokens) equals the plain dispatch on the
    CPU on the card's own router probabilities, bit for bit, with capacity
    drops (factor 1.25) and planted ties (equal router columns)."""
    from repro_torch.models import api, transformer

    cfg = _moe_cfg()
    params = api.init_params(cfg, seed=0, device="cpu")
    router = params["layers"]["router"]
    if planted == "two-equal-columns":
        router[..., 3] = router[..., 2]
    elif planted == "all-equal-columns":
        router[...] = router[..., :1]
    params = {k: ({n: t.to(cuda_flash) for n, t in v.items()} if isinstance(v, dict)
                  else v.to(cuda_flash)) for k, v in params.items()}
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 64))).to(cuda_flash)
    routes = []
    route = transformer.moe_route

    def capture(probs, k, cap):
        r = route(probs, k, cap)
        routes.append((probs.cpu(), k, cap, transformer.Routing(*(x.cpu() for x in r))))
        return r

    transformer.moe_route = capture
    try:
        logits = api.forward(params, tokens, cfg)
    finally:
        transformer.moe_route = route
    assert torch.isfinite(logits.float()).all()
    assert len(routes) == cfg.num_layers
    dropped = ties = 0
    for probs, k, cap, r in routes:
        assert cap == transformer.capacity(cfg, 4 * 64) == 80
        want = route(probs, k, cap)
        for name in ("eidx", "order", "slot", "keep", "src_tok"):
            assert torch.equal(getattr(r, name), getattr(want, name)), name
        dropped += int((~r.keep).sum())
        top = probs.sort(dim=-1, descending=True).values
        ties += int((top[:, k - 1] == top[:, k]).sum())
    if planted == "none":
        return
    assert ties > 0
    if planted == "all-equal-columns":
        assert dropped == cfg.num_layers * 4 * (256 - 80)      # experts 0-3 overflow
        assert all(torch.equal(r.eidx, torch.arange(4).expand(256, 4))
                   for _, _, _, r in routes)


@pytest.mark.cuda
def test_moe_serve_on_card_is_deterministic(cuda_flash):
    """Reduced qwen3-moe in bf16 served twice on the card: the same prefill
    logits bit for bit and the same greedy tokens (the combine adds each
    token's experts in a fixed order, without atomics)."""
    from repro_torch.models import api
    from repro_torch.serve import greedy_generate

    cfg = _moe_cfg()
    params = api.init_params(cfg, seed=0, device="cuda")
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 64))).to(cuda_flash)
    a = greedy_generate(params, prompts, cfg, 16)
    b = greedy_generate(params, prompts, cfg, 16)
    assert torch.equal(a["prefill_logits"], b["prefill_logits"])
    assert torch.equal(a["tokens"], b["tokens"])
    assert a["prefill_flash_launches"] == cfg.num_layers and a["decode_flash_launches"] == 0


@pytest.mark.cuda
def test_moe_block_on_card_close_to_fp32(cuda_flash):
    """One bf16 MoE block on the card within 1e-2 relative L2 of the fp32
    evaluation of the same routing."""
    from repro_torch.models import api, transformer

    cfg = _moe_cfg()
    params = api.init_params(cfg, seed=2, device="cuda")
    lp = params["layers"]
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(4, 64, cfg.d_model))
                         .astype(np.float32)).to(cuda_flash, torch.bfloat16)
    y = transformer.moe_block(x, lp, 1, cfg)
    xt = x.reshape(-1, cfg.d_model)
    probs = torch.softmax((xt @ lp["router"][1]).float(), dim=-1)
    cap = transformer.capacity(cfg, xt.shape[0])
    r = transformer.moe_route(probs, cfg.experts_per_token, cap)
    buf = xt.float().new_zeros((cfg.num_experts * cap + 1, cfg.d_model))
    buf[r.slot] = xt.float()[r.src_tok] * r.keep[:, None].float()
    yb = transformer.moe_experts(buf[:-1].view(cfg.num_experts, cap, -1),
                                 lp["w_gate"][1].float(), lp["w_up"][1].float(),
                                 lp["w_down"][1].float())
    want = transformer.moe_combine(yb, r).view_as(y)
    rel = (torch.linalg.vector_norm(y.float() - want)
           / torch.linalg.vector_norm(want)).item()
    assert rel <= 1e-2, rel


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [False, True], ids=["mpc", "scale"])
def test_tune_on_card_equals_cpu_vector(scale):
    """The knob tuner's quick grid on the card's scan engine equals the
    port's vector engine on the CPU, gap for gap."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import contextlib
    import dataclasses
    import io

    from repro_torch.experiment import tune_policy

    policy = "carbonflex-scale" if scale else "carbonflex-mpc"
    kw = dict(grid=tune_policy.quick_grid(), seed=1, scale=scale, capacity=20,
              learn_weeks=1)
    simulate = tune_policy.simulate_many
    outs = []
    for device, engine in (("cuda", "scan"), ("cpu", "vector")):
        buf = io.StringIO()
        tune_policy.simulate_many = lambda cases: simulate(
            [dataclasses.replace(c, engine=engine) for c in cases])
        try:
            with contextlib.redirect_stdout(buf):
                outs.append((tune_policy.tune(policy, device=device, **kw), buf.getvalue()))
        finally:
            tune_policy.simulate_many = simulate
    assert outs[0] == outs[1]


# --- rwkv6 and zamba2 on the card ------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-7b"])
def test_reduced_ssm_families_served_on_card_equal_cpu(cuda_flash, arch):
    """The reduced config (fp32) served on the card and on the CPU from the
    same weights: prefill (the replay through the decode step) and greedy
    decode give logits within 1e-3 and the same tokens; the forward's
    logits too, zamba2's attention through the fp32 flash kernel."""
    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.serve import greedy_generate

    cfg = configs.reduced(configs.ARCHS[arch])
    params = api.init_params(cfg, seed=0, device="cpu")
    card = {k: ({n: t.to(cuda_flash) for n, t in v.items()} if isinstance(v, dict)
                else v.to(cuda_flash)) for k, v in params.items()}
    prompts = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24)))
    fa.reset_launches()
    got = api.forward(card, prompts.to(cuda_flash), cfg)
    torch.cuda.synchronize()
    groups = cfg.num_layers // cfg.shared_attn_every if arch == "zamba2-7b" else 0
    assert fa.launches["gqa_flash"] == fa.launches["fp32"] == groups
    want = api.forward(params, prompts, cfg)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-3, atol=1e-3)
    a = greedy_generate(card, prompts.to(cuda_flash), cfg, 8)
    b = greedy_generate(params, prompts, cfg, 8)
    assert a["prefill_flash_launches"] == a["decode_flash_launches"] == 0
    assert torch.equal(a["tokens"].cpu(), b["tokens"])
    for name in ("prefill_logits", "last_logits"):
        np.testing.assert_allclose(a[name].cpu().numpy(), b[name].numpy(),
                                   rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_row_parallel_product_keeps_fp32_sums_on_card(cuda):
    """The tensor-parallel layer's row-parallel product on 16-bit inputs:
    the fp32 sums of the bf16 products (cuBLAS's ``out_dtype``), against the
    product of the inputs cast to fp32; its gradients are the bf16
    products a bf16 ``a @ b`` would give."""
    from repro_torch.models.transformer import _MatmulF32

    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    a = torch.randn(256, 512, generator=gen, device=cuda).bfloat16().requires_grad_()
    b = torch.randn(512, 384, generator=gen, device=cuda).bfloat16().requires_grad_()
    y = _MatmulF32.apply(a, b)
    assert y.dtype == torch.float32
    want = a.detach().float() @ b.detach().float()
    np.testing.assert_allclose(y.detach().cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-4)
    g = torch.randn(256, 384, generator=gen, device=cuda)
    ga, gb = torch.autograd.grad(y, (a, b), g)
    gbf = g.bfloat16()
    assert torch.equal(ga, gbf @ b.detach().T) and torch.equal(gb, a.detach().T @ gbf)
