"""The KNN lookup of the PyTorch port against the JAX package.

On the CPU the dispatch runs the plain versions.  In float32 they are held
against the Pallas kernels (interpret mode) and the pure-jnp reference at
``tests/test_kernels.py``'s tolerance (rtol/atol 1e-5), indices equal up
to ties.  The knowledge base on the CPU computes in float64 and must give
the reference numpy backend's neighbours, with distances within rtol
1e-12 (the row sums and matrix products may add in another order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.knowledge import KnowledgeBase as RefKB
from repro.core.policy import learn_window as ref_learn_window
from repro.experiment import Scenario as RefScenario
from repro.kernels import knn as ref_knn
from repro.kernels import ref as ref_ref
from repro_torch.core.knowledge import KnowledgeBase
from repro_torch.kernels import knn

WEEK = 24 * 7


def _inputs(n, d, q=None, seed=0):
    rng = np.random.default_rng(seed)
    cases = rng.normal(size=(n, d)).astype(np.float32)
    if q is None:
        return cases, rng.normal(size=(d,)).astype(np.float32)
    return cases, rng.normal(size=(q, d)).astype(np.float32)


def _assert_topk_close(dist, idx, dist_ref, idx_ref, cases, queries,
                       rtol=1e-5, atol=1e-5):
    """Distances close; indices equal except where the two neighbours are
    tied (their exact float64 distances agree to the tolerance)."""
    dist, dist_ref = np.asarray(dist), np.asarray(dist_ref)
    idx, idx_ref = np.asarray(idx), np.asarray(idx_ref)
    np.testing.assert_allclose(dist, dist_ref, rtol=rtol, atol=atol)
    q64 = np.atleast_2d(queries).astype(np.float64)
    c64 = cases.astype(np.float64)
    for row in zip(*np.nonzero(np.atleast_2d(idx) != np.atleast_2d(idx_ref))):
        qi = q64[row[0]] if q64.shape[0] > 1 else q64[0]
        a = np.sqrt(np.sum((c64[np.atleast_2d(idx)[row]] - qi) ** 2))
        b = np.sqrt(np.sum((c64[np.atleast_2d(idx_ref)[row]] - qi) ** 2))
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


@pytest.mark.parametrize("n,d", [(1, 13), (255, 13), (257, 13), (700, 11),
                                 (1344, 13)])
def test_plain_topk_matches_pallas_and_ref(n, d):
    cases, q = _inputs(n, d, seed=n)
    k = min(5, n)
    dist, idx = knn.knn_topk(torch.from_numpy(cases), torch.from_numpy(q), k)
    assert dist.dtype == torch.float32 and idx.dtype == torch.int64
    dp, ip = ref_knn.knn_topk(jnp.asarray(cases), jnp.asarray(q), k,
                              interpret=True)
    dr, ir = ref_ref.knn_topk_ref(jnp.asarray(cases), jnp.asarray(q), k)
    _assert_topk_close(dist, idx, dp, ip, cases, q)
    _assert_topk_close(dist, idx, dr, ir, cases, q)


@pytest.mark.parametrize("q,n,d", [(1, 40, 13), (7, 300, 13), (130, 257, 11)])
def test_plain_topk_batch_matches_pallas(q, n, d):
    cases, qs = _inputs(n, d, q=q, seed=q + n)
    dist, idx = knn.knn_topk_batch(torch.from_numpy(cases),
                                   torch.from_numpy(qs), 5)
    assert dist.shape == idx.shape == (q, 5)
    dp, ip = ref_knn.knn_topk_batch(jnp.asarray(cases), jnp.asarray(qs), 5,
                                    interpret=True)
    _assert_topk_close(dist, idx, dp, ip, cases, qs)
    # and the single-query form, row by row
    for i in range(0, q, max(1, q // 5)):
        d1, i1 = knn.knn_topk(torch.from_numpy(cases),
                              torch.from_numpy(qs[i]), 5)
        _assert_topk_close(dist[i], idx[i], d1, i1, cases, qs[i])


def test_plain_ties_go_to_lower_index():
    cases = np.zeros((10, 4), np.float32)
    cases[[2, 5, 7]] = 1.0                  # three rows at equal distance
    q = np.ones(4, np.float32)
    dist, idx = knn.knn_topk(torch.from_numpy(cases), torch.from_numpy(q), 4)
    assert idx.tolist()[:3] == [2, 5, 7]
    np.testing.assert_array_equal(dist.numpy()[:3], 0.0)
    _, bidx = knn.knn_topk_batch(torch.from_numpy(cases),
                                 torch.from_numpy(q[None]), 3)
    assert bidx.tolist() == [[2, 5, 7]]


def test_plain_clamps_before_selecting():
    """A round-off negative ties with an exact zero, so the lower index wins
    (the reference numpy backend clamps, then selects)."""
    d2 = torch.tensor([[0.0, -1e-16, 3.0, -2e-16]], dtype=torch.float64)
    dist, idx = knn._topk_ascending(d2, 3)
    assert idx.tolist() == [[0, 1, 3]]
    assert dist.tolist() == [[0.0, 0.0, 0.0]]


def test_cpu_dispatch_launches_no_kernel():
    knn.reset_launches()
    cases, q = _inputs(50, 13)
    knn.knn_topk(torch.from_numpy(cases).double(),
                 torch.from_numpy(q).double(), 5)
    knn.knn_topk_batch(torch.from_numpy(cases), torch.from_numpy(q[None]), 5)
    assert knn.launches == {"knn_topk": 0, "knn_topk_batch": 0, "cluster": 0, "warp": 0}


@pytest.fixture(scope="module")
def bases():
    """A reference numpy-backend base learned over three weeks, and the
    port's CPU base holding the same windows."""
    mat = RefScenario(capacity=8, learn_weeks=3, family="alibaba",
                      seed=101).materialize()
    ref_kb = RefKB(backend="numpy")
    ref_learn_window(ref_kb, mat.hist, mat.ci, 0, WEEK, mat.cluster,
                     offsets=(0, WEEK, 2 * WEEK))
    kb = KnowledgeBase.from_windows(list(ref_kb._windows), device="cpu")
    X = np.concatenate([w[0] for w in ref_kb._windows])
    rng = np.random.default_rng(7)
    states = X[rng.integers(len(X), size=120)] \
        * (1.0 + 0.05 * rng.normal(size=(120, X.shape[1])))
    return ref_kb, kb, states


def test_kb_case_matrix_is_float64_on_cpu(bases):
    ref_kb, kb, _ = bases
    assert len(kb) == len(ref_kb) == 3 * WEEK
    xs = kb.case_matrix()
    assert xs.device.type == "cpu" and xs.dtype == torch.float64
    np.testing.assert_array_equal(xs.numpy(), ref_kb._cases())


@pytest.mark.parametrize("k", [1, 5, 8])
def test_kb_query_matches_numpy_backend(bases, k):
    ref_kb, kb, states = bases
    for s in states:
        rm, rr, rd = ref_kb.query(s, k=k)
        m, r, d = kb.query(s, k=k)
        np.testing.assert_array_equal(m, rm)
        np.testing.assert_array_equal(r, rr)
        np.testing.assert_allclose(d, rd, rtol=1e-12, atol=0)


@pytest.mark.parametrize("k", [1, 5])
def test_kb_query_batch_matches_numpy_backend(bases, k):
    ref_kb, kb, states = bases
    rm, rr, rd = ref_kb.query_batch(states, k=k)
    m, r, d = kb.query_batch(states, k=k)
    assert m.shape == (len(states), k)
    np.testing.assert_array_equal(m, rm)
    np.testing.assert_array_equal(r, rr)
    np.testing.assert_allclose(d, rd, rtol=1e-12, atol=0)


def test_kb_query_batch_on_stored_cases_matches_numpy_backend(bases):
    """Queries that coincide with stored cases: the expansion's tiny
    negative distances clamp to zero before the selection, as in the
    reference, so the neighbours come out in the reference's order."""
    ref_kb, kb, _ = bases
    X = np.concatenate([w[0] for w in ref_kb._windows])
    states = X[np.random.default_rng(3).integers(len(X), size=60)]
    rm, rr, rd = ref_kb.query_batch(states, k=5)
    m, r, d = kb.query_batch(states, k=5)
    np.testing.assert_array_equal(m, rm)
    np.testing.assert_array_equal(r, rr)
    # Near a stored case the expansion's round-off (~eps * ||x||^2) shows
    # through the sqrt as ~1e-7 in either package, in its own summation
    # order; away from zero the rtol holds.
    np.testing.assert_allclose(d, rd, rtol=1e-12, atol=1e-6)
    assert np.all(d[:, 0] <= 1e-6)


def test_kb_add_window_matches_from_windows(bases):
    ref_kb, kb, states = bases
    built = KnowledgeBase(device="cpu", max_windows=2)
    for s, y in ref_kb._windows:
        built.add_window(s, y[:, 0], y[:, 1])
    tail = KnowledgeBase.from_windows(list(ref_kb._windows)[-2:], device="cpu")
    assert len(built) == len(tail) == 2 * WEEK
    for s in states[:10]:
        for a, b in zip(built.query(s), tail.query(s)):
            np.testing.assert_array_equal(a, b)


def test_kb_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        KnowledgeBase()
    with pytest.raises(RuntimeError, match="empty"):
        KnowledgeBase(device="cpu").query(np.zeros(13))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 5, 8])
def test_lookup_on_cpu_runs_the_plain_version(dtype, k):
    """``knn_lookup`` on CPU cases: the plain version's neighbours, as numpy
    float64 distances and int64 indices, ties to the lower index, and no
    launch."""
    cases, q = _inputs(300, 13, seed=k)
    cases[[7, 40, 41]] = cases[3]               # ties at one distance
    knn.reset_launches()
    c = torch.from_numpy(cases).to(dtype)
    dist, idx = knn.knn_lookup(c, q.astype(np.float64), k)
    assert isinstance(dist, np.ndarray) and dist.dtype == np.float64 and dist.shape == (k,)
    assert isinstance(idx, np.ndarray) and idx.dtype == np.int64 and idx.shape == (k,)
    dp, ip = knn.knn_topk_plain(c, torch.from_numpy(q).to(dtype), k)
    np.testing.assert_array_equal(dist, dp.double().numpy())
    np.testing.assert_array_equal(idx, ip.numpy())
    assert knn.launches == {"knn_topk": 0, "knn_topk_batch": 0, "cluster": 0, "warp": 0}
    q3 = cases[3].astype(np.float64)
    _, idx3 = knn.knn_lookup(c, q3, 4)
    assert idx3.tolist() == [3, 7, 40, 41]


def test_kb_query_goes_through_lookup(bases, monkeypatch):
    """``KnowledgeBase.query`` makes one ``knn_lookup`` per call with the
    normalised host query, and returns its float64 distances as they are."""
    ref_kb, kb, states = bases
    seen = []
    lookup = knn.knn_lookup

    def counted(cases, query, k):
        seen.append((type(query), np.asarray(query).dtype, k))
        return lookup(cases, query, k)

    monkeypatch.setattr(knn, "knn_lookup", counted)
    for s in states[:5]:
        m, r, d = kb.query(s, k=5)
        assert d.dtype == np.float64 and m.dtype == np.float64
        np.testing.assert_allclose(d, ref_kb.query(s, k=5)[2], rtol=1e-12, atol=0)
    assert seen == [(np.ndarray, np.dtype(np.float64), 5)] * 5


@pytest.mark.parametrize("n,d,rows,blocks", [(1, 13, 2048, 1), (1344, 13, 2048, 1),
                                             (2048, 13, 2048, 1), (2049, 13, 2048, 2),
                                             (4099, 13, 2048, 3), (700, 256, 192, 4),
                                             (1000, 64, 768, 2)])
def test_query_tiling(n, d, rows, blocks):
    """Rows per block (the tile of rows in shared memory) and blocks of the
    single-query kernel; the merge launch runs past one block."""
    assert knn.query_rows(d) == rows and rows % 4 == 0
    assert rows * d * 4 <= knn.QSMEM
    assert knn.query_blocks(n, d) == blocks


def test_query_constants_match_the_cuda_source():
    import re
    from pathlib import Path

    src = (Path(knn.__file__).resolve().parents[1] / "csrc" / "knn.cu").read_text()
    const = {n: int(v) for n, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (const["QTHREADS"], const["QROWS"], const["QSMEM"]) == \
        (knn.QTHREADS, knn.QROWS, knn.QSMEM)
    assert (const["KMAX"], const["MAX_D"]) == (knn.KMAX, knn.MAX_D)
    assert "return (r < QROWS ? r : QROWS) / 4 * 4;" in src


# --- the batch kernels' launch arithmetic and the cluster kernel's algorithm ----


@pytest.mark.parametrize("n,d,nq,k", [(1, 13, 1, 1), (5, 13, 1, 5), (5, 13, 3, 5),
                                      (39, 13, 2, 8), (504, 13, 210, 5),
                                      (1344, 13, 168, 5), (1344, 13, 170, 5),
                                      (1344, 13, 1344, 5), (4099, 13, 1, 5),
                                      (4099, 13, 13, 8), (3000, 64, 37, 5),
                                      (700, 256, 9, 5), (5000, 256, 16, 1),
                                      (257, 11, 130, 5)])
def test_batch_plan_covers_each_query_and_row_once(n, d, nq, k):
    """The cluster kernel's grid, as ``csrc/knn.cu`` walks it, takes every
    (query, row) pair exactly once; every bulk copy starts and ends on 16
    bytes (the rest of a chunk, fewer than 4 floats, by plain loads);
    shared memory and clusters stay within the card's limits; at least 132
    blocks wherever 17 or more queries allow it."""
    pl = knn.batch_plan(n, d, nq, k)
    group, slices, rows, chunks = pl["group"], pl["slices"], pl["rows"], pl["chunks"]
    assert group in (1, 2, 4, 8) and 1 <= slices <= knn.BATCH_CLUSTER_MAX
    assert pl["threads"] == 32 * group and pl["blocks"] == -(-nq // group) * slices
    assert pl["blocks"] >= knn.BATCH_TARGET or nq * knn.BATCH_CLUSTER_MAX < knn.BATCH_TARGET
    assert rows % 4 == 0 and chunks == -(-n // rows) and 4 * rows * d <= knn.BATCH_TILE
    assert pl["smem"] == 4 * d * (rows + group) <= knn.BATCH_SMEM
    assert pl["smem"] + 8 * 8 * knn.KMAX + 16 <= 232_448     # and the static candidates
    taken = np.zeros((nq, n), np.int64)
    for b in range(pl["blocks"]):
        q0, rank = b // slices * group, b % slices
        for c in range(rank, chunks, slices):
            row0, cnt = c * rows, min(rows, n - c * rows)
            start, bulk = 4 * row0 * d, 4 * (cnt * d & ~3)
            assert start % 16 == 0 and bulk % 16 == 0 and cnt * d - bulk // 4 < 4
            taken[q0:q0 + group, row0:row0 + cnt] += 1
    assert (taken == 1).all()


def test_batch_warp_plan_is_the_previous_kernels_arithmetic():
    """``batch_warp_plan`` does what ``batch_chunk`` and the launch did in
    C before: chunks of a multiple of 32 rows within 48 KB at the odd
    stride, 8 queries a block."""
    for d, chunk in ((13, 256), (64, 160), (256, 32), (1, 256)):
        pl = knn.batch_warp_plan(1000, d, 17)
        assert pl["chunk"] == chunk and pl["blocks"] == 3
        assert pl["smem"] == (8 + chunk) * (d | 1) * 4 <= knn.SMEM_BUDGET


def test_batch_plan_and_routes_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        knn.batch_plan(4, 13, 1, 5)                # k > N
    with pytest.raises(ValueError):
        knn.batch_plan(10, 257, 1, 5)              # D > MAX_D
    cases, qs = _inputs(40, 13, q=3)
    with pytest.raises(ValueError, match="route"):
        knn.knn_topk_batch(torch.from_numpy(cases), torch.from_numpy(qs), 5, route="tiles")
    got = knn.knn_topk_batch(torch.from_numpy(cases), torch.from_numpy(qs), 5, route="warp")
    want = knn.knn_topk_batch_plain(torch.from_numpy(cases), torch.from_numpy(qs), 5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


_FILLER = (np.float32(np.inf), 2 ** 31 - 1)


def _lane_insert(lst, cand, k):
    """A lane's ascending k-list: (d, i) goes in before every pair it
    precedes (smaller d, then lower i); a NaN precedes nothing."""
    if np.isnan(cand[0]):
        return
    lst.append(cand)
    lst.sort(key=lambda c: (c[0], c[1]))
    del lst[k:]


def _warp_select(lists, k):
    """k rounds of the warp minimum over the lanes' heads, each round
    popping the head from every lane that holds it, as ``warp_topk``."""
    out = []
    for _ in range(k):
        heads = [lst[0] if lst else _FILLER for lst in lists]
        m = min(heads, key=lambda c: (c[0], c[1]))
        for lst in lists:
            if lst and lst[0] == m:
                lst.pop(0)
        out.append(m)
    return out


def _cluster_model(cases, queries, k):
    """The cluster kernel's algorithm in Python: per block (one slice of
    chunks) lane l of query q's warp keeps rows l, l + 32, ... of each chunk
    in its k-list, the warp selects its k best, and block 0 merges the
    slices' candidates (lane l taking candidates l, l + 32, ... of the
    slice-major list) by the same selection."""
    n, d = cases.shape
    pl = knn.batch_plan(n, d, len(queries), k)
    rows, slices = pl["rows"], pl["slices"]
    dist = np.empty((len(queries), k), np.float32)
    idx = np.empty((len(queries), k), np.int64)
    for qi, q in enumerate(queries):
        d2 = np.zeros(n, np.float32)
        for c in range(d):                       # the features in order
            diff = cases[:, c] - q[c]
            d2 = d2 + diff * diff
        cands = []
        for rank in range(slices):
            lanes = [[] for _ in range(32)]
            for ch in range(rank, pl["chunks"], slices):
                for r in range(ch * rows, min(n, (ch + 1) * rows)):
                    _lane_insert(lanes[(r - ch * rows) % 32], (d2[r], r), k)
            cands += _warp_select(lanes, k)
        lanes = [[] for _ in range(32)]
        for e, cand in enumerate(cands):
            if cand != _FILLER:
                _lane_insert(lanes[e % 32], cand, k)
        best = _warp_select(lanes, k)
        dist[qi] = np.sqrt(np.maximum([b[0] for b in best], 0))
        idx[qi] = [b[1] for b in best]
    return dist, idx


@pytest.mark.parametrize("q,n,d,k", [(1, 5, 13, 5), (3, 9, 13, 8), (168, 1344, 13, 5),
                                     (13, 4099, 13, 8), (6, 400, 11, 4)])
def test_cluster_model_matches_plain_and_pallas_on_ties_across_slices(q, n, d, k):
    """The Python model of the slice top-k and the cluster merge against the
    plain version and ``repro``'s batch kernel (Pallas, interpret mode): a
    tie of four rows across slice boundaries nearest to query 0 comes out
    in index order, and a NaN row is dropped.  N=5 and N=9 leave slices
    empty or with fewer than k rows."""
    cases, qs = _inputs(n, d, q=q, seed=n + q)
    rows = knn.batch_plan(n, d, q, k)["rows"]
    tied = list(dict.fromkeys(min(r, n - 1) for r in (1, rows - 1, rows, 2 * rows,
                                                       n - 1, n - 2, n - 3)))[:4]
    cases[tied] = cases[1]
    qs[0] = cases[1] + np.float32(0.05)
    if n > 8:
        cases[n // 2 + 1] = np.nan
    dist, idx = _cluster_model(cases, qs, k)
    tied = np.flatnonzero((cases == cases[1]).all(axis=1))
    assert idx[0, :min(k, len(tied))].tolist() == tied[:k].tolist()
    assert not np.isin(idx, np.flatnonzero(np.isnan(cases).any(axis=1))).any()
    ct, qt = torch.from_numpy(cases), torch.from_numpy(qs)
    dp, ip = knn.knn_topk_batch_plain(ct, qt, k)
    assert torch.equal(torch.from_numpy(idx[0, :len(tied)]), ip[0, :len(tied)])
    _assert_topk_close(dist, idx, dp.numpy(), ip.numpy(), cases, qs, rtol=1e-5, atol=1e-4)
    if n > 8:            # the Pallas kernel propagates NaN into every distance
        live = ~np.isnan(cases).any(axis=1)
        dr, ir = ref_knn.knn_topk_batch(jnp.asarray(cases[live]), jnp.asarray(qs), k,
                                        interpret=True)
        ir = np.flatnonzero(live)[np.asarray(ir)]
    else:
        dr, ir = ref_knn.knn_topk_batch(jnp.asarray(cases), jnp.asarray(qs), k,
                                        interpret=True)
    _assert_topk_close(dist, idx, np.asarray(dr), np.asarray(ir), cases, qs,
                       rtol=1e-5, atol=1e-4)


def test_batch_constants_match_the_cuda_source():
    import re
    from pathlib import Path

    src = (Path(knn.__file__).resolve().parents[1] / "csrc" / "knn.cu").read_text()
    const = {n: int(v) for n, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (const["BATCH_GROUP_MAX"], const["BATCH_CLUSTER_MAX"], const["BATCH_SMEM"],
            const["THREADS"]) == (knn.BATCH_GROUP_MAX, knn.BATCH_CLUSTER_MAX,
                                  knn.BATCH_SMEM, knn.BATCH_THREADS)
    assert "constexpr int SMEM_BUDGET = 48 * 1024;" in src and knn.SMEM_BUDGET == 48 * 1024
    # the staged rows and the largest group's queries fill the dynamic budget
    assert knn.BATCH_TILE + 4 * knn.BATCH_GROUP_MAX * knn.MAX_D == knn.BATCH_SMEM
    assert "rows % 4 != 0 || chunks != (n + rows - 1) / rows" in src
