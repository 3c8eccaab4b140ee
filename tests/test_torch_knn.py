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
    assert knn.launches == {"knn_topk": 0, "knn_topk_batch": 0}


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
    assert knn.launches == {"knn_topk": 0, "knn_topk_batch": 0}
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
