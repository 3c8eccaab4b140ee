"""The port's score matrix and kernel API against the JAX package's.

``repro_torch.kernels.ops.score_matrix`` on CPU tensors (the plain version
of ``csrc/score.cu``) against ``repro.kernels.ops.score_matrix`` (the
Pallas kernel in interpret mode) and ``ref.score_matrix_ref``, at the JAX
package's kernel tolerance (rtol 1e-6, atol 1e-7) with the window mask
exact; then the other entry points of ``ops`` against the wrappers they
route to.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from repro.kernels import ops as ref_ops
from repro.kernels import ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import knn, ops, score

RTOL, ATOL = 1e-6, 1e-7


def _inputs(j, t, seed, ci_low=20.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, j).astype(np.float32),
            rng.uniform(ci_low, 600, t).astype(np.float32),
            rng.integers(0, t, j).astype(np.int32),
            rng.integers(0, t + 5, j).astype(np.int32))


def _port(marg, ci, ts, te):
    out = ops.score_matrix(*(torch.from_numpy(x) for x in (marg, ci, ts, te)))
    assert out.dtype == torch.float32 and out.shape == (len(marg), len(ci))
    return out.numpy()


def _check(marg, ci, ts, te):
    got = _port(marg, ci, ts, te)
    args = [jnp.asarray(x) for x in (marg, ci, ts, te)]
    pallas = np.asarray(ref_ops.score_matrix(*args))
    want = np.asarray(ref.score_matrix_ref(*args))
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    t = np.arange(len(ci))
    mask = (t[None, :] >= ts[:, None]) & (t[None, :] < te[:, None])
    np.testing.assert_array_equal(got == 0, ~mask | (marg[:, None] == 0))
    return got


@given(j=st.integers(1, 600), t=st.integers(1, 300), seed=st.integers(0, 99))
@settings(max_examples=20, deadline=None)
def test_matches_pallas_and_ref(j, t, seed):
    _check(*_inputs(j, t, seed))


def test_window_mask_exact():
    out = _port(np.ones(1, np.float32), np.ones(6, np.float32),
                np.array([2], np.int32), np.array([4], np.int32))
    np.testing.assert_array_equal(out[0], [0, 0, 1, 1, 0, 0])


@pytest.mark.parametrize("j,t", [(1, 1), (1, 777), (1000, 1), (257, 129),
                                 (300, 168)])
def test_edge_shapes(j, t):
    """Shapes no tile divides, a single row or slot, windows past the end
    or empty, and intensities at or below the 1e-9 floor."""
    marg, ci, ts, te = _inputs(j, t, seed=j + t)
    te[::3] = t + 40                       # past the end
    ts[1::5] = te[1::5]                    # empty window
    ts[2::7], te[2::7] = te[2::7] + 1, ts[2::7].copy()    # start after end
    ci[::4] = np.array([0.0, 1e-9, 1e-12, -3.0], np.float32)[np.arange(len(ci[::4])) % 4]
    got = _check(marg, ci, ts, te)
    floor = ci <= np.float32(1e-9)
    for r in range(min(j, 4)):
        inside = (np.arange(t) >= ts[r]) & (np.arange(t) < te[r]) & floor
        np.testing.assert_array_equal(got[r, inside], marg[r] / np.float32(1e-9))


def test_plain_keeps_the_dtype_and_launches_nothing():
    marg, ci, ts, te = _inputs(40, 30, seed=3)
    score.reset_launches()
    out = ops.score_matrix(torch.from_numpy(marg).double(), torch.from_numpy(ci).double(),
                           torch.from_numpy(ts), torch.from_numpy(te))
    assert out.dtype == torch.float64
    assert score.launches == {"score_matrix": 0}
    np.testing.assert_allclose(out.numpy(), _port(marg, ci, ts, te), rtol=1e-6)


# --- the rest of the kernel API ------------------------------------------------


def test_ops_knn_routes_to_the_wrappers():
    rng = np.random.default_rng(0)
    cases = torch.from_numpy(rng.normal(size=(300, 13)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(13,)).astype(np.float32))
    qs = torch.from_numpy(rng.normal(size=(7, 13)).astype(np.float32))
    for got, want in ((ops.knn_topk(cases, q, 5), knn.knn_topk(cases, q, 5)),
                      (ops.knn_topk_batch(cases, qs, 5),
                       knn.knn_topk_batch(cases, qs, 5))):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    dist, idx = ops.knn_topk(cases, q, 5)
    d2 = ((cases - q) ** 2).sum(1)
    assert torch.equal(idx, torch.sort(d2, stable=True).indices[:5])


def test_ops_flash_attention_routes_to_the_wrapper():
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(2, 9, 4, 32)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(2, 12, 2, 32)).astype(np.float32))
            for _ in range(2))
    assert torch.equal(ops.flash_attention(q, k, v, causal_offset=3),
                       fa.gqa_flash(q, k, v, causal_offset=3))
    assert torch.equal(ops.flash_attention(q, k, v), fa.gqa_flash_plain(q, k, v))


def test_ops_matches_the_reference_api():
    """Same entry points, same argument order, ``interpret`` left out."""
    import inspect

    for name in ("knn_topk", "knn_topk_batch", "score_matrix", "flash_attention"):
        mine = list(inspect.signature(getattr(ops, name)).parameters)
        theirs = [p for p in inspect.signature(getattr(ref_ops, name)).parameters
                  if p not in ("interpret", "kw")]
        assert mine == theirs, name


def test_score_matrix_on_the_oracle_pair_grid():
    """The score matrix over the oracle's (job, scale) pairs of a learning
    window: its nonzero cells are the oracle's entries, each within the
    three float32 roundings (marginal, CI, quotient: rtol 2e-7) of the
    entry's float64 score; and it matches the Pallas kernel there."""
    import dataclasses

    from repro_torch.core import oracle
    from repro_torch.experiment import Scenario

    mat = Scenario(capacity=8, learn_weeks=1, family="alibaba", seed=101).materialize()
    jobs = [dataclasses.replace(j) for j in mat.hist if j.arrival < 168]
    ci = mat.ci.trace[:168]
    pj, pk, pgain, pt0, pt1, _ = oracle._pairs(jobs, 168)
    j_idx, t_idx, k_val, _, score64 = oracle._build_entries(jobs, ci, 168)
    out = _check(pgain.astype(np.float32), ci.astype(np.float32),
                 pt0.astype(np.int32), pt1.astype(np.int32))
    assert (out != 0).sum() == len(j_idx)
    row = {(j, k): r for r, (j, k) in enumerate(zip(pj.tolist(), pk.tolist()))}
    rows = np.array([row[jk] for jk in zip(j_idx.tolist(), k_val.tolist())])
    np.testing.assert_allclose(out[rows, t_idx], score64, rtol=2e-7)
