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
    assert score.launches == {"score_matrix": 0, "rows": 0, "columns": 0, "flat": 0}
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


# --- the kernels' launch arithmetic --------------------------------------------


def _rows_walk(t4, bj, rows, threads):
    """The float4s ``score_rows_kernel``'s threads visit in a block of
    ``rows`` rows: (row, column) from one division, then stepped by
    additions, as the kernel steps them."""
    seen = []
    dr, dc = threads // t4, threads % t4
    for tid in range(threads):
        r, c = divmod(tid, t4)
        for _ in range(tid, rows * t4, threads):
            seen.append((r, c))
            c, r = c + dc, r + dr
            if c >= t4:
                c, r = c - t4, r + 1
    return seen


def _columns_walk(t, row_offset, tiles, threads):
    """The columns ``score_columns_kernel`` stores in one row whose first
    element lies ``row_offset`` floats past a 16-byte boundary: the float4s
    (start column) and the plain head and tail columns."""
    head = min((4 - row_offset) % 4, t)
    vecs = (t - head) // 4
    quads = [head + 4 * v for v in range(min(vecs, tiles * threads))]
    singles = [c for c in range(head)] + [c for c in range(head + 4 * vecs, t)]
    return head, vecs, quads, singles


@pytest.mark.parametrize("j", [1, 257, 1000, 3001, 6944])
@pytest.mark.parametrize("t", [1, 129, 168, 552, 777])
def test_plan_covers_each_row_once(j, t):
    """Each route's grid, as ``csrc/score.cu`` walks it, writes every
    element once, and every float4 store starts on a 16-byte boundary of
    the (16-byte aligned) output."""
    pl = score.plan(j, t)
    assert pl["route"] == ("rows" if t % 4 == 0 else "columns")
    if pl["route"] == "rows":
        bj = pl["bj"]
        assert pl["blocks"] == -(-j // bj) and pl["threads"] == score.ROW_THREADS
        assert pl["blocks"] >= score.TARGET_BLOCKS or bj == 1
        assert bj == 8 or -(-j // (2 * bj)) < score.TARGET_BLOCKS
        rows_seen = np.zeros(j, np.int64)
        for b in range(pl["blocks"]):
            rows_seen[b * bj:(b + 1) * bj] += 1
        assert (rows_seen == 1).all()
        t4 = t // 4
        for rows in {bj, j - (pl["blocks"] - 1) * bj}:     # a full block, the last one
            seen = _rows_walk(t4, bj, rows, score.ROW_THREADS)
            assert sorted(seen) == [(r, c) for r in range(rows) for c in range(t4)]
        # a row starts at 4 j t bytes: on 16 bytes for t a multiple of 4
        assert (4 * t) % 16 == 0
    else:
        assert pl["blocks"] == j and pl["threads"] == score.COLUMN_THREADS
        for row in range(min(j, 4)):
            off = row * t % 4
            head, vecs, quads, singles = _columns_walk(t, off, pl["tiles"], pl["threads"])
            assert len(quads) == vecs                       # the tiles reach every float4
            covered = sorted(singles + [q + i for q in quads for i in range(4)])
            assert covered == list(range(t))
            assert all((off + q) % 4 == 0 for q in quads)   # 16-byte aligned stores


def test_plan_routes_and_refusals():
    """The rows route takes T a multiple of 4 up to ROW_FLOATS with an
    aligned ``ci``; the columns route every shape; the flat route is the
    previous kernel's grid."""
    assert score.plan(6944, 168) == dict(route="rows", bj=8, blocks=868, threads=128)
    assert score.plan(6800, 552) == dict(route="rows", bj=8, blocks=850, threads=128)
    assert score.plan(100, 168)["bj"] == 1 and score.plan(1000, 168)["bj"] == 2
    assert score.plan(10, score.ROW_FLOATS + 4)["route"] == "columns"
    assert score.plan(6944, 168, aligned=False)["route"] == "columns"
    assert score.plan(5, 20001)["tiles"] == 20
    assert score.plan(6944, 168, "flat") == dict(route="flat", blocks=4557, threads=256)
    for bad in (dict(j=5, t=777, route="rows"), dict(j=5, t=168, route="rows", aligned=False),
                dict(j=0, t=168), dict(j=5, t=168, route="tiles")):
        with pytest.raises(ValueError):
            score.plan(**bad)
    marg, ci, ts, te = (torch.from_numpy(x) for x in _inputs(20, 12, seed=1))
    with pytest.raises(ValueError, match="route"):
        score.score_matrix(marg, ci, ts, te, route="tiles")
    assert torch.equal(score.score_matrix(marg, ci, ts, te, route="flat"),
                       score.score_matrix_plain(marg, ci, ts, te))


def test_score_constants_match_the_cuda_source():
    import re
    from pathlib import Path

    src = (Path(score.__file__).resolve().parents[1] / "csrc" / "score.cu").read_text()
    const = {n: int(v) for n, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert const == dict(ROW_THREADS=score.ROW_THREADS, ROW_FLOATS=score.ROW_FLOATS,
                         COLUMN_THREADS=score.COLUMN_THREADS, FLAT_THREADS=score.FLAT_THREADS)
    assert "T % 4 != 0 || T > ROW_FLOATS" in src
