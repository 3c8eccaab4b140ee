"""The DAG dependency gating of the PyTorch port against the JAX package.

On the CPU the wrappers run the plain versions.  Every form must equal the
three forms of ``repro.kernels.gating`` — the scatter ``dep_decrement``,
the padded-gather ``dep_decrement_gather`` and the Pallas kernel
``dep_decrement_pallas`` in interpret mode — as exact int32 counts, over
random graphs from a numpy seed: empty edge lists, duplicate edges, edge
padding that self-loops on the last row (the reference's layout), in-
degrees above the reference's dense-gather bound of 64, and a batch
dimension.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import gating as ref_gating
from repro_torch.kernels import gating

N = 256            # row N-1 is padding and never finishes


def _graph(seed, n_edges, dup=False, hub=False):
    rng = np.random.default_rng(seed)
    parents = rng.integers(0, N - 1, size=n_edges)
    children = rng.integers(0, N - 1, size=n_edges)
    if dup and n_edges:
        parents = np.concatenate([parents, parents[: n_edges // 2]])
        children = np.concatenate([children, children[: n_edges // 2]])
    if hub:
        # one row with in-degree 90, above the reference's MAX_GATHER_DEG
        parents = np.concatenate([parents, rng.integers(0, N - 1, size=90)])
        children = np.concatenate([children, np.full(90, 7)])
    return parents, children


def _fin(seed, batch=None):
    rng = np.random.default_rng(seed + 1000)
    shape = (N,) if batch is None else (batch, N)
    fin = rng.random(shape) < 0.4
    fin[..., N - 1] = False
    return fin


def _pred_rows(parents, children):
    """The reference's padded transpose (padding -> row N-1)."""
    deg = np.bincount(children, minlength=N)
    d_pad = max(1, int(deg.max()) if len(children) else 1)
    pred_rows = np.full((N, d_pad), N - 1, dtype=np.int64)
    order = np.argsort(children, kind="stable")
    starts = np.concatenate([[0], np.cumsum(deg)])
    sc = children[order]
    pred_rows[sc, np.arange(len(sc)) - starts[sc]] = parents[order]
    return pred_rows


def _reference(fin, parents, children):
    """(scatter, gather, pallas) of the JAX package for one (N,) fin."""
    fin_j = jnp.asarray(fin)
    p, c = jnp.asarray(parents, dtype=jnp.int32), jnp.asarray(children, dtype=jnp.int32)
    return (np.asarray(ref_gating.dep_decrement(fin_j, p, c, N)),
            np.asarray(ref_gating.dep_decrement_gather(
                fin_j, jnp.asarray(_pred_rows(parents, children)))),
            np.asarray(ref_gating.dep_decrement_pallas(fin_j, p, c, N,
                                                       interpret=True)))


GRAPHS = [
    pytest.param(dict(n_edges=0), id="empty"),
    pytest.param(dict(n_edges=37), id="sparse"),
    pytest.param(dict(n_edges=700), id="dense"),
    pytest.param(dict(n_edges=500, dup=True), id="duplicates"),
    pytest.param(dict(n_edges=120, hub=True), id="in-degree-90"),
]


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_forms_equal_reference(graph, seed):
    parents, children = _graph(seed, **graph)
    fin = _fin(seed)
    scatter, gather, pallas = _reference(fin, parents, children)
    np.testing.assert_array_equal(scatter, gather)
    np.testing.assert_array_equal(scatter, pallas)
    assert scatter.dtype == np.int32
    t_fin = torch.from_numpy(fin)
    t_par, t_chd = torch.from_numpy(parents), torch.from_numpy(children)
    forms = {
        "plain": gating.dep_decrement_plain(t_fin, t_par, t_chd, N),
        "gather": gating.dep_decrement_gather_plain(
            t_fin, torch.from_numpy(_pred_rows(parents, children))),
        "csr": gating.dep_decrement_csr(
            t_fin, gating.dep_graph(parents, children, N, device="cpu")),
        "edges": gating.dep_decrement(t_fin, t_par.int(), t_chd.int(), N),
    }
    for name, got in forms.items():
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(), scatter, err_msg=name)


@pytest.mark.parametrize("graph", GRAPHS)
def test_padding_self_loops_count_nothing(graph):
    """The reference pads its edge list to EDGE_BLOCK with self-loops on
    row N-1, whose fin is always False; the port's forms take such a list
    as it is."""
    parents, children = _graph(3, **graph)
    pad = ref_gating.EDGE_BLOCK - len(parents) % ref_gating.EDGE_BLOCK
    pp = np.concatenate([parents, np.full(pad, N - 1)])
    pc = np.concatenate([children, np.full(pad, N - 1)])
    fin = _fin(3)
    scatter, _, _ = _reference(fin, parents, children)
    t_fin = torch.from_numpy(fin)
    np.testing.assert_array_equal(gating.dep_decrement_plain(
        t_fin, torch.from_numpy(pp), torch.from_numpy(pc), N).numpy(), scatter)
    np.testing.assert_array_equal(gating.dep_decrement_csr(
        t_fin, gating.dep_graph(pp, pc, N, device="cpu")).numpy(), scatter)


@pytest.mark.parametrize("graph", GRAPHS)
def test_batch_dim_equals_rows_one_by_one(graph):
    parents, children = _graph(5, **graph)
    fin = _fin(5, batch=6)
    g = gating.dep_graph(parents, children, N, device="cpu")
    t_par, t_chd = torch.from_numpy(parents), torch.from_numpy(children)
    batched = {
        "csr": gating.dep_decrement_csr(torch.from_numpy(fin), g),
        "plain": gating.dep_decrement_plain(torch.from_numpy(fin), t_par, t_chd, N),
        "gather": gating.dep_decrement_gather_plain(
            torch.from_numpy(fin), torch.from_numpy(_pred_rows(parents, children))),
    }
    for b in range(fin.shape[0]):
        scatter, _, _ = _reference(fin[b], parents, children)
        for name, got in batched.items():
            assert got.shape == fin.shape and got.dtype == torch.int32
            np.testing.assert_array_equal(got[b].numpy(), scatter, err_msg=name)


def test_uint8_fin_counts_nonzero():
    parents, children = _graph(2, n_edges=300)
    fin = _fin(2)
    as_u8 = torch.from_numpy(fin.astype(np.uint8) * 3)       # nonzero = finished
    want = gating.dep_decrement_csr(torch.from_numpy(fin),
                                    gating.dep_graph(parents, children, N, device="cpu"))
    assert torch.equal(gating.dep_decrement_csr(
        as_u8, gating.dep_graph(parents, children, N, device="cpu")), want)
    assert torch.equal(gating.dep_decrement_plain(
        as_u8, torch.from_numpy(parents), torch.from_numpy(children), N), want)


def test_dep_graph_layout_and_checks():
    g = gating.dep_graph(np.array([0, 2, 1, 0]), np.array([3, 3, 1, 1]), 4,
                         device="cpu")
    assert g.n == 4 and g.n_edges == 4
    assert g.pred_ptr.tolist() == [0, 0, 2, 2, 4]
    assert g.pred_idx.tolist() == [1, 0, 0, 2]      # edge order within a row
    assert g.pred_ptr.dtype == g.pred_idx.dtype == torch.int32
    with pytest.raises(ValueError, match="endpoints"):
        gating.dep_graph(np.array([0]), np.array([4]), 4, device="cpu")
    with pytest.raises(ValueError, match="matching"):
        gating.dep_graph(np.array([0, 1]), np.array([1]), 4, device="cpu")
    empty = gating.dep_graph(np.zeros(0, np.int64), np.zeros(0, np.int64), 4,
                             device="cpu")
    assert empty.pred_ptr.tolist() == [0] * 5 and empty.n_edges == 0


def test_dep_graph_defaults_to_the_card():
    """Like every entry point of the port, ``dep_graph`` puts the graph on
    the card unless asked for the CPU, and raises without one."""
    if torch.cuda.is_available():
        assert gating.dep_graph(np.array([0]), np.array([1]), 2).pred_ptr.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gating.dep_graph(np.array([0]), np.array([1]), 2)


def test_cpu_wrappers_launch_nothing():
    parents, children = _graph(4, n_edges=100)
    gating.reset_launches()
    graph = gating.dep_graph(parents, children, N, device="cpu")
    fin = torch.from_numpy(_fin(4))
    gating.dep_decrement_csr(fin, graph)
    gating.dep_decrement(fin, torch.from_numpy(parents), torch.from_numpy(children), N)
    gating.dep_release_csr(fin, fin, torch.zeros(N, dtype=torch.int32), graph)
    assert gating.launches == {"dep_decrement": 0, "dep_release": 0}


def _dag(seed, n_edges, batch):
    """A random DAG over N rows (every edge from a lower row to a higher
    one, duplicates kept; row N-1 padding), with fin, arrived and a live
    in-degree per cell: the in-degree less the predecessors that finished
    before, so that releases happen and rows of in-degree 0 are left."""
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, N - 1, (2, n_edges))
    parents, children = np.minimum(a, b), np.maximum(a, b)
    keep = parents != children
    parents, children = parents[keep], children[keep]
    shape = (N,) if batch is None else (batch, N)
    fin = rng.random(shape) < 0.4
    fin[..., N - 1] = False
    deg = np.bincount(children, minlength=N)
    before = np.minimum(rng.integers(0, 3, shape), deg)
    return parents, children, fin, rng.random(shape) < 0.8, (deg - before).astype(np.int32)


@pytest.mark.parametrize("n_edges", [0, 40, 600])
@pytest.mark.parametrize("batch", [None, 1, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_release_equals_engine_sequence_and_reference(seed, batch, n_edges):
    """``dep_release_csr`` (its plain version here) against the three ops
    the engine ran after the decrement, and against the JAX scan engine's
    release (``repro/core/scan_engine.py:511-514``) on ``repro``'s
    ``dep_decrement``, cell by cell: exact."""
    parents, children, fin, arrived, pred = _dag(seed, n_edges, batch)
    graph = gating.dep_graph(parents, children, N, device="cpu")
    t_fin, t_arr, t_pred = (torch.from_numpy(x) for x in (fin, arrived, pred))
    pred2, pending = gating.dep_release_csr(t_fin, t_arr, t_pred, graph)
    assert pred2.dtype == torch.int32 and pending.dtype == torch.bool
    assert pred2.shape == pending.shape == t_fin.shape
    want = gating.dep_release_csr_plain(t_fin, t_arr, t_pred, graph)
    assert torch.equal(pred2, want[0]) and torch.equal(pending, want[1])
    dec = gating.dep_decrement_csr(t_fin, graph)           # the engine's sequence
    assert torch.equal(pred2, t_pred - dec)
    assert torch.equal(pending, (dec > 0) & (t_pred - dec == 0) & t_arr)
    p, c = jnp.asarray(parents, dtype=jnp.int32), jnp.asarray(children, dtype=jnp.int32)
    for row in np.ndindex(fin.shape[:-1]):
        ref_dec = ref_gating.dep_decrement(jnp.asarray(fin[row]), p, c, N)
        ref_pred2 = jnp.asarray(pred[row]) - ref_dec       # int32: x64 is off
        ref_pending = (ref_dec > 0) & (ref_pred2 == 0) & jnp.asarray(arrived[row])
        np.testing.assert_array_equal(pred2[row].numpy(), np.asarray(ref_pred2))
        np.testing.assert_array_equal(pending[row].numpy(), np.asarray(ref_pending))
    released = pending.sum().item()
    assert (released > 0) == (n_edges > 0)

