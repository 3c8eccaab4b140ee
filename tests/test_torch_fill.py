"""The variable-k capacity fill (``kernels/fill.py``) on the CPU.

``capacity_fill_plain`` is held against a direct transcription of the JAX
scan engine's fill (a stable argsort of the key "forced first, then row
order", walked row by row with continue-on-overflow,
``src/repro/core/scan_engine.py:469-488``), and so is a Python model of the
kernel's warp algorithm (``csrc/fill.cu``): per 32-row chunk, drop the rows
that can no longer fit, an inclusive prefix of the requests, commit the
rows before the first overflow, skip it, repeat; stop once the capacity
left is below the smallest candidate request.  Every comparison is exact (integers).  The
launch plan's grid, walked as the kernel walks it, touches every row once;
the constants match ``fill.cu``.  The compact kernel's schedule is modelled
the same way (``compact_model``: the chunk ballots, warp 0's scan of their
counts into offsets, the walk list in walk order, dense groups of 32 in the
same rounds) and held equal to the plain version up to n = 6144.  Last,
job lists whose ``k_min`` is not uniform run natively on the port's scan
engine and equal the JAX package's vector engine.
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core.baselines import CarbonAgnosticPolicy as RefAgnostic
from repro.core.baselines import WaitAwhilePolicy as RefWaitAwhile
from repro.core.carbon import CarbonService as RefCarbonService
from repro.core.simulator import simulate as ref_simulate
from repro.core.types import ClusterConfig as RefClusterConfig
from repro.traces import TraceSpec as RefTraceSpec
from repro.traces import generate_trace as ref_generate_trace
from repro_torch.core import baselines, scan_engine
from repro_torch.core.carbon import CarbonService
from repro_torch.core.simulator import simulate
from repro_torch.core.types import ClusterConfig
from repro_torch.kernels import fill
from repro_torch.traces import TraceSpec, generate_trace

WEEK = 24 * 7


def reference_fill(cand, forced, kreq, m_cap):
    """The JAX scan engine's fill, transcribed: stable argsort of the key,
    then one row at a time."""
    b, n = cand.shape
    take = np.zeros((b, n), dtype=bool)
    idx = np.arange(n)
    for c in range(b):
        key = np.where(cand[c], (~forced[c]).astype(np.int64) * n + idx, 2 * n)
        used = 0
        for row in np.argsort(key, kind="stable"):
            ok = bool(cand[c, row]) and used + int(kreq[c, row]) <= int(m_cap[c])
            if ok:
                used += int(kreq[c, row])
            take[c, row] = ok
    return take


def warp_rounds(k, live, cap, used, k_floor):
    """Warp 0's rounds over one group of 32 lanes (requests ``k``, lanes
    ``live``): drop the requests above the capacity left, take the
    inclusive prefix, commit the live lanes before the first overflow, skip
    that lane, repeat.  Returns the committed lanes, the new ``used``, and
    whether the capacity left fell below ``k_floor`` (the walk stops)."""
    lanes = range(32)
    committed = []
    while True:
        live &= sum(1 << lane for lane in lanes if k[lane] <= cap - used)
        if not live:
            return committed, used, False
        pre = np.cumsum([k[lane] if live >> lane & 1 else 0 for lane in lanes])
        over = sum(1 << lane for lane in lanes
                   if live >> lane & 1 and used + pre[lane] > cap)
        low = over & -over
        commit = live & (low - 1 if over else (1 << 32) - 1)
        committed += [lane for lane in lanes if commit >> lane & 1]
        if commit:
            used += int(pre[commit.bit_length() - 1])
        if not over:
            return committed, used, False
        live &= ~(low * 2 - 1)
        if cap - used < k_floor:
            return committed, used, True


def warp_model_cell(cand, forced, kreq, cap, take):
    """``capacity_fill_kernel``'s algorithm for one cell: the chunk masks of
    the two passes and the smallest candidate request, then warp 0's rounds
    over each chunk."""
    n = len(cand)
    k_floor = int(kreq[cand].min()) if cand.any() else 2 ** 63 - 1
    chunks = -(-n // 32)
    lanes = range(32)
    masks = [sum(1 << lane for lane in lanes
                 if ch * 32 + lane < n and sel[ch * 32 + lane])
             for sel in (cand & forced, cand & ~forced) for ch in range(chunks)]
    used = 0
    for i, live in enumerate(masks):
        if cap - used < k_floor:
            return
        if not live:
            continue
        base = (i % chunks) * 32
        k = [int(kreq[base + lane]) if live >> lane & 1 else 0 for lane in lanes]
        committed, used, stop = warp_rounds(k, live, cap, used, k_floor)
        for lane in committed:
            take[base + lane] = True
        if stop:
            return


def scan_offsets(counts):
    """Warp 0's scan of the chunk counts: lane ``l`` sums a segment of
    ``ceil(len / 32)`` counts, an inclusive warp scan of the sums, then each
    lane writes its segment's exclusive offsets.  Returns the offsets and
    the total."""
    per = -(-len(counts) // 32)
    segs = [range(min(lane * per, len(counts)), min(lane * per + per, len(counts)))
            for lane in range(32)]
    sums = [sum(counts[j] for j in seg) for seg in segs]
    incl = np.cumsum(sums)
    offs = [0] * len(counts)
    for lane, seg in enumerate(segs):
        run = int(incl[lane]) - sums[lane]
        for j in seg:
            offs[j] = run
            run += counts[j]
    return offs, int(incl[-1])


def walk_list(masks, chunks):
    """The compact kernels' walk list: each set bit of chunk mask ``j`` (the
    forced pass's chunks, then the unforced pass's) written at its chunk's
    offset plus the set bits below it; every slot written once."""
    offs, total = scan_offsets([bin(m).count("1") for m in masks])
    idx = [None] * total
    for j, m in enumerate(masks):
        for lane in range(32):
            if m >> lane & 1:
                pos = offs[j] + bin(m & ((1 << lane) - 1)).count("1")
                assert idx[pos] is None
                idx[pos] = (j % chunks) * 32 + lane
    assert None not in idx
    return idx


def compact_model_cell(cand, forced, kreq, cap, take):
    """``capacity_fill_compact_kernel`` for one cell: the chunk ballots and
    the smallest candidate request, the walk list, then warp 0's dense
    groups of 32 list entries in the same rounds."""
    n = len(cand)
    k_floor = int(kreq[cand].min()) if cand.any() else 2 ** 63 - 1
    chunks = -(-n // 32)
    masks = [sum(1 << lane for lane in range(32)
                 if ch * 32 + lane < n and sel[ch * 32 + lane])
             for sel in (cand & forced, cand & ~forced) for ch in range(chunks)]
    idx = walk_list(masks, chunks)
    used = 0
    for g in range(0, len(idx), 32):
        if cap - used < k_floor:
            return
        rows = idx[g:g + 32]
        k = [int(kreq[r]) for r in rows] + [0] * (32 - len(rows))
        committed, used, stop = warp_rounds(k, (1 << len(rows)) - 1, cap, used, k_floor)
        for lane in committed:
            take[rows[lane]] = True
        if stop:
            return


def compact_model(cand, forced, kreq, m_cap):
    take = np.zeros(cand.shape, dtype=bool)
    for c in range(cand.shape[0]):
        compact_model_cell(cand[c], forced[c], kreq[c], int(m_cap[c]), take[c])
    return take


def warp_model(cand, forced, kreq, m_cap):
    take = np.zeros(cand.shape, dtype=bool)
    for c in range(cand.shape[0]):
        warp_model_cell(cand[c], forced[c], kreq[c], int(m_cap[c]), take[c])
    return take


def random_inputs(seed, b, n, k_hi=8):
    g = np.random.default_rng(seed)
    cand = g.random((b, n)) < g.random()
    forced = g.random((b, n)) < g.random()
    kreq = g.integers(1, k_hi + 1, (b, n))
    m_cap = g.integers(0, max(2, int(kreq.sum(1).max() * g.random())) + 1, b)
    return cand, forced, kreq, m_cap


def plain(cand, forced, kreq, m_cap):
    return fill.capacity_fill_plain(*(torch.from_numpy(np.asarray(x)) for x in
                                      (cand, forced, kreq, m_cap))).numpy()


@given(seed=st.integers(0, 100_000), b=st.integers(1, 4), n=st.integers(1, 140))
@settings(max_examples=60, deadline=None)
def test_plain_equals_the_reference_walk(seed, b, n):
    args = random_inputs(seed, b, n)
    np.testing.assert_array_equal(plain(*args), reference_fill(*args))


@given(seed=st.integers(0, 100_000), b=st.integers(1, 3), n=st.integers(1, 100))
@settings(max_examples=40, deadline=None)
def test_warp_model_equals_the_plain_version(seed, b, n):
    cand, forced, kreq, m_cap = random_inputs(seed, b, n)
    want = plain(cand, forced, kreq, m_cap)
    np.testing.assert_array_equal(warp_model(cand, forced, kreq, m_cap), want)


@given(seed=st.integers(0, 100_000), b=st.integers(1, 3), n=st.integers(1, 300))
@settings(max_examples=40, deadline=None)
def test_compact_model_equals_the_plain_version(seed, b, n):
    cand, forced, kreq, m_cap = random_inputs(seed, b, n)
    want = plain(cand, forced, kreq, m_cap)
    np.testing.assert_array_equal(compact_model(cand, forced, kreq, m_cap), want)


@pytest.mark.parametrize("n", [256, 1792, 2048, 6144])
@pytest.mark.parametrize("seed", [0, 1])
def test_compact_model_at_the_kernel_widths(seed, n):
    """The compact schedule at the widths the card runs (the sweep's n_pad
    1792, the DAG tile's 6144), dense and sparse candidates."""
    cand, forced, kreq, m_cap = random_inputs(seed, 2, n)
    cand[1] &= np.random.default_rng(seed).random(n) < 0.05
    want = plain(cand, forced, kreq, m_cap)
    assert want.any()
    np.testing.assert_array_equal(compact_model(cand, forced, kreq, m_cap), want)


@pytest.mark.parametrize("counts", [1, 31, 32, 33, 112, 384, 385])
def test_scan_offsets_are_the_exclusive_prefix(counts):
    c = list(np.random.default_rng(counts).integers(0, 33, counts))
    offs, total = scan_offsets(c)
    assert offs == [0] + list(np.cumsum(c)[:-1]) and total == sum(c)


@pytest.mark.parametrize("case", ["capacity 0", "everything fits", "nothing fits",
                                  "all forced", "one row", "requests of 0",
                                  "negative capacity", "one small request"])
def test_edge_cases(case):
    g = np.random.default_rng(7)
    b, n = 3, 70
    cand = g.random((b, n)) < 0.6
    forced = g.random((b, n)) < 0.3
    kreq = g.integers(1, 9, (b, n))
    m_cap = np.full(b, 40)
    if case == "capacity 0":
        m_cap[:] = 0
    elif case == "everything fits":
        m_cap[:] = kreq.sum(1).max()
    elif case == "nothing fits":
        kreq[:] = 50
    elif case == "all forced":
        forced[:] = True
    elif case == "one row":
        cand, forced, kreq = cand[:, :1] | True, forced[:, :1], kreq[:, :1]
    elif case == "requests of 0":
        kreq[:, ::3] = 0
    elif case == "negative capacity":
        m_cap[:] = -1
    elif case == "one small request":
        # the last unforced candidate is the only one that fits: the walk
        # must not stop on the forced rows' larger requests
        kreq[:] = 50
        m_cap[:] = 49
        cand[:, -1], forced[:, -1], kreq[:, -1] = True, False, 1
    want = reference_fill(cand, forced, kreq, m_cap)
    np.testing.assert_array_equal(plain(cand, forced, kreq, m_cap), want)
    np.testing.assert_array_equal(warp_model(cand, forced, kreq, m_cap), want)
    np.testing.assert_array_equal(compact_model(cand, forced, kreq, m_cap), want)
    if case == "everything fits":
        assert (want == cand).all()
    if case in ("capacity 0", "nothing fits", "negative capacity"):
        assert not want.any()
    if case == "one small request":
        assert want.sum() == b and want[:, -1].all()


def test_wrapper_takes_the_plain_version_on_cpu_tensors():
    args = [torch.from_numpy(x) for x in random_inputs(3, 4, 300)]
    fill.reset_launches()
    want = fill.capacity_fill_plain(*args)
    for route in (None, *fill.ROUTES):
        assert torch.equal(fill.capacity_fill(*args, route=route), want)
    assert fill.launches == {"capacity_fill": 0, "compact": 0, "chunked": 0}
    with pytest.raises(ValueError, match="route"):
        fill.capacity_fill(*args, route="other")


@pytest.mark.parametrize("rows,n", [(1, 1), (1, 256), (64, 2048), (64, 6144),
                                    (3, 33), (2, 196_608)])
def test_plan_covers_every_row_once(rows, n):
    """Walk the grid as ``capacity_fill_kernel`` does: per block, threads
    stride the rows to zero them, warps stride the chunks for their masks,
    and warp 0's walk reads each chunk once per pass."""
    p = fill.plan(rows, n, route="chunked")
    assert p["blocks"] == rows and p["threads"] == fill.THREADS
    assert p["smem_bytes"] == 8 * p["chunks"] <= fill.SMEM_LIMIT and not p["opt_in"]
    zeroed = np.zeros(n, dtype=np.int64)
    for t in range(p["threads"]):
        zeroed[t::p["threads"]] += 1
    assert (zeroed == 1).all()
    masked = np.zeros(n, dtype=np.int64)
    for w in range(p["threads"] // 32):
        for ch in range(w, p["chunks"], p["threads"] // 32):
            masked[ch * 32:(ch + 1) * 32] += 1
    assert (masked == 1).all()
    walked = [i % p["chunks"] for i in range(2 * p["chunks"])]
    assert sorted(walked) == sorted(list(range(p["chunks"])) * 2)


@pytest.mark.parametrize("rows,n,smem", [(1, 1, 26), (64, 1792, 18_816), (3, 33, 362),
                                         (64, 6144, 64_512), (2, 22_000, 231_008)])
def test_compact_plan_covers_every_row_once(rows, n, smem):
    """Walk the compact kernel's grid: warps stride the chunks (each row's
    request and ballot once, its write once), every listed row lands in one
    slot of the walk list, and warp 0's groups of 32 read each slot once.
    The shared memory is the requests, the list, the masks and offsets; n
    = 6144 needs the opt-in above 48 KB."""
    p = fill.plan(rows, n)
    assert p["route"] == "compact" and p["blocks"] == rows
    assert p["threads"] == fill.COMPACT_THREADS
    assert p["smem_bytes"] == smem == fill.ROW_BYTES * n + fill.CHUNK_BYTES * p["chunks"]
    assert p["opt_in"] == (smem > fill.SMEM_LIMIT) and smem <= fill.SMEM_MAX
    staged = np.zeros(n, dtype=np.int64)
    for w in range(p["threads"] // 32):
        for ch in range(w, p["chunks"], p["threads"] // 32):
            staged[ch * 32:min(n, (ch + 1) * 32)] += 1
    assert (staged == 1).all()
    g = np.random.default_rng(n)
    cand = g.random(n) < 0.5
    forced = g.random(n) < 0.3
    masks = [sum(1 << lane for lane in range(32) if ch * 32 + lane < n and sel[ch * 32 + lane])
             for sel in (cand & forced, cand & ~forced) for ch in range(p["chunks"])]
    idx = walk_list(masks, p["chunks"])
    assert idx == list(np.flatnonzero(cand & forced)) + list(np.flatnonzero(cand & ~forced))
    assert max(idx, default=0) < 2 ** 16
    read = [i for grp in range(0, len(idx), 32) for i in range(grp, min(grp + 32, len(idx)))]
    assert read == list(range(len(idx)))


def test_plan_refuses_what_the_kernel_cannot_hold():
    with pytest.raises(ValueError, match="chunk masks"):
        fill.plan(1, 196_609, route="chunked")
    with pytest.raises(ValueError, match="a block holds"):
        fill.plan(1, 22_700)
    with pytest.raises(ValueError):
        fill.plan(-1, 10)
    with pytest.raises(ValueError, match="route"):
        fill.plan(1, 10, route="other")


def test_constants_match_the_kernel_source():
    src = (Path(fill.__file__).resolve().parents[1] / "csrc" / "fill.cu").read_text()
    for name in ("THREADS", "COMPACT_THREADS"):
        assert re.search(rf"constexpr int {name} = {getattr(fill, name)};", src), name
    assert "(n + 31) >> 5" in src and fill.CHUNK == 32
    assert "constexpr int COMPACT = 0, CHUNKED = 1;" in src
    assert fill.ROUTES == ("compact", "chunked")
    for name in ("ROW_BYTES", "CHUNK_BYTES"):
        assert re.search(rf"constexpr int {name} = {getattr(fill, name)};", src), name
    assert "constexpr int SMEM_LIMIT = 48 * 1024;" in src and fill.SMEM_LIMIT == 48 * 1024
    assert "ROW_BYTES * n + CHUNK_BYTES * chunks" in src


def _non_uniform_world(seed):
    """A week of jobs whose k_min is 1, 2 or 3, in both packages."""
    ref_cluster, cluster = RefClusterConfig.default(12), ClusterConfig.default(12)
    ref_ci = RefCarbonService.synthetic("germany", WEEK + 24 * 30, seed=seed)
    ci = CarbonService.synthetic("germany", WEEK + 24 * 30, seed=seed)
    spec = dict(hours=WEEK, capacity=12, seed=seed + 1, k_min=1)

    def k(j):
        return 1 + j.job_id % 3

    ref_jobs = [dataclasses.replace(j, k_min=k(j)) for j in
                ref_generate_trace(RefTraceSpec(**spec), ref_cluster.queues)]
    jobs = [dataclasses.replace(j, k_min=k(j)) for j in
            generate_trace(TraceSpec(**spec), cluster.queues)]
    return (ref_jobs, ref_ci, ref_cluster), (jobs, ci, cluster)


@pytest.mark.parametrize("name,ref_cls,cls", [
    ("carbon-agnostic", RefAgnostic, baselines.CarbonAgnosticPolicy),
    ("wait-awhile", RefWaitAwhile, baselines.WaitAwhilePolicy),
])
def test_mixed_k_min_runs_natively_and_equals_the_reference(name, ref_cls, cls):
    (ref_jobs, ref_ci, ref_cluster), (jobs, ci, cluster) = _non_uniform_world(5)
    want = ref_simulate(ref_jobs, ref_ci, ref_cluster, ref_cls(), horizon=WEEK)
    scan_engine.reset_stats()
    got = simulate(jobs, ci, cluster, cls(), horizon=WEEK, engine="scan", device="cpu")
    assert scan_engine.stats["delegated"] == 0
    assert scan_engine.stats["fill_steps"] == scan_engine.stats["steps"] > WEEK
    assert got.carbon_g == want.carbon_g and got.energy_kwh == want.energy_kwh
    np.testing.assert_array_equal(got.completion, want.completion)
    np.testing.assert_array_equal(got.wait_slots, want.wait_slots)
    np.testing.assert_array_equal(got.violations, want.violations)
    assert [s.used for s in got.slots] == [s.used for s in want.slots]
    assert len({j.k_min for j in jobs}) == 3
