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
the constants match ``fill.cu``.  Last, job lists whose ``k_min`` is not
uniform run natively on the port's scan engine and equal the JAX package's
vector engine.
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
        while True:
            live &= sum(1 << lane for lane in lanes if k[lane] <= cap - used)
            if not live:
                break
            pre = np.cumsum([k[lane] if live >> lane & 1 else 0 for lane in lanes])
            over = sum(1 << lane for lane in lanes
                       if live >> lane & 1 and used + pre[lane] > cap)
            low = over & -over
            commit = live & (low - 1 if over else (1 << 32) - 1)
            for lane in lanes:
                if commit >> lane & 1:
                    take[base + lane] = True
            if commit:
                used += int(pre[commit.bit_length() - 1])
            if not over:
                break
            live &= ~(low * 2 - 1)
            if cap - used < k_floor:
                return


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
    if case == "everything fits":
        assert (want == cand).all()
    if case in ("capacity 0", "nothing fits", "negative capacity"):
        assert not want.any()
    if case == "one small request":
        assert want.sum() == b and want[:, -1].all()


def test_wrapper_takes_the_plain_version_on_cpu_tensors():
    args = [torch.from_numpy(x) for x in random_inputs(3, 4, 300)]
    fill.reset_launches()
    assert torch.equal(fill.capacity_fill(*args),
                       fill.capacity_fill_plain(*args))
    assert fill.launches["capacity_fill"] == 0


@pytest.mark.parametrize("rows,n", [(1, 1), (1, 256), (64, 2048), (64, 6144),
                                    (3, 33), (2, 196_608)])
def test_plan_covers_every_row_once(rows, n):
    """Walk the grid as ``capacity_fill_kernel`` does: per block, threads
    stride the rows to zero them, warps stride the chunks for their masks,
    and warp 0's walk reads each chunk once per pass."""
    p = fill.plan(rows, n)
    assert p["blocks"] == rows and p["threads"] == fill.THREADS
    assert p["smem_bytes"] == 8 * p["chunks"] <= fill.SMEM_LIMIT
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


def test_plan_refuses_what_the_kernel_cannot_hold():
    with pytest.raises(ValueError, match="chunk masks"):
        fill.plan(1, 196_609)
    with pytest.raises(ValueError):
        fill.plan(-1, 10)


def test_constants_match_the_kernel_source():
    src = (Path(fill.__file__).resolve().parents[1] / "csrc" / "fill.cu").read_text()
    assert int(re.search(r"constexpr int THREADS = (\d+);", src).group(1)) == fill.THREADS
    assert "(n + 31) >> 5" in src and fill.CHUNK == 32


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
