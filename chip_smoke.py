"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases, any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``); build the CUDA kernels
   of ``src/repro_torch/csrc`` (one ``nvcc`` per source, all at once) and
   time each build;
2. every kernel against its plain PyTorch version on the card, at the
   shapes its path gives it, with times from CUDA events beside the
   bound, the plain version and one library call (the single-query KNN
   kernel through ``knn_lookup``, the per-slot lookup with the query as a
   launch parameter and the neighbours written into pinned host memory,
   equal bit for bit to ``knn_topk`` on a device query); ``gqa_flash`` on each
   shape's route (the Hopper kernel for bf16 at D 64 and 128), its launches
   counted by route, and at the prefill's shape the Hopper kernel timed in
   turns with the retained mma.sync kernel (at most half its time); the
   batch KNN lookup on the cluster kernel equal bit for bit to the previous
   (warp) kernel, and at Q=168 N=1344 the two timed in turns by profiler
   device time (the cluster kernel at most half), beside the floor (an empty
   kernel launched the same way) and the share of the bound;
3. the main path: ``repro_torch.experiment.run`` over the quickstart
   scenario with six evaluation weeks (the rolling knowledge base fills to
   its 8 windows = 1344 cases), knowledge base on the card, kernel launches
   counted against the provisioning calls; then the batch path: every
   state carbonflex queried, replayed through ``KnowledgeBase.query_batch``;
   then the same states through the float64 CPU base, counting the slots
   whose ``m_t`` or ``rho`` would differ, and the whole scenario run on the
   CPU, counting the weekly results and slots that differ from the card's
   (information, not a gate); the main path again under one
   ``torch.profiler`` trace for the card's busy share; last, every queried
   state through ``KnowledgeBase.query`` and through the device-query
   protocol (query copied to the card, kernel, two copies back), equal,
   timed in turns, and a traced stretch of queries that must show one
   lookup kernel per call and no copy;
4. the serving path: llama3-8b at full width and depth (random weights
   from a seeded generator) prefills 4 prompts of 2048 tokens, attention
   through the Hopper flash kernel (32 launches, all on its route), then
   decodes 64 greedy tokens (no flash launch); layer 0's real q/k/v
   through the kernel against the plain version; each layer's attention
   through the kernel against the chunked attention on the chunked path's
   own q/k/v, and the logits so fed (the chained prefill logits of the two,
   and of two chunk sizes of the chunked attention, as information); then
   a warm timed run, the warm prefill in turns on the Hopper kernel and on
   the mma.sync kernel, and a traced run;
5. the DAG path: ``run(Scenario(dag=DagConfig(), engine="scan"))`` on the
   paper's 150-server cluster (one week of 5962 tasks and 5924 edges), the
   slot loop on the card and every slot's release (the in-degree decrement,
   the new in-degrees and the rows they free) through one launch of the
   release kernel ``dep_release_csr``, equal to the same scenario on the
   CPU's vector engine in every weekly result and every slot; the
   independent twin (no edges, no gating launch); then one full tile of 64
   dag-carbon cells (8 regions x 8 CI seeds) through ``simulate_many``,
   each equal to its CPU vector run, and one traced chunk of it for the
   card's busy share.  In phase 2 the gating kernel is held against its
   plain versions in both its modes, the decrement (``dep_decrement_csr``
   and the edge-list ``dep_decrement``, the reference's
   ``dep_decrement_pallas`` signature) and the release (also against the
   unfused sequence it replaces, the decrement and four eager ops), and
   the release is timed against that sequence in turns at B=1 and B=64 (at
   most half its time; one device kernel per call);
6. Algorithm 1 on the card: the kernel API path, ``kernels.ops.score_matrix``
   over the oracle's (job, scale) pair grid of each learning window and of
   the oracle policy's span on the rows kernel (launches counted by route),
   each equal to the plain version and the previous (flat) kernel exactly,
   then edge shapes (the columns route where T is no multiple of 4); at
   the first window's and the span's shapes the rows kernel and the flat
   kernel in turns by profiler device time (the rows kernel at most 0.7 of
   it), beside the floor; the main path again with ``backend="device"``, the
   learning phase, the weekly re-learning and the oracle policy through the
   greedy kernel (launches == ``solve`` attempts with entries), every
   weekly result and slot equal to the same call on the CPU, and the weeks
   and slots that differ from the ``backend="numpy"`` run counted, every
   pass (the 168-slot windows and the 552-slot spans) on the shared-memory
   walker ("smem") with alloc laid out by job window; then the kernel
   against ``greedy_pass_plain`` and the L2 walker ("l2") on every pass
   the path ran and on a ``solve`` that extends deadlines, bit for bit; the
   chain split: both walkers on three synthetic streams whose every entry
   stops at one test (done, consistency, capacity) and on learning window
   0, bit for bit, cycles per entry; learning window 0 and week 0's span on
   both walkers in turns (the smem walker at most half the l2 walker's
   time on each); times beside the host numpy pass.  Last, the main and
   oracle paths' wall, learning and execution times side by side.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch finds no CUDA device")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import numpy as np  # noqa: E402

from repro_torch.core import oracle as oracle_mod  # noqa: E402
from repro_torch.core import policy as policy_mod  # noqa: E402
from repro_torch.core.knowledge import KnowledgeBase  # noqa: E402
from repro_torch.core.profiles import amdahl_profile  # noqa: E402
from repro_torch.core.provisioning import provision  # noqa: E402
from repro_torch.core.types import Job  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import scan_engine  # noqa: E402
from repro_torch.core.carbon import CarbonService, REGIONS  # noqa: E402
from repro_torch.core.dag import DagCarbonPolicy  # noqa: E402
from repro_torch.core.simulator import SimCase, pack, simulate_many  # noqa: E402
from repro_torch.experiment import DEFAULT_DAG_POLICIES, Scenario, run  # noqa: E402
from repro_torch.experiment.scenario import CI_MARGIN_HOURS, WEEK  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import gating, knn, ops, oracle_greedy, score  # noqa: E402
from repro_torch.models import init_params, transformer  # noqa: E402
from repro_torch.models.common import chunked_attention, rms_norm, rope  # noqa: E402
from repro_torch.serve import greedy_generate, make_prefill  # noqa: E402
from repro_torch.traces import DagConfig  # noqa: E402

# Published peaks of one H100 SXM at its full 700 W limit (NVIDIA's data
# sheet): HBM3 bandwidth, fp32 outside the tensor cores, bf16 dense on the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

MAIN = dict(region="south-australia", capacity=40, learn_weeks=3, seed=1,
            eval_weeks=6)
POLICIES = ["carbon-agnostic", "wait-awhile", "carbonflex", "oracle"]
D, K = 13, 5
RTOL = ATOL = 1e-5


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 20) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls, from
    CUDA events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_events(prof):
    """The device-side events of a ``torch.profiler`` trace: kernels,
    copies and sets on the card (CPU ops, which also report the time of the
    kernels they launch, are left out so nothing counts twice)."""
    from torch.autograd import DeviceType

    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def busy_us(events) -> float:
    """Microseconds in which at least one of ``events`` ran on the card."""
    total, end = 0.0, -math.inf
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in events):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def device_ms(fn, iters: int = 200) -> float | None:
    """Mean device milliseconds per call: the card's busy time that
    ``torch.profiler`` records over ``iters`` calls (None when the profiler
    records no device time)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = busy_us(device_events(prof))
    return total_us / iters / 1e3 if total_us > 0 else None


def in_turns(runs, rounds: int = 2) -> dict:
    """``device_ms`` of each function of ``runs`` in turns, there and back
    (a, b, b, a, ...) ``rounds`` times: per key the list of its turns.  A
    turn whose trace holds no device time is taken again (at most twice)."""
    turns = {key: [] for key in runs}
    for _ in range(rounds):
        for key in list(runs) + list(runs)[::-1]:
            ms = None
            for _ in range(3):
                ms = device_ms(runs[key])
                if ms is not None:
                    break
            if ms is None:
                raise AssertionError(f"{key}: the profiler recorded no device time")
            turns[key].append(ms)
    return turns


def bound_ms(nbytes: float, flops: float,
             flop_per_s: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_topk(dist, idx, dist_ref, idx_ref, cases, queries, what):
    """Distances within RTOL/ATOL; indices equal up to exact ties (the two
    neighbours' float64 distances agree)."""
    d, dr = dist.cpu().numpy(), dist_ref.cpu().numpy()
    i, ir = idx.cpu().numpy(), idx_ref.cpu().numpy()
    if not np.allclose(d, dr, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{what}: distances differ by up to "
                             f"{np.max(np.abs(d - dr))}")
    c64 = cases.double().cpu().numpy()
    q64 = np.atleast_2d(queries.double().cpu().numpy())
    i2, ir2 = np.atleast_2d(i), np.atleast_2d(ir)
    for r, j in zip(*np.nonzero(i2 != ir2)):
        a = np.linalg.norm(c64[i2[r, j]] - q64[r])
        b = np.linalg.norm(c64[ir2[r, j]] - q64[r])
        if not np.isclose(a, b, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"{what}: neighbour {j} of query {r} is "
                                 f"{i2[r, j]}, plain version says {ir2[r, j]}")
    return float(np.max(np.abs(d - dr)))


def kernel_phase(report):
    """Phase 2: kernels against plain versions; times at the main path's
    shapes (one query against the full 1344-case base, through the
    per-slot lookup; one week of 168 slot states as a batch, the cluster
    kernel and the previous warp kernel in turns, ratio at most 0.5)."""
    torch.backends.cuda.matmul.allow_tf32 = False      # plain batch in fp32
    gen = np.random.default_rng(0)
    dev = torch.device("cuda")

    def inputs(n, q=None):
        cases = torch.from_numpy(gen.normal(size=(n, D)).astype(np.float32)).to(dev)
        shape = (D,) if q is None else (q, D)
        return cases, torch.from_numpy(gen.normal(size=shape).astype(np.float32)).to(dev)

    err1 = 0.0
    for n in (1, 255, 257, 1344, 4099):           # 4099: the two-pass merge
        k = min(K, n)
        cases, q = inputs(n)
        if n > 8:                                  # a tie of four
            cases[[n // 3, n // 2, n - 1]] = cases[1].clone()
        dist, idx = knn.knn_topk(cases, q, k)
        torch.cuda.synchronize()
        err1 = max(err1, check_topk(dist, idx, *knn.knn_topk_plain(cases, q, k),
                                    cases, q, f"knn_topk N={n}"))
        ld, li = knn.knn_lookup(cases, q.cpu().numpy(), k)
        if not (np.array_equal(ld, dist.double().cpu().numpy())
                and np.array_equal(li, idx.cpu().numpy())):
            raise AssertionError(f"knn_lookup N={n}: differs from knn_topk on a device query")
        log(f"knn_topk     N={n:5d} D={D} k={k}: agrees with the plain version; "
            f"knn_lookup (host query and record) equal to it bit for bit")
    err2 = 0.0
    for nq in (168, 1344):
        cases, qs = inputs(1344, nq)
        dist, idx = knn.knn_topk_batch(cases, qs, K)
        prev = knn.knn_topk_batch(cases, qs, K, route="warp")
        torch.cuda.synchronize()
        err2 = max(err2, check_topk(dist, idx, *knn.knn_topk_batch_plain(cases, qs, K),
                                    cases, qs, f"knn_topk_batch Q={nq}"))
        if not (torch.equal(dist, prev[0]) and torch.equal(idx, prev[1])):
            raise AssertionError(f"knn_topk_batch Q={nq}: the cluster and warp routes differ")
        log(f"knn_topk_batch Q={nq:4d} N=1344 D={D} k={K}: agrees with the plain version; "
            f"the cluster kernel ({knn.batch_plan(1344, D, nq, K)}) equal bit for bit to "
            "the previous (warp) kernel")

    cases, q = inputs(1344)
    n = cases.shape[0]
    qh = q.cpu().numpy().astype(np.float64)
    t1 = dict(
        ms=time_ms(lambda: knn.knn_lookup(cases, qh, K), 2000),
        device_query_ms=time_ms(lambda: knn.knn_topk(cases, q, K), 2000),
        plain_ms=time_ms(lambda: knn.knn_topk_plain(cases, q, K), 2000),
        library_ms=time_ms(lambda: torch.topk(torch.cdist(q[None], cases)[0], K,
                                              largest=False), 2000))
    b1, by1 = bound_ms(4 * (n * D + D) + K * 12, 3 * n * D)
    _, qs = inputs(1344, 168)
    t2 = dict(
        ms=time_ms(lambda: knn.knn_topk_batch(cases, qs, K), 500),
        previous_ms=time_ms(lambda: knn.knn_topk_batch(cases, qs, K, route="warp"), 500),
        plain_ms=time_ms(lambda: knn.knn_topk_batch_plain(cases, qs, K), 500),
        library_ms=time_ms(lambda: torch.topk(torch.cdist(qs, cases), K, dim=1,
                                              largest=False), 500))
    b2, by2 = bound_ms(4 * (n * D + 168 * D) + 168 * K * 12, 3 * 168 * n * D)
    t1.update(device_ms=device_ms(lambda: knn.knn_lookup(cases, qh, K)),
              plain_device_ms=device_ms(lambda: knn.knn_topk_plain(cases, q, K)),
              library_device_ms=device_ms(lambda: torch.topk(
                  torch.cdist(q[None], cases)[0], K, largest=False)))
    # The cluster kernel against the previous (warp) kernel in turns, each
    # turn the mean device time of 200 calls; the floor: an empty kernel
    # launched as the cluster kernel is.
    pl = knn.batch_plan(n, D, 168, K)
    stream = torch.cuda.current_stream().cuda_stream
    turns = in_turns(dict(device_ms=lambda: knn.knn_topk_batch(cases, qs, K),
                          previous_device_ms=lambda: knn.knn_topk_batch(cases, qs, K,
                                                                        route="warp")))
    t2.update({key: float(np.mean(v)) for key, v in turns.items()}, turns=turns,
              floor_device_ms=device_ms(lambda: knn._lib.knn_batch_floor(
                  pl["blocks"], pl["threads"], pl["slices"], pl["smem"], stream)),
              plain_device_ms=device_ms(lambda: knn.knn_topk_batch_plain(cases, qs, K)),
              library_device_ms=device_ms(lambda: torch.topk(
                  torch.cdist(qs, cases), K, dim=1, largest=False)))
    t2.update(ratio=t2["device_ms"] / t2["previous_device_ms"],
              bound_share=b2 / t2["device_ms"])
    log(f"knn_topk: knn_lookup {t1['ms']:.6f} ms/call back to back (each waits for "
        f"its stream), knn_topk on a device query {t1['device_query_ms']:.6f}")
    for name, t, b in (("knn_topk", t1, b1), ("knn_topk_batch", t2, b2)):
        log(f"{name}: {t['ms']:.6f} ms/call (plain {t['plain_ms']:.6f}, "
            f"cdist+topk {t['library_ms']:.6f}, bound {b:.9f}); device time "
            f"{t['device_ms']} ms/call (plain {t['plain_device_ms']}, "
            f"cdist+topk {t['library_device_ms']})")
    ptx = {name: rep for name, rep in ptxas_report(report, "knn_query_kernel").items()
           if "ILi5ELi13E" in name}            # the main path's k = 5, D = 13
    ptx2 = {name: rep for name, rep in ptxas_report(report, "knn_cluster_kernel").items()
            if "ILi5ELi13E" in name}
    log(f"knn_query_kernel<5, 13>, ptxas: {ptx}")
    log(f"knn_topk_batch Q=168 N={n}: cluster kernel {pl}, ptxas {ptx2}; device time in "
        f"turns {t2['device_ms']:.6f} against the warp kernel's {t2['previous_device_ms']:.6f} "
        f"ms/call, ratio {t2['ratio']:.4f} ({turns}); events {t2['ms']:.6f} against "
        f"{t2['previous_ms']:.6f}; the floor (an empty kernel launched the same way) "
        f"{t2['floor_device_ms']} ms; {t2['bound_share']:.6f} of the bound {b2:.9f} ({by2})")
    if not t2["ratio"] <= 0.5:
        raise AssertionError(f"knn_topk_batch: the cluster kernel takes {t2['device_ms']} ms, "
                             f"more than half the warp kernel's {t2['previous_device_ms']}")
    return [
        dict(name="knn_topk", route="cuda", source="src/repro_torch/csrc/knn.cu",
             kernel="knn_query_kernel<5, 13> via knn_lookup", ptxas=ptx,
             replaces="src/repro/kernels/knn.py:64", max_abs_err=err1,
             bound_ms=b1, bound_by=by1, shape=f"N={n} D={D} k={K}", **t1),
        dict(name="knn_topk_batch", route="cuda", source="src/repro_torch/csrc/knn.cu",
             kernel="knn_cluster_kernel<5, 13>", plan=pl, ptxas=ptx2,
             replaces="src/repro/kernels/knn.py:115", max_abs_err=err2,
             bound_ms=b2, bound_by=by2, shape=f"Q=168 N={n} D={D} k={K}", **t2),
    ]


def main_path_phase():
    """Phase 3: the single-region loop through ``run()`` on the card."""
    calls = []
    spent = [0.0]                       # host seconds inside provision()

    def counted(state, kb, capacity, current_m, violation_rate, cfg,
                min_required=0):
        t = time.perf_counter()
        out = provision(state, kb, capacity, current_m, violation_rate, cfg,
                        min_required=min_required)
        spent[0] += time.perf_counter() - t
        calls.append(dict(state=state, windows=list(kb._windows), kb=kb,
                          args=(capacity, current_m, violation_rate, cfg,
                                min_required), out=out))
        return out

    policy_mod.provision = counted
    knn.reset_launches()
    t = time.perf_counter()
    res = run(Scenario(**MAIN), POLICIES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    main_launches = dict(knn.launches)
    policy_mod.provision = provision

    kb = calls[-1]["kb"]
    log(f"main path: {wall:.3f} s wall (learning {res.learn_s:.3f} s, "
        f"execution {res.execute_s:.3f} s, of which provisioning "
        f"{spent[0]:.3f} s), knowledge base {res.kb_size} cases "
        f"on {kb.case_matrix().device}")
    log(res.table())
    if kb.case_matrix().device.type != "cuda":
        raise AssertionError("the knowledge base is not on the card")
    if main_launches["knn_topk"] != len(calls) or not calls:
        raise AssertionError(f"knn_topk launched {main_launches['knn_topk']} "
                             f"times for {len(calls)} provision calls")
    slots = sum(len(r.slots) for r in res.weekly["carbonflex"])
    if len(calls) != slots or slots < 168 * MAIN["eval_weeks"]:
        raise AssertionError(f"{len(calls)} provision calls for {slots} slots")
    log(f"knn_topk launches {main_launches['knn_topk']} == provision calls "
        f"{len(calls)} ({slots} carbonflex slots)")
    for name in POLICIES:
        weeks = res.weekly[name]
        if len(weeks) != MAIN["eval_weeks"]:
            raise AssertionError(f"{name}: {len(weeks)} evaluated weeks")
        for r in weeks:
            if not (math.isfinite(r.carbon_g) and r.carbon_g > 0
                    and math.isfinite(r.energy_kwh) and r.energy_kwh > 0):
                raise AssertionError(f"{name}: non-finite or empty accounting")
            if not all(0 <= s.used <= s.provisioned <= MAIN["capacity"]
                       for s in r.slots):
                raise AssertionError(f"{name}: allocation above provisioning")
    if res.savings("oracle") <= 0:
        raise AssertionError("the oracle saves nothing against carbon-agnostic")

    # The batch path: each week's queried states through query_batch of the
    # base that answered them.  Both kernels add the same fmaf chain in the
    # same order, so the neighbours and distances must be identical.
    groups = {}
    for c in calls:
        groups.setdefault(tuple(id(w[0]) for w in c["windows"]), []).append(c)
    bases = [(KnowledgeBase.from_windows(g[0]["windows"], device="cuda"),
              np.stack([c["state"] for c in g]), g) for g in groups.values()]
    knn.reset_launches()
    t = time.perf_counter()
    batched = [b.query_batch(states) for b, states, _ in bases]
    torch.cuda.synchronize()
    batch_wall = time.perf_counter() - t
    batch_launches = dict(knn.launches)
    if batch_launches != {"knn_topk": 0, "knn_topk_batch": len(bases), "cluster": len(bases),
                          "warp": 0}:
        raise AssertionError(f"batch path launches {batch_launches}")
    for (b, states, _), (m, r, d) in zip(bases, batched):
        for i, s in enumerate(states):
            m1, r1, d1 = b.query(s)
            if not (np.array_equal(m1, m[i]) and np.array_equal(r1, r[i])
                    and np.array_equal(d1, d[i])):
                raise AssertionError("query_batch and query disagree on a state")
    log(f"batch path: {len(calls)} states in {len(bases)} query_batch calls "
        f"(launches {batch_launches}; Q x N {[(len(st), len(b)) for b, st, _ in bases]}), "
        f"{batch_wall:.3f} s wall; identical to the per-slot queries")

    # float32 on the card against the float64 CPU base: decision flips
    # (m_t), and scheduling thresholds (rho) more than the scheduler's 1e-9
    # tolerance apart (a weighted mean of differing neighbour rhos moves
    # with the float32 distances; it changes an allocation only where it
    # crosses a job's marginal throughput).
    flips = rho_moves = 0
    for _, _, g in bases:
        cpu = KnowledgeBase.from_windows(g[0]["windows"], device="cpu")
        for c in g:
            capacity, current_m, v, cfg, min_required = c["args"]
            m, rho = provision(c["state"], cpu, capacity, current_m, v, cfg,
                               min_required=min_required)
            flips += m != c["out"][0]
            rho_moves += abs(rho - c["out"][1]) > 1e-9
    log(f"float64 CPU replay: {flips} of {len(calls)} slots would take a "
        f"different m_t, {rho_moves} a rho more than 1e-9 away")

    # The whole scenario on the CPU (float64 base, host only): which weekly
    # results and which slots' provisioned/used differ from the card's run.
    t = time.perf_counter()
    cpu_res = run(Scenario(**MAIN), POLICIES, device="cpu")
    cpu_wall = time.perf_counter() - t
    weeks_differ = slots_differ = 0
    for name in POLICIES:
        for a, b in zip(res.weekly[name], cpu_res.weekly[name], strict=True):
            weeks_differ += not (
                a.carbon_g == b.carbon_g and a.energy_kwh == b.energy_kwh
                and np.array_equal(a.violations, b.violations)
                and np.array_equal(a.wait_slots, b.wait_slots))
            slots_differ += abs(len(a.slots) - len(b.slots)) + sum(
                (x.provisioned, x.used) != (y.provisioned, y.used)
                for x, y in zip(a.slots, b.slots))
    log(f"CPU run of the same scenario ({cpu_wall:.3f} s wall): "
        f"{weeks_differ} of {len(POLICIES) * MAIN['eval_weeks']} weekly results "
        f"and {slots_differ} slots' provisioned/used differ from the card's run")
    log(cpu_res.table())

    # The card's share of the main path: the same run again under one
    # profiler trace (the counted run above stays untraced, so its wall
    # times carry no profiler cost).
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        traced = run(Scenario(**MAIN), POLICIES)
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t
    if any(traced.savings(n) != res.savings(n) for n in POLICIES):
        raise AssertionError("the traced run's savings differ from the first run's")
    events = device_events(prof)
    if not events:
        raise AssertionError("the profiler recorded no device time on the main path")
    busy_ms = busy_us(events) / 1e3
    per_name = {}
    for e in events:
        per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    log(f"traced main path: {traced_wall:.3f} s wall under the profiler, card "
        f"busy {busy_ms:.6f} ms = {100 * busy_ms / 1e3 / traced_wall:.6f} % of it, "
        f"{100 * busy_ms / 1e3 / wall:.6f} % of the untraced run's wall")
    for name, ms in sorted(per_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"  device {ms:.6f} ms  {name}")
    lookup = knn_query_phase(kb, [c["state"] for c in calls])
    return dict(result=res, main=main_launches, batch=batch_launches, flips=flips,
                lookup=lookup,
                rho_moves=rho_moves,
                provisions=len(calls), wall_s=wall, learn_s=res.learn_s,
                execute_s=res.execute_s, provision_s=spent[0],
                batch_wall_s=batch_wall,
                kb_size=res.kb_size,
                savings={n: res.savings(n) for n in POLICIES},
                cpu_wall_s=cpu_wall, cpu_weeks_differ=weeks_differ,
                cpu_slots_differ=slots_differ,
                cpu_savings={n: cpu_res.savings(n) for n in POLICIES},
                traced_wall_s=traced_wall, device_busy_ms=busy_ms,
                device_busy_share=busy_ms / 1e3 / wall)

def copy_query(kb, state):
    """``KnowledgeBase.query`` built from the public kernel wrapper on
    device tensors (the device-query protocol): the query copied to the
    card, ``knn_topk``, the indices and the float64 distances copied back
    in turn."""
    k, q = kb._prepare(state, None)
    dist, idx = knn.knn_topk(kb.case_matrix(), torch.as_tensor(q, dtype=torch.float32)
                             .to(kb.device), k)
    idx = idx.cpu().numpy()
    return kb._Y[idx, 0], kb._Y[idx, 1], dist.double().cpu().numpy()


def knn_query_phase(kb, states):
    """The per-slot lookup on the main path's last base (1344 cases): every
    state carbonflex queried, through ``KnowledgeBase.query`` and through
    the device-query protocol, equal; host time per call of each in turns
    (new, old, old, new, twice); and one traced stretch of queries, whose
    device events must be one lookup kernel per call and no copy."""
    for s in states:
        a, b = kb.query(s), copy_query(kb, s)
        if not all(np.array_equal(x, y) for x, y in zip(a, b)):
            raise AssertionError("KnowledgeBase.query and the device-query protocol differ")

    def loop(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for s in states:
            fn(kb, s)
        return 1e6 * (time.perf_counter() - t) / len(states)

    runs = {"query_us": KnowledgeBase.query, "copy_us": copy_query}
    turns = {key: [] for key in runs}
    for key in ("query_us", "copy_us", "copy_us", "query_us") * 2:
        turns[key].append(loop(runs[key]))
    t = {key: float(np.mean(v)) for key, v in turns.items()}
    from torch.profiler import ProfilerActivity, profile

    traced = states[:200]
    knn.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for s in traced:
            kb.query(s)
    events = device_events(prof)
    kinds = {}
    for e in events:
        kind = "knn_query_kernel" if "knn_query_kernel" in e.name else \
            "copy" if "memcpy" in e.name.lower() or "memset" in e.name.lower() else e.name
        kinds[kind] = kinds.get(kind, 0) + 1
    log(f"KnowledgeBase.query on {len(kb)} cases, {len(states)} states: {t['query_us']:.3f} "
        f"us per call against {t['copy_us']:.3f} for the device-query protocol, ratio "
        f"{t['query_us'] / t['copy_us']:.4f} (in turns {turns}); equal results; "
        f"{len(traced)} traced calls: device events {kinds}, launches {dict(knn.launches)}")
    # The launches count each call's kernel; the trace (which may drop an
    # event) must hold that kernel and nothing else: no copy either way.
    if set(kinds) != {"knn_query_kernel"} or knn.launches["knn_topk"] != len(traced):
        raise AssertionError(f"KnowledgeBase.query: {kinds} on the card for {len(traced)} "
                             "calls; expected one lookup kernel each and no copy")
    return dict(turns=turns, ratio=t["query_us"] / t["copy_us"], traced_events=kinds, **t)


# --- flash attention and the serving path ------------------------------------

SERVE_ARCH = "llama3-8b"
SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS = 4, 2048, 64
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}
# Relative L2 of the whole output against the plain version.  At these key
# counts unit-normal inputs give outputs of std ~sqrt(e/Sk) = 0.04, below
# the bf16 atol, so the elementwise test alone would pass a kernel whose
# outputs were all 30 % too small; bf16 rounding of P and of the output
# leaves a few 1e-3.
FLASH_REL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
# The same, for each layer's attention output on the model's own q/k/v
# against the chunked attention: near one-hot softmax under the reference
# init leaves ~2e-4 (1.5e-4 median over llama3-8b's 32 layers on an H100).
ATTN_REL = 1e-3
# (name, B, Sq, Sk, Hq, Hkv, D, causal_offset): the prefill's shape first
FLASH_SHAPES = [
    ("prefill", 4, 2048, 2048, 32, 8, 128, 0),
    ("decode-like", 4, 1, 2112, 32, 8, 128, 2111),
    ("ragged", 2, 130, 330, 8, 2, 64, 200),
    ("multi-head", 2, 300, 300, 4, 4, 32, 0),
]


def flash_work(b, sq, sk, hq, hkv, d, offset, elt):
    """(bytes, FLOPs) of one call: q, k, v read once and the output
    written once; 4·D FLOPs per unmasked (query row, key) pair per head."""
    pairs = sum(min(sk, offset + r + 1) for r in range(sq))
    nbytes = elt * (2 * b * sq * hq * d + 2 * b * sk * hkv * d)
    return nbytes, 4.0 * b * hq * d * pairs


def flash_inputs(gen, b, sq, sk, hq, hkv, d, dtype):
    """Unit-normal q, k, v from numpy (the model's own are nearly one-hot
    after the reference init, so they would not test the spread case)."""
    def one(n, h):
        return torch.from_numpy(gen.normal(size=(b, n, h, d)).astype(np.float32)) \
            .to("cuda", dtype)
    return one(sq, hq), one(sk, hkv), one(sk, hkv)


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()


def flash_check(q, k, v, offset, what, kernel=None):
    """The kernel (``gqa_flash``'s route, or the one named) against its
    plain version on the same inputs: elementwise within FLASH_TOL and, as a
    whole, within FLASH_REL relative L2.  Returns (max abs difference,
    relative L2)."""
    out = fa.gqa_flash(q, k, v, causal_offset=offset) if kernel is None \
        else fa.launch(q, k, v, offset, kernel)
    torch.cuda.synchronize()
    want = fa.gqa_flash_plain(q, k, v, causal_offset=offset)
    tol = FLASH_TOL[q.dtype]
    if out.shape != want.shape or out.dtype != q.dtype \
            or not torch.isfinite(out.float()).all():
        raise AssertionError(f"{what}: bad output {tuple(out.shape)} {out.dtype}")
    err = (out.float() - want.float()).abs().max().item()
    rel = rel_l2(out, want)
    if not torch.allclose(out.float(), want.float(), rtol=tol, atol=tol) \
            or not rel <= FLASH_REL[q.dtype]:
        raise AssertionError(f"{what}: kernel and plain version differ by up to "
                             f"{err}, relative L2 {rel}")
    return err, rel


def ptxas_report(report, kernel):
    """Registers, static shared memory and spill bytes that ptxas gave each
    instantiation of ``kernel``, and its performance remarks."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            if name:
                out.setdefault(name, dict(remarks=[]))
            continue
        m = re.search(r"\((C75\d\d)\).*'(\S+)'", line)
        if m and kernel in m.group(2):
            out.setdefault(m.group(2), dict(remarks=[]))["remarks"].append(m.group(1))
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            s = re.search(r"(\d+) bytes smem", line)
            out[name].update(registers=int(m.group(1)),
                             static_smem=int(s.group(1)) if s else 0)
    return out


def flash_kernel_phase(report):
    """Phase 2 for ``gqa_flash``: every check shape in fp32 and bf16 against
    the plain version, each on its route's kernel, and the prefill's shape
    also on the retained mma.sync kernel; then, at the prefill's shape in
    bf16 and in turns, the Hopper kernel, the mma.sync kernel, the plain
    version and SDPA, by CUDA events and by profiler device time."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = np.random.default_rng(1)
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    rels = {torch.float32: 0.0, torch.bfloat16: 0.0}
    fa.reset_launches()
    expect = {"gqa_flash": 0, "wgmma": 0, "mma_sync": 0, "fp32": 0}
    for name, b, sq, sk, hq, hkv, d, off in FLASH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(gen, b, sq, sk, hq, hkv, d, dtype)
            kernels = [None] + (["mma_sync"] if name == "prefill" and dtype == torch.bfloat16
                                else [])
            for kern in kernels:
                e, r = flash_check(q, k, v, off, f"gqa_flash {name} {dtype} {kern}", kern)
                route = kern or ("fp32" if dtype == torch.float32
                                 else "wgmma" if d in (64, 128) else "mma_sync")
                expect["gqa_flash"] += 1
                expect[route] += 1
                err[dtype], rels[dtype] = max(err[dtype], e), max(rels[dtype], r)
                log(f"gqa_flash {name:11s} B={b} Sq={sq} Sk={sk} Hq={hq} Hkv={hkv} "
                    f"D={d} offset={off} {str(dtype)[6:]} on {route}: agrees with the "
                    f"plain version (max abs diff {e}, relative L2 {r}, limit "
                    f"{FLASH_REL[dtype]})")
    if fa.launches != expect:
        raise AssertionError(f"flash launches by route {fa.launches}, expected {expect}")

    ptx = ptxas_report(report, "flash_wgmma_kernel")
    for name, rep in ptx.items():
        d = 128 if "ILi128E" in name else 64
        log(f"flash_wgmma_kernel<{d}>: ptxas {rep}, dynamic shared memory "
            f"{fa.wgmma_smem_bytes(d)} bytes, {fa.wgmma_stages(d)} stages")
    if not ptx:
        log("flash_wgmma_kernel: no ptxas report (the library was built before this run)")

    _, b, sq, sk, hq, hkv, d, off = FLASH_SHAPES[0]
    q, k, v = flash_inputs(gen, b, sq, sk, hq, hkv, d, torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def kernel():
        return fa.launch(q, k, v, off, "wgmma")

    def previous():
        return fa.launch(q, k, v, off, "mma_sync")

    def plain():
        return fa.gqa_flash_plain(q, k, v)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    lib_diff = (library().transpose(1, 2).float() - kernel().float()).abs().max().item()
    # In turns, there and back: Hopper, mma.sync, plain, SDPA, SDPA, ...
    runs = dict(ms=(kernel, 50, 5), previous_ms=(previous, 50, 5),
                plain_ms=(plain, 10, 3), library_ms=(library, 50, 5))
    turns = {key: [] for key in runs}
    for key in list(runs) + list(runs)[::-1]:
        fn, iters, warmup = runs[key]
        turns[key].append(time_ms(fn, iters, warmup=warmup))
    t = {key: float(np.mean(v)) for key, v in turns.items()}
    t.update(device_ms=device_ms(kernel, 20), previous_device_ms=device_ms(previous, 20),
             plain_device_ms=device_ms(plain, 10), library_device_ms=device_ms(library, 20))
    nbytes, flops = flash_work(b, sq, sk, hq, hkv, d, off, 2)
    bound, by = bound_ms(nbytes, flops, BF16_FLOP_PER_S)
    log(f"gqa_flash prefill shape bf16, in turns {turns}")
    log(f"gqa_flash prefill shape bf16: Hopper kernel {t['ms']:.6f} ms/call "
        f"({flops / t['ms'] / 1e9:.3f} TFLOP/s, {bound / t['ms']:.4f} of the bound), "
        f"mma.sync kernel {t['previous_ms']:.6f} ({t['ms'] / t['previous_ms']:.4f} of it), "
        f"plain {t['plain_ms']:.6f}, SDPA {t['library_ms']:.6f}, bound {bound:.6f} by "
        f"{by}: {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB; device time "
        f"{t['device_ms']} ms/call (mma.sync {t['previous_device_ms']}, plain "
        f"{t['plain_device_ms']}, SDPA {t['library_device_ms']}); SDPA differs from the "
        f"kernel by up to {lib_diff}")
    if not t["ms"] <= 0.5 * t["previous_ms"]:
        raise AssertionError(f"the Hopper kernel takes {t['ms']} ms, more than half "
                             f"the mma.sync kernel's {t['previous_ms']} ms")
    return dict(name="gqa_flash", route="cuda", kernel="flash_wgmma_kernel",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:94",
                max_abs_err=err[torch.bfloat16], max_abs_err_f32=err[torch.float32],
                rel_l2=rels[torch.bfloat16], rel_l2_f32=rels[torch.float32],
                bound_ms=bound, bound_by=by, tflops=flops / t["ms"] / 1e9,
                bound_share=bound / t["ms"],
                shape=f"B={b} Sq={sq} Sk={sk} Hq={hq} Hkv={hkv} D={d} bf16 causal",
                sdpa_max_abs_diff=lib_diff, ptxas=ptx, turns=turns, **t)


def teacher_forced(params, prompts, cfg, chunked):
    """Layer by layer on the chunked model's input to each layer: the
    relative L2 of the kernel's attention output against the chunked
    attention's on that layer's own q/k/v, and of the last-position logits
    of the flash model's last layer so fed against the chunked model's."""
    lp = params["layers"]
    x = params["embed"][prompts]
    pos = torch.arange(x.shape[1], device=x.device)
    rels = []
    for li in range(cfg.num_layers):
        h = rms_norm(x, lp["ln1"][li], cfg.norm_eps)
        q, k, v = transformer.qkv(h, lp, li)
        q, k = rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta)
        rels.append(rel_l2(fa.gqa_flash(q, k, v),
                           chunked_attention(q, k, v, 0, chunked.attention_chunk)))
        del h, q, k, v
        if li == cfg.num_layers - 1:
            got, _ = transformer.decoder_layer(x, lp, li, cfg, pos)
        x, _ = transformer.decoder_layer(x, lp, li, chunked, pos)

    def logits(h):
        return rms_norm(h[:, -1], params["ln_f"], cfg.norm_eps) \
            @ transformer.output_head(params)

    return rels, rel_l2(logits(got), logits(x))


def serve_phase():
    """Phase 4: llama3-8b served at full width through
    ``repro_torch.serve.greedy_generate`` (what ``python -m repro_torch.serve``
    runs), launch counts reset just before and read just after."""
    cfg = ARCHS[SERVE_ARCH]
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = sum(x.numel() for x in torch.utils._pytree.tree_leaves(params))
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT))).to("cuda")
    log(f"serve: {cfg.name} {cfg.num_layers} layers d={cfg.d_model} "
        f"{n_params} parameters initialised in {init_s:.3f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.3f} GiB on the card)")

    captured = []
    kernel = fa.gqa_flash

    def capture(q, k, v, causal_offset=0):
        if not captured:
            captured.append((q, k, v, causal_offset))
        return kernel(q, k, v, causal_offset=causal_offset)

    fa.gqa_flash = capture
    fa.reset_launches()
    knn.reset_launches()
    try:
        out = greedy_generate(params, prompts, cfg, SERVE_TOKENS)
    finally:
        fa.gqa_flash = kernel
    launches = dict(fa.launches)
    prefill_n, decode_n = out["prefill_flash_launches"], out["decode_flash_launches"]
    peak = torch.cuda.max_memory_allocated()
    log(f"serve: prefill {out['prefill_s']:.6f} s, decode {out['decode_s']:.6f} s "
        f"({SERVE_BATCH * SERVE_TOKENS / out['decode_s']:.3f} tok/s), gqa_flash "
        f"launches {prefill_n} in prefill + {decode_n} in decode, peak "
        f"{peak / 2**30:.3f} GiB")
    if (prefill_n, decode_n) != (cfg.num_layers, 0) \
            or launches["gqa_flash"] != cfg.num_layers \
            or launches["wgmma"] != cfg.num_layers:
        raise AssertionError(f"gqa_flash launched {prefill_n} times in prefill and "
                             f"{decode_n} in decode ({launches}); expected "
                             f"{cfg.num_layers} and 0, all on the Hopper kernel")
    cache, toks = out["cache"], out["tokens"]
    max_seq = SERVE_PROMPT + SERVE_TOKENS
    if cache["length"] != max_seq or cache["k"].shape != (
            cfg.num_layers, SERVE_BATCH, max_seq, cfg.num_kv_heads,
            cfg.resolved_head_dim):
        raise AssertionError(f"cache length {cache['length']}, shape "
                             f"{tuple(cache['k'].shape)}")
    for name in ("prefill_logits", "last_logits"):
        x = out[name]
        if x.shape != (SERVE_BATCH, cfg.vocab_size) or not torch.isfinite(x).all():
            raise AssertionError(f"{name}: shape {tuple(x.shape)} or non-finite")
    if toks.shape != (SERVE_BATCH, SERVE_TOKENS) or toks.min() < 0 \
            or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"generated ids out of range: {toks.min()}..{toks.max()}")

    # Layer 0's real q/k/v through the kernel against the plain version.
    q, k, v, off = captured[0]
    layer0_err, layer0_rel = flash_check(q, k, v, off, "gqa_flash on layer 0's q/k/v")
    log(f"serve: layer 0's q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)}: kernel "
        f"agrees with the plain version (max abs diff {layer0_err}, relative L2 "
        f"{layer0_rel})")
    del captured[:], q, k, v

    # The flash path against the chunked path on the same weights.  Chained
    # through 32 layers the two diverge whatever the kernel: the reference
    # init makes scores of std ~1e2, so a rounding difference in one layer
    # flips near-tied softmax choices in the next (two chunk sizes of the
    # same chunked attention diverge as far; both printed as information).
    # The gate holds each layer's attention output, on the chunked path's
    # own input to that layer, and the logits from the last layer so fed.
    first_flash = out["prefill_logits"].float()
    gen_flash = toks.cpu()
    first_run = dict(prefill_s=out["prefill_s"], decode_s=out["decode_s"],
                     tokens_per_s=SERVE_BATCH * SERVE_TOKENS / out["decode_s"])
    del out, cache, toks
    chunked = dataclasses.replace(cfg, attention_backend="chunked")
    t = time.perf_counter()
    logits_c, cache_c = make_prefill(chunked, max_seq)(params, prompts)
    torch.cuda.synchronize()
    chunked_s = time.perf_counter() - t
    del cache_c
    half_chunk = dataclasses.replace(chunked, attention_chunk=chunked.attention_chunk // 2)
    logits_h, cache_h = make_prefill(half_chunk, max_seq)(params, prompts)
    del cache_h
    chained = rel_l2(first_flash, logits_c)
    chained_chunks = rel_l2(logits_h, logits_c)
    agree = int((first_flash.argmax(-1) == logits_c.argmax(-1)).sum().item())
    log(f"serve: chained prefill logits, flash vs chunked: relative L2 {chained}, "
        f"first greedy token agrees on {agree} of {SERVE_BATCH} sequences; chunk "
        f"{half_chunk.attention_chunk} vs {chunked.attention_chunk} of the chunked "
        f"attention: relative L2 {chained_chunks}; chunked prefill {chunked_s:.6f} s")
    attn_rel, forced = teacher_forced(params, prompts, cfg, chunked)
    log(f"serve: each layer's attention on the chunked path's input, kernel vs "
        f"chunked attention: relative L2 max {max(attn_rel)} (layer "
        f"{int(np.argmax(attn_rel))}), median {float(np.median(attn_rel))} (limit "
        f"{ATTN_REL}); last-position logits so fed {forced} (limit 2e-2)")
    if not (max(attn_rel) <= ATTN_REL and forced <= 2e-2):
        raise AssertionError(f"flash vs chunked: attention relative L2 up to "
                             f"{max(attn_rel)}, logits {forced}")

    # A warm run for the times, then a traced one for the device's share.
    warm = greedy_generate(params, prompts, cfg, SERVE_TOKENS)
    same = torch.equal(warm["tokens"].cpu(), gen_flash)
    warm_run = dict(prefill_s=warm["prefill_s"], decode_s=warm["decode_s"],
                    tokens_per_s=SERVE_BATCH * SERVE_TOKENS / warm["decode_s"])
    log(f"serve, warm run: prefill {warm_run['prefill_s']:.6f} s, decode "
        f"{warm_run['decode_s']:.6f} s ({warm_run['tokens_per_s']:.3f} tok/s); "
        f"same tokens as the first run: {same}")
    del warm

    # What the Hopper kernel saves end to end: the warm prefill with its
    # attention on its route and on the retained mma.sync kernel, in turns
    # (there and back, twice).
    def mma_sync(q, k, v, causal_offset=0):
        return fa.launch(q, k, v, causal_offset, "mma_sync")

    prefill = make_prefill(cfg, max_seq)
    paired = {"wgmma": [], "mma_sync": []}
    before = dict(fa.launches)
    for name in ("wgmma", "mma_sync", "mma_sync", "wgmma") * 2:
        fa.gqa_flash = kernel if name == "wgmma" else mma_sync
        try:
            t = time.perf_counter()
            logits_p, cache_p = prefill(params, prompts)
            torch.cuda.synchronize()
            paired[name].append(time.perf_counter() - t)
        finally:
            fa.gqa_flash = kernel
        del logits_p, cache_p
    moved = {r: fa.launches[r] - before[r] for r in ("wgmma", "mma_sync")}
    if moved != {"wgmma": 4 * cfg.num_layers, "mma_sync": 4 * cfg.num_layers}:
        raise AssertionError(f"paired prefills launched {moved}, expected "
                             f"{4 * cfg.num_layers} on each kernel")
    paired_prefill = {f"{r}_s": float(np.mean(v)) for r, v in paired.items()}
    paired_prefill.update(saved_s=paired_prefill["mma_sync_s"] - paired_prefill["wgmma_s"],
                          turns=paired)
    log(f"serve, warm prefill in turns: Hopper kernel {paired_prefill['wgmma_s']:.6f} s, "
        f"mma.sync kernel {paired_prefill['mma_sync_s']:.6f} s, saved "
        f"{paired_prefill['saved_s']:.6f} s ({paired})")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        greedy_generate(params, prompts, cfg, 8)
        traced_wall = time.perf_counter() - t
    events = device_events(prof)
    busy_ms = busy_us(events) / 1e3
    per_name = {}
    for e in events:
        per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    log(f"serve, traced (prefill + 8 decode steps): {traced_wall:.6f} s wall under "
        f"the profiler, card busy {busy_ms:.6f} ms = "
        f"{100 * busy_ms / 1e3 / traced_wall:.6f} %")
    for name, ms in sorted(per_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  device {ms:.6f} ms  {name[:100]}")
    return dict(arch=cfg.name, params=n_params, init_s=init_s,
                batch=SERVE_BATCH, prompt=SERVE_PROMPT, new_tokens=SERVE_TOKENS,
                first_run=first_run, warm_run=warm_run, warm_same_tokens=same,
                peak_gib=peak / 2**30, prefill_flash_launches=prefill_n,
                decode_flash_launches=decode_n, layer0_max_abs_err=layer0_err,
                layer0_rel_l2=layer0_rel, attn_rel_l2_max=max(attn_rel),
                attn_rel_l2_median=float(np.median(attn_rel)),
                forced_logits_rel_l2=forced,
                chained_logits_rel_l2=chained, chained_chunk_rel_l2=chained_chunks,
                first_token_agree=agree,
                chunked_prefill_s=chunked_s, traced_wall_s=traced_wall,
                traced_busy_ms=busy_ms, traced_busy_share=busy_ms / 1e3 / traced_wall,
                launches=launches)


# --- DAG gating and the device slot loop -------------------------------------

# The paper's default 150-server cluster, one evaluation week of DAG jobs.
DAG = dict(capacity=150, learn_weeks=1, seed=7)
TILE_REGIONS = tuple(REGIONS)[:8]
TILE_SEEDS = range(8)


def dag_week():
    mat = Scenario(dag=DagConfig(), **DAG).materialize()
    return mat, mat.eval_week(0)


def gating_work(rows, graph):
    """(bytes, operations) of one call: fin read once (one byte a cell), the
    CSR read once, the int32 counts written once; one add per edge and
    cell."""
    elt = graph.pred_idx.element_size()
    nbytes = rows * graph.n + elt * (graph.n + 1 + graph.n_edges) + 4 * rows * graph.n
    return nbytes, rows * graph.n_edges


def release_work(rows, graph):
    """(bytes, operations) of one ``dep_release_csr`` call: fin and arrived
    read once (a byte a cell each), pred_left once (int32), the CSR once;
    pred2 (int32) and pending (a byte) written once; one add per edge and
    cell, and per cell the subtraction, two compares and two ands."""
    elt = graph.pred_idx.element_size()
    nbytes = 11 * rows * graph.n + elt * (graph.n + 1 + graph.n_edges)
    return nbytes, rows * graph.n_edges + 5 * rows * graph.n


def release_inputs(gen, rows, graph, n_real):
    """fin and arrived (bool) and a live in-degree (int32) per cell on the
    card: the in-degree less up to two predecessors finished before, so
    rows of in-degree 0 and releases occur; padding rows never finish."""
    dev = graph.pred_ptr.device
    deg = torch.diff(graph.pred_ptr).cpu().numpy()
    fin = gen.random((rows, graph.n)) < 0.05
    fin[:, n_real:] = False
    arrived = gen.random((rows, graph.n)) < 0.8
    pred = (deg - np.minimum(gen.integers(0, 3, (rows, graph.n)), deg)).astype(np.int32)
    return [torch.from_numpy(x).to(dev) for x in (fin, arrived, pred)]


def unfused_release(fin, arrived, pred, graph):
    """The release as the engine wrote it before the fused kernel: the
    decrement kernel, then four eager ops."""
    dec = gating.dep_decrement_csr(fin, graph)
    pred2 = pred - dec
    return pred2, (dec > 0) & (pred2 == 0) & arrived


def release_check(fin, arrived, pred, graph, what):
    """``dep_release_csr`` against its plain version and the unfused
    sequence on the same inputs, equal exactly; returns the largest
    absolute difference of pred2 (0)."""
    pred2, pending = gating.dep_release_csr(fin, arrived, pred, graph)
    torch.cuda.synchronize()
    if pred2.dtype != torch.int32 or pending.dtype != torch.bool or \
            pred2.shape != fin.shape or pending.shape != fin.shape:
        raise AssertionError(f"{what}: bad outputs {pred2.dtype} {pending.dtype}")
    want = gating.dep_release_csr_plain(fin, arrived, pred, graph)
    for name, (p2, pe) in (("plain", want),
                           ("unfused", unfused_release(fin, arrived, pred, graph))):
        if not (torch.equal(pred2, p2) and torch.equal(pending, pe)):
            raise AssertionError(f"{what}: release kernel and {name} differ")
    return (pred2 - want[0]).abs().max().item() if pred2.numel() else 0


def gating_check(fin, graph, parents, children, what):
    """The kernel against its plain version (and the edge-list forms) on
    the same inputs, equal exactly; returns the largest absolute
    difference (0)."""
    got = gating.dep_decrement_csr(fin, graph)
    torch.cuda.synchronize()
    want = gating.dep_decrement_csr_plain(fin, graph)
    scatter = gating.dep_decrement_plain(fin, parents, children, graph.n)
    edges = gating.dep_decrement(fin, parents, children, graph.n)
    if got.dtype != torch.int32 or got.shape != fin.shape:
        raise AssertionError(f"{what}: bad output {tuple(got.shape)} {got.dtype}")
    for name, other in (("plain", want), ("index_add_", scatter),
                        ("edge-list entry", edges)):
        if not torch.equal(got, other):
            diff = (got - other).abs().max().item()
            raise AssertionError(f"{what}: kernel and {name} differ by up to {diff}")
    return (got - want).abs().max().item() if got.numel() else 0


def kernels_per_call(fn, iters: int = 200) -> float:
    """Device kernels per call of ``fn`` (copies and sets left out) in a
    ``torch.profiler`` trace of ``iters`` calls: the dispatches that reach
    the card, whatever the host's speed."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(not e.name.startswith(("Memcpy", "Memset"))
               for e in device_events(prof)) / iters


def gating_kernel_phase(report):
    """Phase 2 for the gating kernel, in both its modes: the decrement
    (``dep_decrement_csr``, the kernel given no in-degrees) and the release
    (``dep_release_csr``), each equal exactly to its plain versions on the
    path's own graph (the capacity-150 week padded to its 6144 rows, as the
    slot loop lays it out, B=1 and B=64) and on an empty edge list,
    duplicate edges and a row of in-degree above 64; times at the path's
    shape; the release against the unfused sequence it replaces (the
    decrement and four eager ops), in turns, at most half its time, and its
    device kernels per call (one; the sequence's six)."""
    dev = torch.device("cuda")
    gen = np.random.default_rng(2)
    _, ev = dag_week()
    packed = pack(ev)
    n_pad = scan_engine._pad_rows(packed.n)
    n = packed.n
    deg = np.diff(packed.succ_ptr)
    par = np.repeat(np.arange(n), deg)
    chd = packed.succ_rows.copy()
    log(f"gating: the path's graph has {n} rows ({n_pad} padded), {len(par)} edges, "
        f"largest in-degree {int(packed.pred0.max())}")
    dup = gen.integers(0, len(par), 500)
    hub = gen.integers(0, n, 200)
    graphs = [
        ("path", par, chd),
        ("empty", np.zeros(0, np.int64), np.zeros(0, np.int64)),
        ("duplicates", np.concatenate([par, par[dup]]), np.concatenate([chd, chd[dup]])),
        ("in-degree 200", np.concatenate([par, hub]),
         np.concatenate([chd, np.full(200, 5)])),
    ]
    err = rerr = 0
    for name, p, c in graphs:
        graph = (scan_engine._dep_graph(packed, n_pad, dev) if name == "path"
                 else gating.dep_graph(p, c, n_pad, device=dev))
        pt, ct = (torch.from_numpy(x).to(dev) for x in (p, c))
        for rows in (1, 64):
            fin = torch.from_numpy(gen.random((rows, n_pad)) < 0.05).to(dev)
            fin[:, n:] = False
            err = max(err, gating_check(fin, graph, pt, ct, f"gating {name} B={rows}"))
            rel = release_inputs(gen, rows, graph, n)
            rerr = max(rerr, release_check(*rel, graph, f"release {name} B={rows}"))
            log(f"gating {name:13s} B={rows:2d} n={n_pad} E={graph.n_edges}: equal "
                f"to the plain version, index_add_ and the edge-list entry; the release "
                f"equal to its plain version and the unfused sequence "
                f"({int(rel[0].sum())} finished, {int((rel[2] == 0).sum())} cells of "
                f"live in-degree 0)")

    graph = scan_engine._dep_graph(packed, n_pad, dev)
    pt, ct = (torch.from_numpy(x).to(dev) for x in (par, chd))
    out = {}
    for rows in (1, 64):
        fin = torch.from_numpy(gen.random((rows, n_pad)) < 0.05).to(dev)

        def library():
            z = torch.zeros((rows, n_pad), dtype=torch.int32, device=dev)
            return z.index_add_(1, ct, fin[:, pt].int())

        def kernel():
            return gating.dep_decrement_csr(fin, graph)

        def plain():
            return gating.dep_decrement_csr_plain(fin, graph)

        t = dict(ms=time_ms(kernel, 2000), plain_ms=time_ms(plain, 2000),
                 library_ms=time_ms(library, 2000))
        t.update(device_ms=device_ms(kernel), plain_device_ms=device_ms(plain),
                 library_device_ms=device_ms(library))
        nbytes, ops = gating_work(rows, graph)
        b, by = bound_ms(nbytes, ops)
        log(f"dep_decrement_csr (the kernel without in-degrees) B={rows} n={n_pad} "
            f"E={graph.n_edges}: {t['ms']:.6f} "
            f"ms/call (plain {t['plain_ms']:.6f}, index_add_ {t['library_ms']:.6f}, "
            f"bound {b:.9f} by {by}: {nbytes} bytes); device time {t['device_ms']} "
            f"ms/call (plain {t['plain_device_ms']}, index_add_ "
            f"{t['library_device_ms']})")
        out[rows] = dict(bound_ms=b, bound_by=by, bytes=nbytes, **t)

    rout = {}
    for rows in (1, 64):
        rel = release_inputs(gen, rows, graph, n)

        def fused():
            return gating.dep_release_csr(*rel, graph)

        def unfused():
            return unfused_release(*rel, graph)

        def plain():
            return gating.dep_release_csr_plain(*rel, graph)

        # The launch alone: the kernel's C entry on fixed buffers, no
        # wrapper; what no wrapper can go below.
        out2, pend = torch.empty_like(rel[2]), torch.empty_like(rel[1])
        ptrs = ([x.data_ptr() for x in rel[:3]]
                + [graph.pred_ptr.data_ptr(), graph.pred_idx.data_ptr(), rows, n_pad,
                   out2.data_ptr(), pend.data_ptr(),
                   torch.cuda.current_stream().cuda_stream])

        def launch():
            return gating._lib.dep_release_csr(*ptrs)

        turns = {"fused": [], "unfused": []}
        for which in ("fused", "unfused", "unfused", "fused") * 3:
            turns[which].append(time_ms(fused if which == "fused" else unfused, 2000))
        t = {k: float(np.mean(v)) for k, v in turns.items()}
        ratio = t["fused"] / t["unfused"]
        r = dict(ms=t["fused"], unfused_ms=t["unfused"], ratio=ratio, turns=turns,
                 launch_ms=time_ms(launch, 2000),
                 plain_ms=time_ms(plain, 2000), library_ms=None,
                 device_ms=device_ms(fused), unfused_device_ms=device_ms(unfused),
                 plain_device_ms=device_ms(plain),
                 kernels_per_call=kernels_per_call(fused),
                 unfused_kernels_per_call=kernels_per_call(unfused))
        nbytes, ops = release_work(rows, graph)
        b, by = bound_ms(nbytes, ops)
        log(f"dep_release_csr B={rows} n={n_pad} E={graph.n_edges}: {r['ms']:.6f} ms/call "
            f"against the unfused sequence's {r['unfused_ms']:.6f} in turns, ratio "
            f"{ratio:.4f} ({turns}); the launch alone {r['launch_ms']:.6f}; plain "
            f"{r['plain_ms']:.6f}; bound {b:.9f} by {by}: {nbytes} bytes; device time "
            f"{r['device_ms']} ms/call (unfused {r['unfused_device_ms']}, plain "
            f"{r['plain_device_ms']}); device kernels per call {r['kernels_per_call']} "
            f"(unfused {r['unfused_kernels_per_call']})")
        if not ratio <= 0.5:
            raise AssertionError(f"dep_release_csr B={rows}: {t['fused']} ms per call, "
                                 f"more than half the unfused {t['unfused']} ms")
        if not 0 < r["kernels_per_call"] <= 1:
            raise AssertionError(f"dep_release_csr B={rows}: {r['kernels_per_call']} "
                                 "device kernels per call, not one")
        rout[rows] = dict(bound_ms=b, bound_by=by, bytes=nbytes, **r)
    ptx = ptxas_report(report, "dep_release_csr_kernel")
    log(f"gating kernel, ptxas: {ptx}")
    return dict(name="dep_release_csr", route="cuda",
                source="src/repro_torch/csrc/gating.cu", ptxas=ptx,
                replaces="src/repro/kernels/gating.py:90 (with the release ops of "
                         "src/repro/core/scan_engine.py:513-514)",
                max_abs_err=max(err, rerr), shape=f"B=1 n={n_pad} E={graph.n_edges} int32 CSR",
                library="none: no one PyTorch call computes the release (the unfused "
                        "sequence is timed beside it)",
                tile_B64=rout[64], **rout[1],
                decrement=dict(wrapper="dep_decrement_csr (the kernel without in-degrees)",
                               library="fin[:, parents].int() then "
                                       "zeros.index_add_(1, children, .): two calls",
                               tile_B64=out[64], **out[1]))


def same_results(a_res, b_res, names):
    """(weekly results that differ, slots that differ): carbon, energy,
    completion, waits and violations per week, every field of every slot,
    compared with ==."""
    weeks = slots = 0
    for name in names:
        for a, b in zip(a_res[name], b_res[name], strict=True):
            weeks += not (a.carbon_g == b.carbon_g and a.energy_kwh == b.energy_kwh
                          and np.array_equal(a.completion, b.completion)
                          and np.array_equal(a.wait_slots, b.wait_slots)
                          and np.array_equal(a.violations, b.violations))
            slots += abs(len(a.slots) - len(b.slots)) + sum(
                vars(x) != vars(y) for x, y in zip(a.slots, b.slots))
    return weeks, slots


def dag_path_phase():
    """Phase 5: the DAG path through ``run(..., engine="scan")`` on the
    card, its CPU vector twin, the independent twin, and one full tile."""
    gating.reset_launches()
    scan_engine.reset_stats()
    t = time.perf_counter()
    res = run(Scenario(dag=DagConfig(), engine="scan", **DAG), DEFAULT_DAG_POLICIES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = gating.launches["dep_release"]
    decrements = gating.launches["dep_decrement"]
    stats = dict(scan_engine.stats)
    log(f"dag path (scan on the card): {wall:.3f} s wall, {stats['steps']} slot steps "
        f"({stats['loop_s']:.3f} s in the chunk loops, "
        f"{1e3 * stats['loop_s'] / stats['steps']:.6f} ms per step; host accounting "
        f"{stats['account_s']:.3f} s), release launches {launches}, decrement "
        f"launches {decrements}")
    log(res.table())
    t = time.perf_counter()
    cpu = run(Scenario(dag=DagConfig(), engine="vector", **DAG), DEFAULT_DAG_POLICIES,
              device="cpu")
    cpu_wall = time.perf_counter() - t
    weeks, slots = same_results(res.weekly, cpu.weekly, DEFAULT_DAG_POLICIES)
    log(f"dag path, the CPU vector engine ({cpu_wall:.3f} s wall): {weeks} weekly "
        f"results and {slots} slots differ from the card's scan run")
    n_cells = len(DEFAULT_DAG_POLICIES)
    if weeks or slots:
        raise AssertionError(f"dag path: {weeks} weekly results, {slots} slots differ")
    if not (launches == stats["dag_steps"] == stats["steps"] == stats["cell_steps"]
            and launches >= 168 * n_cells and stats["delegated"] == 0 and decrements == 0):
        raise AssertionError(f"dag path: {launches} release and {decrements} decrement "
                             f"launches for {stats}")
    for name in DEFAULT_DAG_POLICIES:
        (r,) = res.weekly[name]
        if not (math.isfinite(r.carbon_g) and r.carbon_g > 0
                and (r.completion >= 0).all() and r.num_jobs > 5000):
            raise AssertionError(f"dag path {name}: bad result")
    if not res.savings("dag-carbon") > 0:
        raise AssertionError("dag-carbon saves nothing against dag-fcfs")

    gating.reset_launches()
    scan_engine.reset_stats()
    twin = run(Scenario(dag=DagConfig(independent=True), engine="scan", **DAG),
               DEFAULT_DAG_POLICIES)
    twin_launches = gating.launches["dep_release"] + gating.launches["dep_decrement"]
    twin_stats = dict(scan_engine.stats)
    twin_cpu = run(Scenario(dag=DagConfig(independent=True), engine="vector", **DAG),
                   DEFAULT_DAG_POLICIES, device="cpu")
    tw, ts = same_results(twin.weekly, twin_cpu.weekly, DEFAULT_DAG_POLICIES)
    log(f"independent twin: gating launches (release and decrement) {twin_launches} in "
        f"{twin_stats['steps']} "
        f"slot steps; {tw} weekly results and {ts} slots differ from its CPU run")
    log(twin.table())
    if twin_launches or tw or ts or twin_stats["steps"] < 168 * n_cells:
        raise AssertionError("independent twin: launched the gating or differs")

    # One full tile: 64 dag-carbon cells on the same week, 8 regions x 8 CI
    # seeds, one batched program on the card.
    mat, ev = dag_week()
    cis = [CarbonService.synthetic(r, mat.scenario.hours + CI_MARGIN_HOURS, seed=s)
           for r in TILE_REGIONS for s in TILE_SEEDS]

    def cases(engine, device, **kw):
        return [SimCase(jobs=ev, ci=ci, cluster=mat.cluster, policy=DagCarbonPolicy(),
                        t0=mat.t0, horizon=WEEK, engine=engine, device=device, **kw)
                for ci in cis]

    gating.reset_launches()
    scan_engine.reset_stats()
    t = time.perf_counter()
    tile = simulate_many(cases("scan", "cuda"))
    torch.cuda.synchronize()
    tile_wall = time.perf_counter() - t
    tile_launches, tile_stats = gating.launches["dep_release"], dict(scan_engine.stats)
    tile_decrements = gating.launches["dep_decrement"]
    t = time.perf_counter()
    tile_cpu = simulate_many(cases("vector", "cpu"))
    tile_cpu_wall = time.perf_counter() - t
    tw, ts = same_results({"c": tile}, {"c": tile_cpu}, ["c"])
    log(f"tile: {len(cis)} dag-carbon cells in {tile_stats['steps']} batched slot steps, "
        f"{tile_wall:.3f} s wall ({len(cis) / tile_wall:.3f} cells/s, "
        f"{tile_stats['cell_steps'] / tile_wall:.3f} cell slot steps/s; chunk loops "
        f"{tile_stats['loop_s']:.3f} s = {1e3 * tile_stats['loop_s'] / tile_stats['steps']:.6f}"
        f" ms per batched step, host accounting {tile_stats['account_s']:.3f} s); release "
        f"launches {tile_launches}; CPU vector engine {tile_cpu_wall:.3f} s: {tw} cells "
        f"and {ts} slots differ")
    if (tw or ts or tile_launches != tile_stats["dag_steps"] or tile_decrements
            or tile_stats["cell_steps"] != len(cis) * tile_stats["steps"]):
        raise AssertionError(f"tile: {tw} cells / {ts} slots differ, {tile_launches} "
                             f"launches for {tile_stats}")

    # One traced chunk of the tile: the horizon's 168 slots and no overrun.
    from torch.profiler import ProfilerActivity, profile

    scan_engine.reset_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        simulate_many(cases("scan", "cuda", max_overrun=0))
        torch.cuda.synchronize()
    chunk_s = scan_engine.stats["loop_s"]
    events = device_events(prof)
    busy_ms = busy_us(events) / 1e3
    kernels_ms = busy_us([e for e in events if not e.name.startswith("Memcpy")]) / 1e3
    per_name = {}
    for e in events:
        per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    log(f"traced chunk ({scan_engine.stats['steps']} batched steps of {len(cis)} cells): "
        f"chunk loop {chunk_s:.6f} s under the profiler, card busy {busy_ms:.6f} ms = "
        f"{100 * busy_ms / 1e3 / chunk_s:.6f} % of it, {kernels_ms:.6f} ms = "
        f"{100 * kernels_ms / 1e3 / chunk_s:.6f} % in kernels (copies left out); "
        f"{len(events)} device events")
    for name, ms in sorted(per_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  device {ms:.6f} ms  {name[:100]}")
    return dict(launches=launches, wall_s=wall, stats=stats, cpu_wall_s=cpu_wall,
                weeks_differ=weeks, slots_differ=slots,
                savings={n: res.savings(n) for n in DEFAULT_DAG_POLICIES},
                twin_launches=twin_launches, twin_steps=twin_stats["steps"],
                tile_cells=len(cis), tile_wall_s=tile_wall, tile_stats=tile_stats,
                tile_launches=tile_launches, tile_cpu_wall_s=tile_cpu_wall,
                tile_cells_per_s=len(cis) / tile_wall,
                tile_cell_steps_per_s=tile_stats["cell_steps"] / tile_wall,
                traced_chunk_loop_s=chunk_s, traced_chunk_busy_ms=busy_ms,
                traced_chunk_busy_share=busy_ms / 1e3 / chunk_s,
                traced_chunk_kernel_ms=kernels_ms,
                traced_chunk_device_events=len(events))


# --- Algorithm 1: the score matrix and the oracle's greedy pass ----------------

# Edge shapes of the score matrix: (name, J, T); the path's shapes come
# from the main scenario's oracle windows.
SCORE_EDGES = [("J=1 T=1", 1, 1), ("J=1 T=777", 1, 777), ("J=1000 T=1", 1000, 1),
               ("J=257 T=129", 257, 129), ("J=3001 T=552", 3001, 552),
               ("J=6945 T=168", 6945, 168), ("J=5 T=20001", 5, 20001)]


def oracle_windows():
    """The main scenario's oracle windows: each learning window (the jobs
    ``learn_window`` replays) and the oracle policy's span on evaluation
    week 0 (the jobs in the order the engine hands them over), with its CI
    slice and horizon."""
    mat = Scenario(**MAIN).materialize()
    out = []
    for off in mat.scenario.learn_offsets():
        jobs = [dataclasses.replace(j, arrival=j.arrival - off)
                for j in mat.hist if off <= j.arrival < off + WEEK]
        out.append((f"learn window {off // WEEK}", jobs, mat.ci.trace[off:off + WEEK],
                    WEEK))
    t0 = mat.t0
    span = min(len(mat.ci) - t0,
               WEEK + max(q.delay for q in mat.cluster.queues) + 24 * 14)
    jobs = [dataclasses.replace(j, arrival=j.arrival - t0)
            for j in pack(mat.eval_week(0)).jobs]
    out.append(("oracle span week 0", jobs, mat.ci.trace[t0:t0 + span], span))
    return out


def score_args(jobs, ci, horizon, dev):
    """The score matrix's inputs over a window's (job, scale) pairs:
    marginals, CI, window bounds (float32, float32, int32, int32)."""
    _, _, pgain, pt0, pt1, _ = oracle_mod._pairs(jobs, horizon)
    return [torch.from_numpy(np.ascontiguousarray(x, dtype=dt)).to(dev)
            for x, dt in ((pgain, np.float32), (ci, np.float32), (pt0, np.int32),
                          (pt1, np.int32))]


def score_ops_phase(windows):
    """The kernel API path: ``ops.score_matrix`` on the card over each
    oracle window's pair grid, launch counts reset just before and read
    just after."""
    dev = torch.device("cuda")
    args = [score_args(jobs, ci, h, dev) for _, jobs, ci, h in windows]
    score.reset_launches()
    outs = [ops.score_matrix(*a) for a in args]
    torch.cuda.synchronize()
    launches = dict(score.launches)
    if launches != {"score_matrix": len(windows), "rows": len(windows), "columns": 0,
                    "flat": 0}:
        raise AssertionError(f"score_matrix launched {launches} for {len(windows)} calls")
    return dict(launches=launches["score_matrix"], by_route=launches, args=args, outs=outs)


def score_kernel_phase(windows, path, report):
    """The score kernel against its plain version and the flat kernel:
    exactly equal on the path's outputs and on edge shapes; its nonzero
    cells are the oracle's entries; times at the first learning window's and
    the oracle span's shapes, the rows and flat kernels in turns (ratio at
    most 0.7), and the floor."""
    dev = torch.device("cuda")
    gen = np.random.default_rng(4)
    err = 0.0
    for (name, jobs, ci, h), a, out in zip(windows, path["args"], path["outs"]):
        want = score.score_matrix_plain(*a)
        if out.dtype != torch.float32 or not torch.equal(out, want):
            raise AssertionError(f"score_matrix {name}: kernel and plain version differ "
                                 f"by up to {(out - want).abs().max().item()}")
        if not torch.equal(out, score.score_matrix(*a, route="flat")):
            raise AssertionError(f"score_matrix {name}: the rows and flat routes differ")
        entries = len(oracle_mod._build_entries(jobs, ci, h)[0])
        nonzero = int((out != 0).sum().item())
        if nonzero != entries:
            raise AssertionError(f"score_matrix {name}: {nonzero} nonzero cells for "
                                 f"{entries} oracle entries")
        log(f"score_matrix {name}: J={out.shape[0]} T={out.shape[1]}, equal to the "
            f"plain version; {nonzero} nonzero cells = the oracle's entries")
    for name, j, t in SCORE_EDGES:
        marg = gen.uniform(0, 1, j).astype(np.float32)
        ci = gen.uniform(20, 600, t).astype(np.float32)
        ci[::4] = np.array([0.0, 1e-9, 1e-12, -3.0], np.float32)[np.arange(len(ci[::4])) % 4]
        ts = gen.integers(0, t, j).astype(np.int32)
        te = gen.integers(0, t + 5, j).astype(np.int32)
        te[::3] = t + 40                   # past the end
        ts[1::5] = te[1::5]                # empty window
        a = [torch.from_numpy(x).to(dev) for x in (marg, ci, ts, te)]
        got = score.score_matrix(*a)
        torch.cuda.synchronize()
        want = score.score_matrix_plain(*a)
        if not torch.equal(got, want):
            raise AssertionError(f"score_matrix {name}: differs from the plain version")
        if not torch.equal(got, score.score_matrix(*a, route="flat")):
            raise AssertionError(f"score_matrix {name}: differs from the flat route")
        err = max(err, (got - want).abs().max().item())
        log(f"score_matrix {name} on {score.plan(j, t)} (windows past the end and empty, "
            f"CI at and below 1e-9): equal to the plain version and the flat route")

    rows = {}
    for key, idx in (("first learning window", 0), ("oracle span", len(windows) - 1)):
        a = path["args"][idx]
        marg, ci, ts, te = a
        j, t = marg.shape[0], ci.shape[0]

        def kernel():
            return score.score_matrix(*a)

        def plain():
            return score.score_matrix_plain(*a)

        def library():
            tt = torch.arange(t, device=dev)
            mask = (tt >= ts[:, None]) & (tt < te[:, None])
            return torch.where(mask, marg[:, None] / ci.clamp_min(1e-9), 0)

        def previous():
            return score.score_matrix(*a, route="flat")

        if not torch.equal(library(), kernel()):
            raise AssertionError("the composed library expression differs from the kernel")
        pl = score.plan(j, t)
        stream = torch.cuda.current_stream().cuda_stream
        tm = dict(ms=time_ms(kernel, 2000), previous_ms=time_ms(previous, 2000),
                  plain_ms=time_ms(plain, 2000), library_ms=time_ms(library, 2000))
        # The rows kernel against the previous (flat) kernel in turns, each
        # turn the mean device time of 200 calls; the floor: an empty kernel
        # on the rows kernel's grid.
        turns = in_turns(dict(device_ms=kernel, previous_device_ms=previous))
        tm.update({k: float(np.mean(v)) for k, v in turns.items()}, turns=turns,
                  floor_device_ms=device_ms(lambda: score._lib.score_floor(
                      pl["blocks"], 1, pl["threads"], stream)),
                  plain_device_ms=device_ms(plain), library_device_ms=device_ms(library))
        nbytes = 12 * j + 4 * t + 4 * j * t
        b, by = bound_ms(nbytes, j * t)
        tm.update(ratio=tm["device_ms"] / tm["previous_device_ms"],
                  bound_share=b / tm["device_ms"])
        log(f"score_matrix {key} J={j} T={t} on {pl}: {tm['ms']:.6f} ms/call (flat "
            f"{tm['previous_ms']:.6f}, plain {tm['plain_ms']:.6f}, where/clamp_min "
            f"expression {tm['library_ms']:.6f}, bound {b:.9f} by {by}: {nbytes} bytes); "
            f"device time in turns {tm['device_ms']:.6f} against the flat kernel's "
            f"{tm['previous_device_ms']:.6f}, ratio {tm['ratio']:.4f} ({turns}), "
            f"{tm['bound_share']:.4f} of the bound; the floor (an empty kernel on the "
            f"same grid) {tm['floor_device_ms']}; plain {tm['plain_device_ms']}, "
            f"expression {tm['library_device_ms']}")
        if not tm["ratio"] <= 0.7:
            raise AssertionError(f"score_matrix {key}: the rows kernel takes "
                                 f"{tm['device_ms']} ms, more than 0.7 of the flat "
                                 f"kernel's {tm['previous_device_ms']}")
        rows[key] = dict(shape=f"J={j} T={t}", plan=pl, bound_ms=b, bound_by=by,
                         bytes=nbytes, **tm)
    ptx = ptxas_report(report, "score_rows_kernel")
    log(f"score_rows_kernel, ptxas: {ptx}")
    first = rows["first learning window"]
    return dict(name="score_matrix", route="cuda", source="src/repro_torch/csrc/score.cu",
                kernel="score_rows_kernel", ptxas=ptx,
                replaces="src/repro/kernels/score.py:46", max_abs_err=err,
                launches=path["launches"], launches_by_route=path["by_route"], path="ops",
                library="torch.where(mask, marg[:, None] / ci.clamp_min(1e-9), 0) "
                        "with the mask from arange: five calls",
                oracle_span=rows["oracle span"], **first)


def oracle_path_phase(numpy_res):
    """The main path with ``backend="device"``: learning, weekly re-learning
    and the oracle policy through the greedy kernel, launch counts reset
    just before and read just after; each ``solve`` attempt's entries are
    kept for the kernel check."""
    attempts = []
    build_entries = oracle_mod._build_entries

    def kept(jobs, ci, horizon):
        out = build_entries(jobs, ci, horizon)
        if len(out[0]):
            attempts.append(dict(jobs=jobs, ci=ci, horizon=horizon, entries=out))
        return out

    oracle_mod._build_entries = kept
    oracle_greedy.reset_launches()
    oracle_mod.reset_stats()
    try:
        t = time.perf_counter()
        res = run(Scenario(**MAIN), POLICIES, backend="device")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        oracle_mod._build_entries = build_entries
    launches = oracle_greedy.launches["greedy_pass"]
    by_route = {r: oracle_greedy.launches[r] for r in oracle_greedy.ROUTES}
    stats = dict(oracle_mod.stats)
    log(f"oracle path (backend=\"device\" on the card): {wall:.3f} s wall (learning "
        f"{res.learn_s:.3f} s against {numpy_res.learn_s:.3f} s with the host numpy "
        f"pass), greedy launches {launches} for {len(attempts)} solve attempts with "
        f"entries ({stats['entries']} entries, {stats['walked']} walked, "
        f"{stats['early_exits']} early exits)")
    log(res.table())
    if not (launches == len(attempts) == stats["device_passes"] >= 1):
        raise AssertionError(f"greedy_pass launched {launches} times for "
                             f"{len(attempts)} solve attempts with entries ({stats})")
    oracles = [a for a in attempts if a["horizon"] > WEEK]
    if len(oracles) < MAIN["eval_weeks"] or len(attempts) - len(oracles) < \
            MAIN["learn_weeks"] + MAIN["eval_weeks"] - 1:
        raise AssertionError(f"{len(attempts)} passes, {len(oracles)} of the oracle "
                             "policy: the path skipped a learning window or a week")
    # alloc laid out by job window: every window and span fits the
    # shared-memory walker
    if by_route != {"smem": len(attempts), "l2": 0}:
        raise AssertionError(f"greedy launches by route {by_route}: expected all "
                             f"{len(attempts)} passes on smem")
    log(f"greedy launches by route {by_route}: the {len(attempts) - len(oracles)} "
        f"168-slot windows and the {len(oracles)} oracle spans on smem")
    t = time.perf_counter()
    cpu = run(Scenario(**MAIN), POLICIES, backend="device", device="cpu")
    cpu_wall = time.perf_counter() - t
    weeks, slots = same_results(res.weekly, cpu.weekly, POLICIES)
    log(f"oracle path on the CPU (plain pass, float64 knowledge base; {cpu_wall:.3f} s "
        f"wall): {weeks} weekly results and {slots} slots differ from the card's run")
    if weeks or slots:
        raise AssertionError(f"oracle path: {weeks} weekly results, {slots} slots "
                             "differ from the CPU run")
    for name in POLICIES:
        for r in res.weekly[name]:
            if not (math.isfinite(r.carbon_g) and r.carbon_g > 0):
                raise AssertionError(f"oracle path {name}: bad result")
    nweeks, nslots = same_results(res.weekly, numpy_res.weekly, POLICIES)
    log(f"against the backend=\"numpy\" run of the main path: {nweeks} of "
        f"{len(POLICIES) * MAIN['eval_weeks']} weekly results and {nslots} slots differ "
        f"(float32 work against float64; information)")
    return dict(attempts=attempts, launches=launches, by_route=by_route, stats=stats,
                wall_s=wall,
                learn_s=res.learn_s, execute_s=res.execute_s,
                numpy_learn_s=numpy_res.learn_s, cpu_wall_s=cpu_wall,
                weeks_differ_cpu=weeks, slots_differ_cpu=slots,
                weeks_differ_numpy=nweeks, slots_differ_numpy=nslots,
                savings={n: res.savings(n) for n in POLICIES})


def greedy_args(attempt, dev):
    """A ``solve`` attempt's entries as the device pass hands them over:
    packed, with kmin and lengths, on ``dev``; the largest scale; and the
    jobs' windows with their cells, as ``greedy_pass`` takes them."""
    jobs, h = attempt["jobs"], attempt["horizon"]
    j, t, k, g, _ = attempt["entries"]
    t0, t1, _ = oracle_mod._windows(jobs, h)
    windows = np.stack([t0, t1], axis=1)
    *args, win = oracle_greedy.upload(j, t, k, g, [x.k_min for x in jobs],
                                      [x.length for x in jobs], dev, windows=windows)
    return args, int(k.max()), dict(windows=win,
                                    cells=oracle_greedy.ragged_layout(windows, h)[3])


def greedy_check(args, k_max, capacity, horizon, what, route=None, windows=None,
                 cells=None):
    """The kernel (``plan``'s route, or the one named) against
    ``greedy_pass_plain``: alloc, used, work and the entries walked equal bit
    for bit; returns the plain version's results and its host seconds."""
    got = oracle_greedy.greedy_pass(*args, capacity, horizon, k_max, route=route,
                                    windows=windows, cells=cells)
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = oracle_greedy.greedy_pass_plain(
        *(a.cpu() for a in args), capacity, horizon,
        windows=None if windows is None else windows.cpu())
    plain_s = time.perf_counter() - t
    for name, a, b in zip(("alloc", "used", "work", "walked"), got, want):
        if a.dtype != b.dtype or not torch.equal(a.cpu(), b):
            raise AssertionError(f"greedy_pass {what} on {route or 'its route'}: "
                                 f"{name} differs from the plain version")
    return want, plain_s


def taken_entries(alloc, kmin):
    """Entries a pass took: a job's base entry and each scale above it."""
    km = kmin.cpu().numpy()[:, None]
    a = alloc.cpu().numpy()
    return int(np.where(a > 0, a - km + 1, 0).sum())


def extension_jobs():
    """``tests/test_oracle.py::test_infeasible_extends_deadlines`` made
    larger: 48 jobs of length 8-12 and no slack on 2 servers."""
    gen = np.random.default_rng(6)
    jobs = [Job(job_id=i, arrival=int(gen.integers(0, 120)),
                length=float(gen.uniform(8, 12)), queue=0, delay=0,
                profile=amdahl_profile(1, int(gen.integers(1, 4)), 0.5), k_min=1)
            for i in range(48)]
    return jobs, gen.uniform(50, 500, 400)


def sm_clock_mhz():
    """The SM clock and its maximum, in MHz, as ``nvidia-smi`` reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return [float(x) for x in out.stdout.strip().splitlines()[0].split(",")]


def chain_streams(n=434, horizon=WEEK, n_entries=205_872, seed=16):
    """Three synthetic entry streams at learning window 0's shape in which
    every entry stops at one test of the walk: (a) the done test (every job
    but job 0 done from the start, no entry on job 0, so the walk never
    stops early), (b) the consistency test (non-base entries whose previous
    scale was never taken), (c) the capacity test (base entries, capacity
    0).  Each: (entries, kmin, lengths) on the card, capacity, k_max."""
    gen = np.random.default_rng(seed)
    j = gen.integers(0, n, n_entries)
    t = gen.integers(0, horizon, n_entries)
    g = gen.uniform(0.1, 0.9, n_entries)
    ones = np.ones(n_entries, np.int64)
    kmin, endless = np.ones(n, np.int64), np.full(n, 1e9)
    done = np.where(np.arange(n) == 0, 1e9, 0.0)
    dev = torch.device("cuda")
    return {
        "done test": (oracle_greedy.upload(np.maximum(j, 1), t, ones, g, kmin, done, dev),
                      MAIN["capacity"], 1),
        "consistency test": (oracle_greedy.upload(j, t, 2 * ones, g, kmin, endless, dev),
                             MAIN["capacity"], 2),
        "capacity test": (oracle_greedy.upload(j, t, ones, g, kmin, endless, dev), 0, 1),
    }


def greedy_split_phase(path):
    """Where the walk's time goes: each route on the three chain streams and
    on learning window 0, bit for bit against the plain pass, timed by CUDA
    events; ns and cycles (at the SM clock read during the window's run) per
    walked entry.  The l2 walker's links: the done test alone (a), the alloc
    read (b - a), the used read and capacity test (c - b).  Then window 0 on
    both routes in turns (smem, l2, l2, smem, twice)."""
    window = [a for a in path["attempts"] if a["horizon"] == WEEK][0]
    wargs, wk, wkw = greedy_args(window, torch.device("cuda"))
    inputs = {name: (*v, {}) for name, v in chain_streams().items()}
    inputs["learn window 0"] = (wargs, MAIN["capacity"], wk, wkw)
    split = {}
    for name, (args, cap, k_max, kw) in inputs.items():
        want, _ = greedy_check(args, k_max, cap, WEEK, name, route="smem", **kw)
        greedy_check(args, k_max, cap, WEEK, name, route="l2", **kw)
        walked = want[3].item()
        if name != "learn window 0" and (walked != args[0].shape[0]
                                         or want[1].sum().item() != 0):
            raise AssertionError(f"chain stream {name}: walked {walked}, took "
                                 f"{want[1].sum().item()} servers")
        row = dict(walked=walked, taken=taken_entries(want[0], args[1]))
        for route in oracle_greedy.ROUTES:
            row[f"{route}_ms"] = time_ms(lambda: oracle_greedy.greedy_pass(
                *args, cap, WEEK, k_max, route=route, **kw), 10, warmup=2)
        split[name] = row
    clock = {}

    def sample():
        time.sleep(0.2)
        clock["mhz"] = sm_clock_mhz()

    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(sample)
        time_ms(lambda: oracle_greedy.greedy_pass(*wargs, MAIN["capacity"], WEEK, wk,
                                                  route="l2", **wkw), 40, warmup=2)
        fut.result()
    mhz, max_mhz = clock["mhz"]
    for name, row in split.items():
        for route in oracle_greedy.ROUTES:
            ns = 1e6 * row[f"{route}_ms"] / row["walked"]
            row[f"{route}_ns_per_entry"] = ns
            row[f"{route}_cycles_per_entry"] = ns * mhz / 1e3
        log(f"greedy chain split, {name}: {row['walked']} walked, {row['taken']} taken; l2 "
            f"{row['l2_ms']:.6f} ms = {row['l2_ns_per_entry']:.3f} ns = "
            f"{row['l2_cycles_per_entry']:.1f} cycles per entry; smem {row['smem_ms']:.6f} "
            f"ms = {row['smem_ns_per_entry']:.3f} ns = {row['smem_cycles_per_entry']:.1f} "
            f"cycles; equal to the plain pass on both routes")
    a, b, c = (split[x]["l2_cycles_per_entry"] for x in
               ("done test", "consistency test", "capacity test"))
    links = {"done test": a, "alloc read": b - a, "used and capacity": c - b}
    log(f"greedy chain split of the l2 walker at {mhz} MHz (max {max_mhz}): cycles per "
        f"entry by link {links}; learning window 0 "
        f"{split['learn window 0']['l2_cycles_per_entry']:.1f}")

    def one(route):
        return lambda: oracle_greedy.greedy_pass(*wargs, MAIN["capacity"], WEEK, wk,
                                                 route=route, **wkw)

    turns = {r: [] for r in oracle_greedy.ROUTES}
    for route in ("smem", "l2", "l2", "smem") * 2:
        turns[route].append(time_ms(one(route), 10, warmup=2))
    t = {r: float(np.mean(v)) for r, v in turns.items()}
    ratio = t["smem"] / t["l2"]
    # The smem walker's serial chain is its commits: a round of 32 entries
    # costs what a stream without takes shows, each taken entry the rest.
    w0 = split["learn window 0"]
    round_ms = split["done test"]["smem_ms"] / math.ceil(split["done test"]["walked"] / 32)
    commit_ns = 1e6 * (w0["smem_ms"] - round_ms * math.ceil(w0["walked"] / 32)) / w0["taken"]
    log(f"greedy smem walker: {1e6 * round_ms:.3f} ns per round of 32 entries, "
        f"{commit_ns:.3f} ns = {commit_ns * mhz / 1e3:.1f} cycles per taken entry "
        f"({w0['taken']} taken in learning window 0)")
    log(f"greedy learning window 0 in turns: smem {t['smem']:.6f} ms, l2 {t['l2']:.6f} ms "
        f"per pass, ratio {ratio:.4f} ({turns})")
    if not ratio <= 0.5:
        raise AssertionError(f"the smem walker takes {t['smem']} ms, more than half the "
                             f"l2 walker's {t['l2']} ms")
    return dict(split=split, links_cycles=links, sm_mhz=mhz, sm_max_mhz=max_mhz,
                round_ns=1e6 * round_ms, commit_ns=commit_ns,
                turns=turns, smem_ms=t["smem"], l2_ms=t["l2"], ratio=ratio)


def greedy_span_phase(path, split):
    """Week 0's 552-slot oracle span on both walkers in turns (smem, l2, l2,
    smem, twice), with alloc laid out by window on smem: both times, their
    ratio (at most 0.5), ns per walked entry, the rounds of 32 entries and
    the taken entries, beside what the split's round and commit costs
    predict for them."""
    att = [a for a in path["attempts"] if a["horizon"] > WEEK][0]
    args, k_max, kw = greedy_args(att, torch.device("cuda"))
    cap, h = MAIN["capacity"], att["horizon"]
    want, _ = greedy_check(args, k_max, cap, h, "span week 0", route="smem", **kw)
    greedy_check(args, k_max, cap, h, "span week 0", route="l2", **kw)
    walked, taken = want[3].item(), taken_entries(want[0], args[1])
    rounds = math.ceil(walked / 32)

    def one(route):
        return lambda: oracle_greedy.greedy_pass(*args, cap, h, k_max, route=route, **kw)

    turns = {r: [] for r in oracle_greedy.ROUTES}
    for route in ("smem", "l2", "l2", "smem") * 2:
        turns[route].append(time_ms(one(route), 10, warmup=2))
    t = {r: float(np.mean(v)) for r, v in turns.items()}
    ratio = t["smem"] / t["l2"]
    model_ms = (rounds * split["round_ns"] + taken * split["commit_ns"]) / 1e6
    log(f"greedy oracle span week 0 in turns ({len(att['jobs'])} jobs x {h} slots, alloc "
        f"by window {kw['cells']} bytes): smem {t['smem']:.6f} ms, l2 {t['l2']:.6f} ms per "
        f"pass, ratio {ratio:.4f} ({turns}); {walked} walked of {args[0].shape[0]}, "
        f"{rounds} rounds, {taken} taken; smem {1e6 * t['smem'] / walked:.3f} ns, l2 "
        f"{1e6 * t['l2'] / walked:.3f} ns per walked entry; the split's round and commit "
        f"costs predict {model_ms:.6f} ms on smem")
    if not ratio <= 0.5:
        raise AssertionError(f"span week 0: the smem walker takes {t['smem']} ms, more "
                             f"than half the l2 walker's {t['l2']} ms")
    return dict(turns=turns, smem_ms=t["smem"], l2_ms=t["l2"], ratio=ratio, walked=walked,
                rounds=rounds, taken=taken, cells=kw["cells"], model_ms=model_ms)


def greedy_kernel_phase(path, report):
    """The greedy kernel against its plain version on every pass of the
    oracle path and on a ``solve`` that extends deadlines, each on the route
    it takes; the chain split and the routes in turns; times on the three
    learning windows and the oracle span of week 0."""
    dev = torch.device("cuda")
    cap = MAIN["capacity"]
    for i, att in enumerate(path["attempts"]):
        args, k_max, kw = greedy_args(att, dev)
        plan = oracle_greedy.plan(len(att["jobs"]), att["horizon"], k_max, kw["cells"])
        want, _ = greedy_check(args, k_max, cap, att["horizon"], f"pass {i}", **kw)
        greedy_check(args, k_max, cap, att["horizon"], f"pass {i}", route="l2", **kw)
        log(f"greedy_pass pass {i:2d}: {len(att['jobs'])} jobs x {att['horizon']} slots, "
            f"{len(att['entries'][0])} entries, {want[3].item()} walked, "
            f"{taken_entries(want[0], args[1])} taken; alloc by window {kw['cells']} bytes, "
            f"{plan['smem_bytes']} bytes of shared memory on {plan['route']}: equal to the "
            f"plain version and to the l2 walker bit for bit")
    jobs, ci = extension_jobs()
    cpu = oracle_mod.solve(jobs, ci, 2, backend="device", device="cpu")
    oracle_greedy.reset_launches()
    oracle_mod.reset_stats()
    card = oracle_mod.solve(jobs, ci, 2, backend="device")
    ext_launches = oracle_greedy.launches["greedy_pass"]
    if not (cpu.schedule.extended.any() and ext_launches == oracle_mod.stats["device_passes"] > 1
            and oracle_greedy.launches["smem"] == ext_launches
            and np.array_equal(card.schedule.alloc, cpu.schedule.alloc)
            and np.array_equal(card.schedule.extended, cpu.schedule.extended)
            and all(np.array_equal(getattr(card, n), getattr(cpu, n))
                    for n in ("capacity_curve", "rho_curve", "work_done"))):
        raise AssertionError("solve with deadline extensions: the card and the CPU differ")
    log(f"solve with deadline extensions (48 jobs, capacity 2, 400 slots): {ext_launches} "
        f"passes on smem, {int(cpu.schedule.extended.sum())} slots of extensions, equal on "
        f"the card and the CPU")
    ptx = {name: ptxas_report(report, name) for name in ("greedy_smem_kernel",
                                                         "greedy_pass_kernel")}
    log(f"greedy kernels, ptxas: {ptx}")
    split = greedy_split_phase(path)
    span_turns = greedy_span_phase(path, split)

    learn = [a for a in path["attempts"] if a["horizon"] == WEEK][:MAIN["learn_weeks"]]
    span = [a for a in path["attempts"] if a["horizon"] > WEEK][:1]
    rows = []
    for name, att in zip([f"learn window {i}" for i in range(len(learn))]
                         + ["oracle span week 0"], learn + span):
        args, k_max, kw = greedy_args(att, dev)
        h, n = att["horizon"], len(att["jobs"])
        plan = oracle_greedy.plan(n, h, k_max, kw["cells"])
        route = plan["route"]
        want, plain_s = greedy_check(args, k_max, cap, h, name, **kw)
        walked = want[3].item()
        ms = time_ms(lambda: oracle_greedy.greedy_pass(*args, cap, h, k_max, **kw), 10,
                     warmup=2)
        lengths = np.array([j.length for j in att["jobs"]])
        t = time.perf_counter()
        oracle_mod._greedy_numpy(att["jobs"], att["ci"], cap, h, lengths)
        numpy_s = time.perf_counter() - t
        t = time.perf_counter()
        oracle_mod._build_entries(att["jobs"], att["ci"], h)
        entries_s = time.perf_counter() - t
        nbytes = 16 * walked + 8 * n + 8 * n + 4 * n * h + 4 * h + 4 * n
        b, by = bound_ms(nbytes, 8 * walked)
        log(f"greedy_pass {name} on {route} ({plan['smem_bytes']} bytes of shared "
            f"memory, alloc by window {kw['cells']} bytes): {len(att['entries'][0])} "
            f"entries, {walked} walked, {ms:.6f} ms/pass = {1e6 * ms / walked:.3f} ns "
            f"per walked entry (bound {b:.9f} by {by}: {nbytes} bytes); plain pass "
            f"{1e3 * plain_s:.3f} ms; host numpy pass {1e3 * numpy_s:.3f} ms, of which "
            f"building the entries {1e3 * entries_s:.3f} ms")
        rows.append(dict(window=name, route=route, smem_bytes=plan["smem_bytes"],
                         cells=kw["cells"], entries=len(att["entries"][0]),
                         walked=walked, ms=ms, plain_ms=1e3 * plain_s,
                         numpy_pass_ms=1e3 * numpy_s, build_entries_ms=1e3 * entries_s,
                         bound_ms=b, bound_by=by, bytes=nbytes))
    # Device time from the kernel's own profiler events, with their count:
    # device_ms() averages the card's busy time over the calls, which
    # undercounts when the trace drops events of a long kernel.
    from torch.profiler import ProfilerActivity, profile

    args, k_max, kw = greedy_args(learn[0], dev)
    for _ in range(3):
        oracle_greedy.greedy_pass(*args, cap, WEEK, k_max, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            oracle_greedy.greedy_pass(*args, cap, WEEK, k_max, **kw)
        torch.cuda.synchronize()
    events = [e for e in device_events(prof) if "greedy_smem_kernel" in e.name]
    dms = (sum(e.time_range.elapsed_us() for e in events) / len(events) / 1e3
           if events else None)
    log(f"greedy_pass learn window 0 on smem: device time {dms} ms/pass over the "
        f"{len(events)} kernel events the trace recorded of 10 passes")
    first = rows[0]
    return dict(name="greedy_pass", route="cuda",
                source="src/repro_torch/csrc/oracle_greedy.cu",
                replaces="src/repro/core/oracle.py:177 (_greedy_jax, a jitted "
                         "lax.fori_loop; no Pallas kernel)",
                launches=path["launches"], launches_by_route=path["by_route"],
                path="learn, oracle", max_abs_err=0.0,
                ms=first["ms"], device_ms=dms, plain_ms=first["plain_ms"],
                bound_ms=first["bound_ms"], bound_by=first["bound_by"], library_ms=None,
                previous_ms=split["l2_ms"], device_events=len(events),
                numpy_pass_ms=first["numpy_pass_ms"], serial_chain=first["walked"],
                extension_passes=ext_launches, windows=rows, ptxas=ptx,
                chain_split=split, span_turns=span_turns)


def build_kernels():
    """Build every kernel source at once (one nvcc each), print each
    build's time and the compiler's report, and return the reports."""
    def timed(mod):
        t = time.perf_counter()
        report = mod.build()
        return time.perf_counter() - t, report

    sources = (("src/repro_torch/csrc/knn.cu", knn),
               ("src/repro_torch/csrc/flash_attention.cu", fa),
               ("src/repro_torch/csrc/gating.cu", gating),
               ("src/repro_torch/csrc/score.cu", score),
               ("src/repro_torch/csrc/oracle_greedy.cu", oracle_greedy))
    reports = {}
    with ThreadPoolExecutor(len(sources)) as ex:
        futures = [(src, ex.submit(timed, mod)) for src, mod in sources]
        for src, fut in futures:
            seconds, report = fut.result()
            log(f"built {src} in {seconds:.3f} s")
            if report:
                log(report.strip())
            reports[src] = report
    return reports


def main():
    card = card_line()
    log(f"card: {card}")
    reports = build_kernels()

    kernels = kernel_phase(reports["src/repro_torch/csrc/knn.cu"])
    kernels.append(flash_kernel_phase(reports["src/repro_torch/csrc/flash_attention.cu"]))
    kernels.append(gating_kernel_phase(reports["src/repro_torch/csrc/gating.cu"]))
    path = main_path_phase()
    kernels[0].update(launches=path["main"]["knn_topk"], path="main")
    kernels[1].update(launches=path["batch"]["knn_topk_batch"], path="batch-replay",
                      launches_by_route={r: path["batch"][r] for r in knn.BATCH_ROUTES})
    serve = serve_phase()
    kernels[2].update(launches=serve["launches"]["wgmma"], path="serve-prefill")
    dag = dag_path_phase()
    kernels[3].update(launches=dag["launches"], path="dag-scan")
    windows = oracle_windows()
    score_path = score_ops_phase(windows)
    kernels.append(score_kernel_phase(windows, score_path,
                                      reports["src/repro_torch/csrc/score.cu"]))
    device_path = oracle_path_phase(path["result"])
    kernels.append(greedy_kernel_phase(
        device_path, reports["src/repro_torch/csrc/oracle_greedy.cu"]))
    log(f"wall / learning / execution (s): main path {path['wall_s']:.3f} / "
        f"{path['learn_s']:.3f} / {path['execute_s']:.3f}; oracle path (backend=\"device\") "
        f"{device_path['wall_s']:.3f} / {device_path['learn_s']:.3f} / "
        f"{device_path['execute_s']:.3f}")
    if any(kern["launches"] < 1 for kern in kernels):
        raise AssertionError("a kernel of a path was never launched")
    log(json.dumps({"main_path": {k: v for k, v in path.items()
                                  if k not in ("result", "main", "batch")}}))
    log(json.dumps({"serve_path": {k: v for k, v in serve.items()
                                   if k != "launches"}}))
    log(json.dumps({"dag_path": dag}))
    log(json.dumps({"oracle_path": {k: v for k, v in device_path.items()
                                    if k != "attempts"}}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
