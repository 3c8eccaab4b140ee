"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases, any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``); build the CUDA kernels
   of ``src/repro_torch/csrc`` and time the build;
2. every kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, with times from CUDA events beside the
   bound, the plain version and one library call;
3. the main path: ``repro_torch.experiment.run`` over the quickstart
   scenario with six evaluation weeks (the rolling knowledge base fills to
   its 8 windows = 1344 cases), knowledge base on the card, kernel launches
   counted against the provisioning calls; then the batch path: every
   state carbonflex queried, replayed through ``KnowledgeBase.query_batch``;
   then the same states through the float64 CPU base, counting the slots
   whose ``m_t`` or ``rho`` would differ, and the whole scenario run on the
   CPU, counting the weekly results and slots that differ from the card's
   (information, not a gate); last, the main path again under one
   ``torch.profiler`` trace for the card's busy share.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
import json
import math
import os
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch finds no CUDA device")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import numpy as np  # noqa: E402

from repro_torch.core import policy as policy_mod  # noqa: E402
from repro_torch.core.knowledge import KnowledgeBase  # noqa: E402
from repro_torch.core.provisioning import provision  # noqa: E402
from repro_torch.experiment import Scenario, run  # noqa: E402
from repro_torch.kernels import knn  # noqa: E402

# Published peaks of one H100 SXM at its full 700 W limit (NVIDIA's data
# sheet): HBM3 bandwidth and fp32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

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


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
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


def kernel_phase():
    """Phase 2: kernels against plain versions; times at the main path's
    shapes (one query against the full 1344-case base; one week of 168
    slot states as a batch)."""
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
        dist, idx = knn.knn_topk(cases, q, k)
        torch.cuda.synchronize()
        err1 = max(err1, check_topk(dist, idx, *knn.knn_topk_plain(cases, q, k),
                                    cases, q, f"knn_topk N={n}"))
        log(f"knn_topk     N={n:5d} D={D} k={k}: agrees with the plain version")
    err2 = 0.0
    for nq in (168, 1344):
        cases, qs = inputs(1344, nq)
        dist, idx = knn.knn_topk_batch(cases, qs, K)
        torch.cuda.synchronize()
        err2 = max(err2, check_topk(dist, idx, *knn.knn_topk_batch_plain(cases, qs, K),
                                    cases, qs, f"knn_topk_batch Q={nq}"))
        log(f"knn_topk_batch Q={nq:4d} N=1344 D={D} k={K}: agrees with the plain version")

    cases, q = inputs(1344)
    n = cases.shape[0]
    t1 = dict(
        ms=time_ms(lambda: knn.knn_topk(cases, q, K), 2000),
        plain_ms=time_ms(lambda: knn.knn_topk_plain(cases, q, K), 2000),
        library_ms=time_ms(lambda: torch.topk(torch.cdist(q[None], cases)[0], K,
                                              largest=False), 2000))
    b1, by1 = bound_ms(4 * (n * D + D) + K * 12, 3 * n * D)
    _, qs = inputs(1344, 168)
    t2 = dict(
        ms=time_ms(lambda: knn.knn_topk_batch(cases, qs, K), 500),
        plain_ms=time_ms(lambda: knn.knn_topk_batch_plain(cases, qs, K), 500),
        library_ms=time_ms(lambda: torch.topk(torch.cdist(qs, cases), K, dim=1,
                                              largest=False), 500))
    b2, by2 = bound_ms(4 * (n * D + 168 * D) + 168 * K * 12, 3 * 168 * n * D)
    t1.update(device_ms=device_ms(lambda: knn.knn_topk(cases, q, K)),
              plain_device_ms=device_ms(lambda: knn.knn_topk_plain(cases, q, K)),
              library_device_ms=device_ms(lambda: torch.topk(
                  torch.cdist(q[None], cases)[0], K, largest=False)))
    t2.update(device_ms=device_ms(lambda: knn.knn_topk_batch(cases, qs, K)),
              plain_device_ms=device_ms(lambda: knn.knn_topk_batch_plain(cases, qs, K)),
              library_device_ms=device_ms(lambda: torch.topk(
                  torch.cdist(qs, cases), K, dim=1, largest=False)))
    for name, t, b in (("knn_topk", t1, b1), ("knn_topk_batch", t2, b2)):
        log(f"{name}: {t['ms']:.6f} ms/call (plain {t['plain_ms']:.6f}, "
            f"cdist+topk {t['library_ms']:.6f}, bound {b:.9f}); device time "
            f"{t['device_ms']} ms/call (plain {t['plain_device_ms']}, "
            f"cdist+topk {t['library_device_ms']})")
    return [
        dict(name="knn_topk", route="cuda", source="src/repro_torch/csrc/knn.cu",
             replaces="src/repro/kernels/knn.py:64", max_abs_err=err1,
             bound_ms=b1, bound_by=by1, shape=f"N={n} D={D} k={K}", **t1),
        dict(name="knn_topk_batch", route="cuda", source="src/repro_torch/csrc/knn.cu",
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
    if batch_launches != {"knn_topk": 0, "knn_topk_batch": len(bases)}:
        raise AssertionError(f"batch path launches {batch_launches}")
    for (b, states, _), (m, r, d) in zip(bases, batched):
        for i, s in enumerate(states):
            m1, r1, d1 = b.query(s)
            if not (np.array_equal(m1, m[i]) and np.array_equal(r1, r[i])
                    and np.array_equal(d1, d[i])):
                raise AssertionError("query_batch and query disagree on a state")
    log(f"batch path: {len(calls)} states in {len(bases)} query_batch calls, "
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
    return dict(main=main_launches, batch=batch_launches, flips=flips,
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


def main():
    card = card_line()
    log(f"card: {card}")
    t = time.perf_counter()
    report = knn.build()
    log(f"built src/repro_torch/csrc/knn.cu in {time.perf_counter() - t:.3f} s")
    if report:
        log(report.strip())

    kernels = kernel_phase()
    path = main_path_phase()
    kernels[0].update(launches=path["main"]["knn_topk"], path="main")
    kernels[1].update(launches=path["batch"]["knn_topk_batch"], path="batch-replay")
    if kernels[0]["launches"] < 1 or kernels[1]["launches"] < 1:
        raise AssertionError("a kernel of the path was never launched")
    log(json.dumps({"main_path": {k: v for k, v in path.items()
                                  if k not in ("main", "batch")}}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
