"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases, any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``); build the CUDA kernels
   of ``src/repro_torch/csrc`` (one ``nvcc`` per source, all at once) and
   time each build; then spawn the shard phase's two ranks and the CPU twin
   (``cpu_twin``: the host-only runs that later gates compare with, in a
   process of their own beside the card's phases: the DAG tile,
   ``sweep-full``, ``geo-full``, the resilience phase's runs and the
   tuner's on the CPU's vector engine, the examples with ``--device
   cpu``); the flash sources' builds are not waited for here;
2. every kernel against its plain PyTorch version on the card, at the
   shapes its path gives it, with times from CUDA events beside the
   bound, the plain version and one library call (the single-query KNN
   kernel through ``knn_lookup``, the per-slot lookup with the query as a
   launch parameter and the neighbours written into pinned host memory,
   equal bit for bit to ``knn_topk`` on a device query); ``gqa_flash`` on each
   shape's route (the Hopper kernel for bf16 at D 64, 112 and 128), its
   launches counted by route, and at the prefill's shape the Hopper kernel
   timed in turns with the retained mma.sync kernel (at most half its time),
   at zamba2-7b's forward shape (D 112) beside the plain version and SDPA,
   and at ``train_carbon_aware``'s tiny preset (bf16 D 16 on the Hopper
   kernels' 16-wide tiles, forward with its LSE and the wgmma backward pair,
   the yardsticks beside them: the mma.sync forward, the mma and fma
   backward routes; also at a rank's batch and an edge shape) beside the
   plain versions and SDPA; ``gqa_flash``'s backward (the wgmma pair and the fma
   route's stats, dK/dV and dQ kernels) against the plain backward at the
   train step's shape (bf16, S 2304, Hq 16, Hkv 8, D 128) and at the
   launcher's fp32 D-32 shape (the tiled pair, fp32's route, and fma beside
   it), twice with equal bits, each kernel timed beside its bound, the
   plain backward and SDPA's backward; every head dim and dtype (the
   head-dim sweep: the staged Hopper route off a multiple of 8, the narrow
   tiles at every 16-bit D in 1..32, fp32 and fp64 on the tiled forward and
   backward, run twice with equal bits) against the plain versions, the new
   routes timed in turns against the routes they replaced (fp32 D 100: the
   tiled forward against flash_f32_kernel, at most FP32_FWD_RATIO of it; the
   tiled backward and each of its kernels against the fma route, at most
   FP32_BWD_RATIO of it; bf16 D 32: the narrow forward against mma.sync, at
   most NARROW_FWD_RATIO, the narrow backward pair against the mma pair, at
   most NARROW_BWD_RATIO, by device time in turns); the
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
   whose ``m_t`` or ``rho`` would differ; the main path again under one
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
   the mma.sync kernel, and a traced run; then the MoE serving path:
   qwen3-moe-235b-a22b at full width with 2 of its 94 layers (bf16, random
   weights from seed 0; ~12.3 GB) through ``greedy_generate`` at the same
   sizes, gated on 2 flash launches in prefill, all on the Hopper kernel
   (D 64, 16 query heads a KV head), 0 in decode; every dispatch of the run
   (top-k ids, sort order, slots, kept pairs, source tokens at C = 640 in
   prefill and C = 1 in decode) equal bit for bit to the plain dispatch on
   the CPU on the card's own router probabilities; layer 0's MoE output
   within 1e-2 relative L2 of an fp32 evaluation of the same routing;
   layer 0's q/k/v through the kernel against the plain version (v, of std
   ~20 under the reference init, divided by the power of two nearest its
   std for the elementwise limits; unscaled within the relative L2 limit)
   and timed beside SDPA; a warm run with the same tokens; finite logits,
   ids in range, the cache (2, 4, 2112, 4, 64); a traced run; then rwkv6-7b
   and zamba2-7b at full width and full depth (bf16, random weights from
   seed 0; 15.1 and 13.5 GB), one after the other, each freed before the
   next: init (seconds, bytes, peak); the forward at 4 x 2048 (rwkv6: no
   flash launch; zamba2: 13, one per shared-block application, all on the
   Hopper kernel at D 112), every chunked recurrence's largest chunk decay
   sum and exponent of k * exp(-cum) recorded, every non-finite value held
   to the reference expression's fp32 overflow (rwkv6's forward overflows
   in layer 1, zamba2's in layer 18); ``greedy_generate`` on 4 prompts of
   32 tokens, 16 new ones (the prefill replays the prompt through the
   decode step, as the reference does), twice, the same tokens, finite
   logits, no flash launch; the first run's 48 steps of recurrence inputs
   of the first, middle and
   last layer (and the forward's first overflowing one) through the chunked
   form against the sequential oracle in fp32 (relative L2 <= 1e-4 on the
   (row, head) pairs that do not overflow); a traced short run; then
   training: internvl2-2b at full width and depth (1,889,146,880 params;
   fp32 master weights and AdamW moments, 21.1 GiB; bf16 compute) on
   ``PrefetchLoader`` batches of 4 x 2048 tokens behind the 256-position
   prefix: the chunked attention's forward and backward (loss and gradient
   norm printed beside the flash step's, and layers 0, 12 and 23's q/k/v/dO,
   on which the backward kernels are held against the plain backward), the
   flash train step twice from one state (equal bits; 48 flash launches, all
   on the Hopper kernel, and 24 of each backward kernel; every leaf moved),
   and between the two the same step through ``make_train_step(cfg,
   rules)`` on a 1 x 1 mesh of a one-rank NCCL group (bit for bit), 3 timed
   steps split into forward + backward and optimizer, and a traced
   one; then ``python -m repro_torch.launch.train --arch stablelm-1.6b
   --reduced`` in its own process, the elastic trainer's plan of k 1, 0, 1
   with a fault, a second trainer resuming from its checkpoint and the
   launcher with ``--compress`` (launches against the steps taken); then
   the sharding layer on two ranks spawned once on the card over gloo
   (``shard_phase``): qwen3-moe's MoE layer at full width, 64 experts a
   rank (kept pairs equal to the global dispatch's, the output within 1e-2
   of ``moe_block_global``), the sequence-sharded decode attention at
   llama3-8b's decode shape across the split (the new K/V in one slice,
   within 1e-3 of the one-device attention), llama3-8b's tensor-parallel
   prefill at full width with 2 layers (2 ``wgmma`` launches on 16 local
   heads a rank, each layer within 1e-3 of the one-rank layer) and the
   elastic trainer at k 1, 2, 1 with a fault and a resume (launches equal
   the steps each rank took, losses within 1e-3 of two CPU ranks), and (g)
   ``repro_torch.examples.train_carbon_aware --preset tiny --max-dp 2
   --fault-at 6`` (the plan the host computes, its steps and rescales, one
   recovery, the D-16 route's launches against the steps each rank took);
5. the DAG path: ``run(Scenario(dag=DagConfig(), engine="scan"))`` on the
   paper's 150-server cluster (one week of 5962 tasks and 5924 edges), the
   slot loop on the card and every slot's release (the in-degree decrement,
   the new in-degrees and the rows they free) through one launch of the
   release kernel ``dep_release_csr``, equal to the same scenario on the
   CPU's vector engine in every weekly result and every slot; the
   independent twin (no edges, no gating launch); then one full tile of 64
   dag-carbon cells (8 regions x 8 CI seeds) through ``simulate_many``,
   each equal to its CPU vector run (the CPU twin's), and one traced chunk of it for the
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
   time on each); times beside the host numpy pass;
7. sweeps, forecast models and receding-horizon execution: the four golden
   grids of ``tests/data/`` (plain, DAG, forecast axis, MPC) rebuilt with
   ``Sweep`` on the card, on the vector and scan engines with the oracle
   passes on the greedy kernel, each byte for byte the fixture file (the
   DAG grid's release launches == its DAG steps; on the MPC grid only the
   oracle-estimated cells delegated, fill launches == fill steps); then
   ``sweep-full``: the 150-server cluster in all ten regions x seed 1 x
   carbon-agnostic, wait-awhile, carbonflex, carbonflex-mpc,
   carbonflex-scale and oracle-estimated (60 cells; each knowledge base
   learned on the card, the slot loop on the card, carbonflex's lookups
   through ``knn_query_kernel``, the oracle passes through the greedy
   kernel, carbonflex-scale's fill through ``capacity_fill``), its JSON
   byte for byte the same sweep on the CPU's vector engine with the numpy
   pass (the CPU twin's), launches gated against provisioning calls, device passes and fill
   steps, every fill launch of a path on the compact route; both fill routes
   against the plain version (random inputs at B=1 and 64 and n_pad 256,
   2048, 6144, edge cases, the mpc-scale tile's own recorded chunk), then at
   B=64 the compact kernel against the chunked one in turns (device time at
   most ``WALK_RATIO`` of it, no ptxas spill) beside its floor and bound;
   one traced mpc-scale chunk for the card's busy share;
8. geo-distributed scheduling: ``geo-full``, the paper's 150-server cluster
   split over south-australia and california, seeds 7, 8, 9 x geo-static,
   geo-greedy and geo-flex through ``Sweep`` on the card's scan engine (one
   tile per policy, each slot step's placement, migration and capacity walk
   one launch of ``geo_walk``), its JSON byte for byte the same sweep on the
   CPU's vector engine (launches == geo steps, all on the compact route,
   nothing delegated); a three-region world whose jobs take k_min in {1, 2,
   4} under geo-greedy and geo-flex, equal to the CPU's vector engine in
   every compared field; both routes against ``geo_resolve_plain`` on the
   recorded geo-flex steps, 16 random inputs and 3 edge cases, exactly; on
   the busiest recorded step the compact kernel against the chunked one in
   turns (device time at most ``WALK_RATIO`` of it, no ptxas spill) beside
   its floor, plain version and bound;
9. resilience: ``chaos-full``, the 150-server cluster in south-australia
   (3 learning weeks, ``MPCConfig(scale_rho=0.3)``) under a carbon-feed
   outage (``CarbonDataOutage(rate=0.04, mean_duration=6, seed=1)``), seeds
   1 and 2 x no faults, iid stragglers/failures, correlated failure domains
   and preemption x carbon-agnostic, wait-awhile, carbonflex,
   carbonflex-mpc and carbonflex-scale (40 cells) on the card's scan engine
   with the oracle passes on the greedy kernel, its JSON byte for byte the
   same sweep on the CPU's vector engine with the numpy pass: the 8
   outage-only cells of the four native kinds on the card's slot loop (their
   tables from the degraded view), the 30 faulted cells delegated on their
   fault process and the 2 outage-only carbonflex cells on their policy;
   ``knn_query_kernel`` launches == provisioning calls, fill launches ==
   fill steps (all compact), greedy launches == device passes, every row
   with degraded slots; ``geo-chaos``, ``geo-full``'s world under the same outage x no
   faults and correlated failure domains (18 cells), byte for byte the CPU's
   vector engine, ``geo_walk`` launches == geo steps of the 9 outage cells
   (all compact), the 9 faulted ones delegated; the DAG path under the outage on the scan
   engine, equal to the CPU's vector engine in every weekly result, slot
   and resilience record, one release launch per DAG step; the golden
   serving grid through the card's ``Sweep``, byte for byte the fixture;
   the host tables of one 168-slot chunk (wait-awhile's eligibility,
   geo-flex's tables) on the fresh feed and on the degraded view.
10. telemetry: every path again with a ``Telemetry(MemoryRecorder(),
   PhaseProfiler())`` attached, on the card's scan engine and on the CPU's
   vector engine: ``chaos-full`` (forecast reads, fault events; the two
   recorded carbonflex-scale cells leave the slot loop,
   ``stats["telemetry_delegated"]`` == 2, so no fill launch), ``geo-full``
   (migrations decoded from the geo loop's grids), the DAG path's week
   (admissions on release), the main path through ``run(...,
   telemetry=)`` (the ``"{policy}/w{week}"`` labels, the four phases), the
   golden serving grid (tier switches) and an ``OracleGap`` grid (capacity
   40, one learning week, seed 1, a perfect and a sigma-0.2 forecast);
   gates: the card's and the CPU's event streams equal event for event per
   run label, each recorded JSON (or weekly result) equal to the
   recorder-off run of the earlier phases, the attributions equal field for
   field with ``check()`` passing, and each kernel's launches equal to its
   count (knn == provisioning calls, greedy == device passes, release ==
   DAG steps, ``geo_walk`` == geo steps, fill == fill steps; the geo walk's
   and the fill's all compact); printed: each
   path's phase table and the event counts by kind.
11. the MPC knob tuner (``repro_torch.experiment.tune_policy``) at the
   reference script's full settings: carbonflex-mpc (18 knob cells) and
   carbonflex-scale (54) at seeds 1 and 3, capacity 40, 2 learning weeks,
   on the card's scan engine against the port's vector engine on the CPU:
   gap dicts float for float and the printed lines equal; ``knn_topk``
   launches == the carbonflex row's provisioning calls, ``capacity_fill``
   launches == fill steps (> 0 on the scale grid only, all compact), 2 rows
   delegated.
12. the examples (``repro_torch.examples``): the eight batch examples at
   the reference's CI settings (``--tiny``; ``cluster_sim_year --weeks 1
   --capacity 10``) on the card, each one's printed lines (less telemetry's
   phase seconds) and returned study equal to the same example on the CPU
   (the CPU twin's), knn launches == provisioning calls and every other
   kernel's launches == its loop's steps; ``serve_elastic`` at its defaults
   (one fp32 flash launch a layer in prefill, none in decode, ids in range,
   finite logits; the greedy tokens beside the CPU run's, printed); and
   ``train_carbon_aware --preset 100m --max-dp 1`` in this process (the
   plan the host computes, its steps, no rescale or recovery, finite
   losses, the wgmma forward and backward launches its steps imply).
13. the dry-run and the roofline profiles: ``repro_torch.launch.dryrun``
   counts all 32 live (architecture x shape) cells' sharded steps on the
   ``meta`` device, rank 0's program on a stand-in of the 16x16 mesh, in
   ``DRYRUN_WORKERS`` spawned processes into a temporary
   ``results/dryrun_opt`` (each cell's FLOPs, bytes and collectives per
   device, its compute, memory and collective terms, the dominant one, the
   elasticity of its profile and its counting seconds printed; gated on
   every cell's positive collective payload, rwkv6's and zamba2's
   ``long_500k`` at batch 1 included; the train cells' collective term
   printed beside the analytic data-parallel term the profiles use); the
   count of internvl2-2b at the training phase's shape (4 x 2048 tokens
   behind the 256-position prefix, one device), as the card ran it (the
   flash kernels' work) and as the cells count it (the chunked attention),
   against the step the training phase measured (gates: counted FLOPs at
   least the step's model FLOPs; the flash count's roofline no more than
   the measured step); then ``Scenario(**MAIN, elasticity="tpu")`` from
   that directory through ``run()`` on the card and on the CPU (gates: 0
   weekly results and 0 slots differ, ``knn_topk`` launches == provisioning
   calls, every job one of the ten architectures).
   Last, the main, oracle, sweep, geo, resilience, telemetry, MoE serving,
   tuner and dry-run paths' wall times side by side, and each phase's wall.

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
import torch.utils.checkpoint

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
from repro_torch.core.baselines import WaitAwhilePolicy  # noqa: E402
from repro_torch.core.dag import DagCarbonPolicy  # noqa: E402
from repro_torch.core.faults import (CarbonDataOutage, CorrelatedFaults, IidFaults,  # noqa: E402
                                     PreemptionFaults)
from repro_torch.core.forecast import NoisyForecast, QuantileForecast  # noqa: E402
from repro_torch.core.geo import GeoFlexPolicy, GeoGreedyPolicy, GeoStaticPolicy  # noqa: E402
from repro_torch.core.mpc import CarbonFlexScalePolicy, MPCConfig  # noqa: E402
from repro_torch.core.simulator import SimCase, pack, simulate, simulate_many  # noqa: E402
from repro_torch.experiment import (DEFAULT_DAG_POLICIES, DEFAULT_GEO_POLICIES,  # noqa: E402
                                    DEFAULT_SERVE_POLICIES, OracleGap, Scenario,
                                    ServingConfig, Sweep, run, sigma_ladder)
from repro_torch.experiment import sweep as sweep_mod  # noqa: E402
from repro_torch.experiment import tune_policy  # noqa: E402
from repro_torch.experiment.scenario import CI_MARGIN_HOURS, WEEK  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fill, gating, geo_walk, knn, ops, oracle_greedy, score  # noqa: E402
from repro_torch.models import forward as model_forward  # noqa: E402
from repro_torch.models import init_params, param_count, ssm, transformer  # noqa: E402
from repro_torch.models.common import chunked_attention, rms_norm, rope  # noqa: E402
from repro_torch.serve import greedy_generate, make_prefill  # noqa: E402
from repro_torch.telemetry import MemoryRecorder, PhaseProfiler, Telemetry, attribute  # noqa: E402
from repro_torch.traces import DagConfig  # noqa: E402
from repro_torch.traces import workloads  # noqa: E402

# Published peaks of one H100 SXM at its full 700 W limit (NVIDIA's data
# sheet): HBM3 bandwidth, fp32 outside the tensor cores, bf16 dense on the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

MAIN = dict(region="south-australia", capacity=40, learn_weeks=3, seed=1,
            eval_weeks=6)
# What the earlier phases produced with no recorder attached (the main and
# DAG paths' results, geo-full's and chaos-full's JSON on the card), for the
# telemetry phase to hold its recorded runs against.
RECORDER_OFF = {}
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


def device_trace(fn, iters: int = 200, warmup: int = 20) -> tuple[float, int]:
    """The card's busy microseconds that ``torch.profiler`` records over
    ``iters`` calls of ``fn`` (after ``warmup`` calls), and the number of
    device events it recorded."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = device_events(prof)
    return busy_us(events), len(events)


def device_ms(fn, iters: int = 200, warmup: int = 20) -> float | None:
    """Mean device milliseconds per call: the card's busy time that
    ``torch.profiler`` records over ``iters`` calls after ``warmup`` (None
    when the profiler records no device time)."""
    total_us, _ = device_trace(fn, iters, warmup)
    return total_us / iters / 1e3 if total_us > 0 else None


def device_ms_again(fn, iters: int, per_call: int = 1) -> float | None:
    """Device milliseconds a call of ``fn``, which makes ``per_call`` device
    events (kernels) a call: the busy time ``torch.profiler`` records over
    ``iters`` calls after one warm-up call, per recorded event, times
    ``per_call``.  The profiler drops some events of long kernels (1 or 3 of
    5 recorded on an H100), so the busy time over the calls would undercount;
    a trace that recorded none is taken again, at most four times (three
    empty traces in a row were seen for the tiled dQ kernel on an H100);
    None if every one was empty."""
    for _ in range(5):
        us, n = device_trace(fn, iters, 1)
        if us > 0:
            if n < per_call * iters:
                log(f"device time: {n} device events recorded of {per_call * iters}")
            return us / n * per_call / 1e3
    return None


def in_turns(runs, rounds: int = 2) -> dict:
    """``device_ms`` of each function of ``runs`` in turns, there and back
    (a, b, b, a, ...) ``rounds`` times: per key the list of its turns.  A
    turn whose trace holds no device time is taken again (at most twice).
    The profiler loses some events of a long run of short calls (on an
    H100, 1-7 of 200 calls of a 4 µs kernel, now and then most), and a turn's
    busy time then undercounts by what it lost; so each turn's time per call
    is its busy time per recorded event times the events a call makes (the
    most any turn of its key recorded, over the calls, rounded).  With no
    event lost that is the busy time over the calls."""
    iters = 200
    taken = []
    for _ in range(rounds):
        for key in list(runs) + list(runs)[::-1]:
            for _ in range(3):
                us, n = device_trace(runs[key], iters)
                if us > 0:
                    break
            if us <= 0:
                raise AssertionError(f"{key}: the profiler recorded no device time")
            taken.append((key, us, n))
    per_call = {key: max(1, round(max(n for k, _, n in taken if k == key) / iters))
                for key in runs}
    turns = {key: [] for key in runs}
    for i, (key, us, n) in enumerate(taken):
        if n < per_call[key] * iters:
            log(f"in turns: {key} turn {i} recorded {n} device events of "
                f"{per_call[key] * iters}")
        turns[key].append(us / n * per_call[key] / 1e3)
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
    RECORDER_OFF["main"] = res

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
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2, torch.float16: 1e-2,
             torch.float64: 2e-5}
# Relative L2 of the whole output against the plain version.  At these key
# counts unit-normal inputs give outputs of std ~sqrt(e/Sk) = 0.04, below
# the bf16 atol, so the elementwise test alone would pass a kernel whose
# outputs were all 30 % too small; bf16 rounding of P and of the output
# leaves a few 1e-3.  fp16 rounds P and the output to 11 significant bits
# where bf16 keeps 8, so its limits are bf16's over 5 (an eighth of the step,
# with room); float64 runs the fp32 kernel on fp32 copies, held as fp32.
FLASH_REL = {torch.float32: 2e-5, torch.bfloat16: 1e-2, torch.float16: 2e-3,
             torch.float64: 2e-5}
# The same, for each layer's attention output on the model's own q/k/v
# against the chunked attention: near one-hot softmax under the reference
# init leaves ~2e-4 (1.5e-4 median over llama3-8b's 32 layers on an H100).
ATTN_REL = 1e-3
# (name, B, Sq, Sk, Hq, Hkv, D, causal_offset): the prefill's shape first,
# then zamba2-7b's forward (its shared attention at head dim 112), then the
# train step's (internvl2-2b, 2048 tokens behind its 256-position prefix);
# last, train_carbon_aware's tiny preset (head dim 16: its batch of 4 and a
# rank's 2 at S 128) and an edge shape of that head dim
FLASH_SHAPES = [
    ("prefill", 4, 2048, 2048, 32, 8, 128, 0),
    ("zamba2", 4, 2048, 2048, 32, 32, 112, 0),
    ("train", 4, 2304, 2304, 16, 8, 128, 0),
    ("decode-like", 4, 1, 2112, 32, 8, 128, 2111),
    ("ragged", 2, 130, 330, 8, 2, 64, 200),
    ("multi-head", 2, 300, 300, 4, 4, 32, 0),
    ("tiny", 4, 128, 128, 4, 2, 16, 0),
    ("tiny-rank", 2, 128, 128, 4, 2, 16, 0),
    ("tiny-edge", 2, 130, 167, 4, 2, 16, 37),
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


def card_normal(gen, *shapes, dtype=torch.bfloat16):
    """Unit-normal tensors of ``shapes`` drawn on the card by a CUDA
    generator seeded from ``gen`` (numpy), rounded to ``dtype``: the timed
    shapes' hundreds of millions of values, which numpy would draw on the
    host for seconds."""
    g = torch.Generator(device="cuda")
    g.manual_seed(int(gen.integers(2**62)))
    return [torch.randn(shape, generator=g, device="cuda").to(dtype) for shape in shapes]


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


def elt_type(name: str) -> str:
    """The element type a mangled kernel name was instantiated for."""
    return "fp16" if "6__half" in name else "bf16" if "__nv_bfloat16" in name else "fp32"


def wgmma_template(name: str) -> tuple[int, int]:
    """(tile width, DO) of a mangled Hopper kernel name: DO the head dim of a
    pinned instantiation, 0 (a run-time multiple of 8) or -1 (any run-time
    head dim, mangled ``Lin1``)."""
    tile, do = re.search(r"ILi(\d+)ELi(n?\d+)E", name).groups()
    return int(tile), -int(do[1:]) if do.startswith("n") else int(do)


def pinned_wgmma(name: str) -> bool:
    """Whether a mangled Hopper kernel name is one of the pinned bf16
    instantiations (D 64, 112 or 128 at compile time)."""
    return re.search(r"ILi(\d+)ELi(n?\d+)E", name) is not None \
        and wgmma_template(name)[1] > 0 and "__nv_bfloat16" in name


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
    the plain version, each on its route's kernel, and the prefill's and
    zamba2's shapes also on the retained mma.sync kernel; then, at the
    prefill's shape in bf16 and in turns, the Hopper kernel, the mma.sync
    kernel, the plain version and SDPA, by CUDA events and by profiler
    device time; last, the same (without mma.sync) at zamba2's shape, head
    dim 112.  Returns the kernel line's entry of each shape."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = np.random.default_rng(1)
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    rels = {torch.float32: 0.0, torch.bfloat16: 0.0}
    err112, rel112 = 0.0, 0.0
    err16 = {"wgmma": (0.0, 0.0), "mma_sync": (0.0, 0.0)}
    fa.reset_launches()
    expect = dict.fromkeys(fa.launches, 0)
    for name, b, sq, sk, hq, hkv, d, off in FLASH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(gen, b, sq, sk, hq, hkv, d, dtype)
            # the yardstick mma.sync beside the Hopper kernel at D 128, 112
            # and the narrow widths
            kernels = [None] + (["mma_sync"] if (name in ("prefill", "zamba2")
                                                 or d <= fa.WGMMA_NARROW)
                                and dtype == torch.bfloat16 else [])
            for kern in kernels:
                e, r = flash_check(q, k, v, off, f"gqa_flash {name} {dtype} {kern}", kern)
                route = kern or fa.route(dtype, d)
                expect["gqa_flash"] += 1
                expect[route] += 1
                if route != "mma_sync":
                    err[dtype], rels[dtype] = max(err[dtype], e), max(rels[dtype], r)
                if d == 112 and route == "wgmma":
                    err112, rel112 = max(err112, e), max(rel112, r)
                if d == 16 and route in err16:
                    err16[route] = (max(err16[route][0], e), max(err16[route][1], r))
                log(f"gqa_flash {name:11s} B={b} Sq={sq} Sk={sk} Hq={hq} Hkv={hkv} "
                    f"D={d} offset={off} {str(dtype)[6:]} on {route}: agrees with the "
                    f"plain version (max abs diff {e}, relative L2 {r}, limit "
                    f"{FLASH_REL[dtype]})")
    if fa.launches != expect:
        raise AssertionError(f"flash launches by route {fa.launches}, expected {expect}")
    lse_check = flash_lse_check()

    ptx = ptxas_report(report, "flash_wgmma_kernel")
    for name, rep in ptx.items():
        tile, d = wgmma_template(name)
        what = {0: "run-time D", -1: "any run-time D"}.get(d, d)
        log(f"flash_wgmma_kernel<{tile}, {what}, {elt_type(name)}>: ptxas {rep}, "
            f"dynamic shared memory {fa.wgmma_smem_bytes(tile)} bytes, "
            f"{fa.wgmma_stages(tile)} stages")
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
    d112 = flash_d112_timing(gen, err112, rel112)
    d16 = flash_d16_timing(gen, err16)
    return dict(name="gqa_flash", route="cuda", kernel="flash_wgmma_kernel",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:94",
                max_abs_err=err[torch.bfloat16], max_abs_err_f32=err[torch.float32],
                rel_l2=rels[torch.bfloat16], rel_l2_f32=rels[torch.float32],
                bound_ms=bound, bound_by=by, tflops=flops / t["ms"] / 1e9,
                bound_share=bound / t["ms"],
                shape=f"B={b} Sq={sq} Sk={sk} Hq={hq} Hkv={hkv} D={d} bf16 causal",
                sdpa_max_abs_diff=lib_diff, ptxas=ptx, turns=turns, lse=lse_check, **t), d112, d16


# The forward's LSE against the plain one: fp32 sums of up to ~2000
# exponentials in another order, ex2.approx, on values of ~10 (readings
# 9.5e-7 to 1.9e-6 on an H100 80GB HBM3).
LSE_TOL = 1e-4


def flash_lse_check():
    """The Hopper forward and the mma.sync forward, each with and without
    its LSE, at the prefill's (D 128), zamba2's (D 112), the ragged (D 64),
    the tiny preset's and the multi-head shapes (the narrow tiles, D 16 and
    32): the output equal bit for bit (the serving path asks for none), the
    LSE within LSE_TOL of ``gqa_flash_lse_plain``.  Returns each (shape,
    kernel)'s largest LSE difference."""
    gen = np.random.default_rng(2)
    out = {}
    for name, b, sq, sk, hq, hkv, d, off in FLASH_SHAPES:
        if name not in ("prefill", "zamba2", "ragged", "tiny", "multi-head"):
            continue
        q, k, v = flash_inputs(gen, b, sq, sk, hq, hkv, d, torch.bfloat16)
        want = fa.gqa_flash_lse_plain(q, k, off)
        for kernel in ("wgmma", "mma_sync"):
            got, lse = fa.launch(q, k, v, off, kernel, with_lse=True)
            same = torch.equal(got, fa.launch(q, k, v, off, kernel))
            err = (lse - want).abs().max().item()
            if not (same and err <= LSE_TOL):
                raise AssertionError(f"gqa_flash {name} on {kernel} with the LSE: output equal "
                                     f"{same}, LSE off by up to {err} (limit {LSE_TOL})")
            out[f"{name} {kernel}"] = err
            log(f"gqa_flash {name} D={d} on {kernel}: the output with and without the LSE "
                f"equal bit for bit; LSE within {err} of the plain one")
    return out


def flash_d112_timing(gen, err, rel):
    """zamba2-7b's forward shape (head dim 112, on the Hopper kernel's
    D = 128 tiles) in bf16: the kernel, the plain version and SDPA in turns
    by CUDA events, and by profiler device time, beside the bound."""
    _, b, sq, sk, hq, hkv, d, off = FLASH_SHAPES[1]
    q, k, v = flash_inputs(gen, b, sq, sk, hq, hkv, d, torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def kernel():
        return fa.launch(q, k, v, off, "wgmma")

    def plain():
        return fa.gqa_flash_plain(q, k, v)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    lib_diff = (library().transpose(1, 2).float() - kernel().float()).abs().max().item()
    runs = dict(ms=(kernel, 50, 5), plain_ms=(plain, 10, 3), library_ms=(library, 50, 5))
    turns = {key: [] for key in runs}
    for key in list(runs) + list(runs)[::-1]:
        fn, iters, warmup = runs[key]
        turns[key].append(time_ms(fn, iters, warmup=warmup))
    t = {key: float(np.mean(v)) for key, v in turns.items()}
    t.update(device_ms=device_ms(kernel, 20), plain_device_ms=device_ms(plain, 10),
             library_device_ms=device_ms(library, 20))
    nbytes, flops = flash_work(b, sq, sk, hq, hkv, d, off, 2)
    bound, by = bound_ms(nbytes, flops, BF16_FLOP_PER_S)
    log(f"gqa_flash zamba2 shape bf16 D=112, in turns {turns}")
    log(f"gqa_flash zamba2 shape bf16 D=112: Hopper kernel (D=128 tiles) {t['ms']:.6f} "
        f"ms/call ({flops / t['ms'] / 1e9:.3f} TFLOP/s, {bound / t['ms']:.4f} of the "
        f"bound), plain {t['plain_ms']:.6f}, SDPA {t['library_ms']:.6f}, bound {bound:.6f} "
        f"by {by}: {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB; device time "
        f"{t['device_ms']} ms/call (plain {t['plain_device_ms']}, SDPA "
        f"{t['library_device_ms']}); SDPA differs from the kernel by up to {lib_diff}")
    return dict(name="gqa_flash_d112", route="cuda", kernel="flash_wgmma_kernel<128, 112>",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:94",
                max_abs_err=err, rel_l2=rel, bound_ms=bound, bound_by=by,
                tflops=flops / t["ms"] / 1e9, bound_share=bound / t["ms"],
                shape=f"B={b} Sq={sq} Sk={sk} Hq={hq} Hkv={hkv} D={d} bf16 causal",
                sdpa_max_abs_diff=lib_diff, turns=turns, **t)


def flash_d16_timing(gen, errs):
    """train_carbon_aware's tiny preset (head dim 16, bf16: the Hopper
    kernel's 16-wide tiles) at its batch of 4, S 128: the kernel, the
    mma.sync kernel it replaced (the yardstick, by name), the plain version
    and SDPA in turns by CUDA events, and by profiler device time, beside
    the bound; both sit at the launch floor, so no ratio is gated.  Returns
    the kernel's entry and the yardstick's."""
    _, b, sq, sk, hq, hkv, d, off = next(x for x in FLASH_SHAPES if x[0] == "tiny")
    q, k, v = flash_inputs(gen, b, sq, sk, hq, hkv, d, torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def kernel():
        return fa.launch(q, k, v, off)

    def previous():
        return fa.launch(q, k, v, off, "mma_sync")

    def plain():
        return fa.gqa_flash_plain(q, k, v)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    lib_diff = (library().transpose(1, 2).float() - kernel().float()).abs().max().item()
    runs = dict(ms=(kernel, 200, 20), previous_ms=(previous, 200, 20), plain_ms=(plain, 50, 5),
                library_ms=(library, 200, 20))
    turns, t = in_turns_ms(runs)
    t.update(device_ms=device_ms(kernel, 50), previous_device_ms=device_ms(previous, 50),
             plain_device_ms=device_ms(plain, 20), library_device_ms=device_ms(library, 50))
    nbytes, flops = flash_work(b, sq, sk, hq, hkv, d, off, 2)
    bound, by = bound_ms(nbytes, flops, BF16_FLOP_PER_S)
    log(f"gqa_flash tiny shape bf16 D=16, in turns {turns}")
    log(f"gqa_flash tiny shape bf16 D=16: Hopper kernel (16-wide tiles) {t['ms']:.6f} ms/call "
        f"({bound / t['ms']:.4f} of the bound), mma.sync kernel {t['previous_ms']:.6f}, plain "
        f"{t['plain_ms']:.6f}, SDPA {t['library_ms']:.6f}, bound {bound:.6f} by {by}: "
        f"{flops / 1e9:.6f} GFLOP, {nbytes / 1e6:.6f} MB; device time {t['device_ms']} ms/call "
        f"(mma.sync {t['previous_device_ms']}, plain {t['plain_device_ms']}, SDPA "
        f"{t['library_device_ms']}); SDPA differs from the kernel by up to {lib_diff}")
    common = dict(route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
                  replaces="src/repro/kernels/flash_attention.py:94", bound_ms=bound,
                  bound_by=by, plain_ms=t["plain_ms"], plain_device_ms=t["plain_device_ms"],
                  library_ms=t["library_ms"], library_device_ms=t["library_device_ms"],
                  shape=f"B={b} Sq={sq} Sk={sk} Hq={hq} Hkv={hkv} D={d} bf16 causal",
                  sdpa_max_abs_diff=lib_diff, turns=turns)
    entry = dict(name="gqa_flash_d16", kernel="flash_wgmma_kernel<16, 0, __nv_bfloat16>",
                 max_abs_err=errs["wgmma"][0], rel_l2=errs["wgmma"][1], ms=t["ms"],
                 device_ms=t["device_ms"], bound_share=bound / t["ms"],
                 previous="flash_mma_kernel<__nv_bfloat16, 16>", previous_ms=t["previous_ms"],
                 previous_device_ms=t["previous_device_ms"], **common)
    yardstick = dict(name="gqa_flash_mma_sync_d16",
                     kernel="flash_mma_kernel<__nv_bfloat16, 16> (kernel=\"mma_sync\")",
                     max_abs_err=errs["mma_sync"][0], rel_l2=errs["mma_sync"][1],
                     ms=t["previous_ms"], device_ms=t["previous_device_ms"],
                     bound_share=bound / t["previous_ms"], **common)
    return entry, yardstick


# --- gqa_flash at every head dim and float dtype ------------------------------

# Head dims of the sweep, none of them a pinned route's: below 16 and 24
# (the narrow wgmma tiles, 16 and 32 wide), between the wgmma tiles'
# widths, not a multiple of 8 (33, 100: the wgmma route on staged copies),
# past 128 (160, 192, 256: the wide tiles); each in fp32, bf16 and fp16,
# then in bf16 and fp16 136 and 200 (the wide tiles 192 and 256 off their
# edges) and 250 (past 128 off a multiple of 8: staged, on the 256-wide
# tiles), fp16 at the pinned head dims, float64 (the fp32 kernels on
# copies) at two, and bf16 and fp16 at every other D in 1..32 (the narrow
# tiles at each head dim they take, staged off a multiple of 8).
FLASH_DIMS = (8, 24, 33, 40, 72, 80, 96, 100, 120, 160, 192, 256)
FLASH_DIMS_CASES = ([(d, dt) for d in FLASH_DIMS
                     for dt in (torch.float32, torch.bfloat16, torch.float16)]
                    + [(d, dt) for d in (136, 200, 250)
                       for dt in (torch.bfloat16, torch.float16)]
                    + [(d, torch.float16) for d in fa.HEAD_DIMS]
                    + [(33, torch.float64), (256, torch.float64)]
                    + [(d, dt) for d in range(1, fa.WGMMA_NARROW + 1) if d not in FLASH_DIMS
                       for dt in (torch.bfloat16, torch.float16)])
# B, Sq, Sk, Hq, Hkv, causal offset: no dimension a multiple of a tile
FLASH_DIMS_SHAPE = (2, 200, 333, 8, 2, 133)
# (name, B, Sq, Sk, Hq, Hkv, D, dtype) of the timed forwards: bf16 at D 96,
# 256 (Gemma-2-9B's heads, on the 256-wide tiles) and 250 (the same tiles,
# staged) at a prefill of 4 x 2048, fp16 at llama3-8b's prefill shape, fp32
# at the head-dim path's D 100 scaled to that prefill; and of the timed
# backwards: bf16 D 96, 256 and 250 and fp32 D 100 at internvl2-2b's train
# shape; bf16 D 32 (the narrow tiles' widest: train_carbon_aware's 10m
# preset) both ways at the forward's prefill.  At D 250, at D 32 and in
# fp32 (the tiled kernels) the route they replaced (mma.sync and fma,
# mma.sync and the mma pair, flash_f32_kernel and fma) runs in the same
# turns, gated.
DIMS_FWD_TIMED = [("bf16-d96", 4, 2048, 2048, 32, 8, 96, torch.bfloat16),
                  ("bf16-d256", 4, 2048, 2048, 16, 8, 256, torch.bfloat16),
                  ("bf16-d250", 4, 2048, 2048, 16, 8, 250, torch.bfloat16),
                  ("fp16-d128", 4, 2048, 2048, 32, 8, 128, torch.float16),
                  ("fp32-d100", 4, 2048, 2048, 16, 8, 100, torch.float32),
                  ("bf16-d32", 4, 2048, 2048, 16, 8, 32, torch.bfloat16)]
# The staged wgmma route past D 128 against the route it replaced, in
# turns: at most this share of its time (forward, backward); the mma
# backward against the fma route at most MMA_BWD_RATIO of it; fp32's tiled
# forward against flash_f32_kernel ("fp32_simple") at most FP32_FWD_RATIO,
# its tiled backward against the fma route at most FP32_BWD_RATIO; the
# narrow wgmma tiles at D 32 against mma.sync (forward) and the mma pair
# (backward) at most NARROW_FWD_RATIO and NARROW_BWD_RATIO by profiler
# device time in turns (readings 0.28 and 0.53 on an H100 80GB HBM3)
WIDE_FWD_RATIO, WIDE_BWD_RATIO = 0.4, 0.1
MMA_BWD_RATIO = 0.25
NARROW_FWD_RATIO, NARROW_BWD_RATIO = 0.8, 0.75
# One ex2 a score at Hopper's ~3.9 T special-function results a second
# (the FlashAttention-3 paper's figure): the narrow widths' softmax floor
EXP2_PER_S = 3.9e12
FP32_FWD_RATIO, FP32_BWD_RATIO = 0.75, 0.6
# The tiled kernels' instantiations: one per count of accumulator slots
TILED_SLOTS = sorted({fa.tiled_slots(d) for d in range(1, fa.MAX_HEAD_DIM + 1)})
DIMS_BWD_TIMED = [("bf16-d96", 4, 2304, 2304, 16, 8, 96, torch.bfloat16),
                  ("bf16-d256", 4, 2304, 2304, 16, 8, 256, torch.bfloat16),
                  ("bf16-d250", 4, 2304, 2304, 16, 8, 250, torch.bfloat16),
                  ("bf16-d32", 4, 2048, 2048, 16, 8, 32, torch.bfloat16),
                  ("fp32-d100", 4, 2304, 2304, 16, 8, 100, torch.float32)]
# bf16 D 192 forward and backward at the same shapes: the widest tiles that
# keep the producer warpgroup (hopper.cuh::Roles), timed for the record of
# that choice, outside the kernel line (no path of the script runs D 192)
DIMS_D192_TIMED = (("bf16-d192", 4, 2048, 2048, 16, 8, 192, torch.bfloat16),
                   ("bf16-d192", 4, 2304, 2304, 16, 8, 192, torch.bfloat16))
# The head-dim path: one train step of reduced llama3-8b at these head dims
# and compute dtypes through make_train_step (the forward and backward
# kernels of each route on a user's entry point), 2 x 256 tokens.
DIMS_PATH = [(96, torch.bfloat16), (256, torch.bfloat16), (250, torch.bfloat16),
             (24, torch.float16), (80, torch.float16), (100, torch.float16),
             (32, torch.bfloat16), (100, torch.float32)]
DIMS_PATH_BATCH, DIMS_PATH_SEQ = 2, 256


def fwd_instance(dtype, d) -> str:
    """The forward kernel instantiation of (dtype, D)."""
    route = fa.route(dtype, d)
    t = {torch.bfloat16: "__nv_bfloat16", torch.float16: "__half"}.get(dtype)
    if route == "wgmma":
        tile = fa.wgmma_tile_dim(d)
        pinned = dtype == torch.bfloat16 and d in fa.WGMMA_TILE_DIM
        return f"flash_wgmma_kernel<{tile}, {d if pinned else 0 if d % 8 == 0 else -1}, {t}>"
    if route == "mma_sync":
        return f"flash_mma_kernel<{t}, {fa.padded_dim(d)}>"
    return f"flash_tiled_kernel<{fa.tiled_slots(d)}>" + (" on fp32 copies"
                                                          if dtype == torch.float64 else "")


def bwd_instance(dtype, d) -> str:
    if fa.bwd_route(dtype, d) == "wgmma":
        pinned = dtype == torch.bfloat16 and d in fa.WGMMA_TILE_DIM
        return (f"flash_bwd_{{dq,dkdv}}_wgmma_kernel<{fa.wgmma_tile_dim(d)}, "
                f"{d if pinned else 0 if d % 8 == 0 else -1}, {str(dtype)[6:]}>")
    if fa.bwd_route(dtype, d) == "mma":
        return f"flash_bwd_{{dq,dkdv}}_mma_kernel<{str(dtype)[6:]}, {fa.padded_dim(d)}>"
    return f"flash_bwd_{{dq,dkdv}}_tiled_kernel<{fa.tiled_slots(d)}>" + (
        " on fp32 copies" if dtype == torch.float64 else "")


def flash_dims_phase(reports):
    """``gqa_flash`` and its backward at every sweep case
    (``FLASH_DIMS_CASES`` at ``FLASH_DIMS_SHAPE``): the forward against the
    plain version (FLASH_TOL, FLASH_REL by dtype), also with its LSE (the
    output equal bit for bit, the LSE within LSE_TOL), the backward on its
    route against the plain backward (``bwd_check``); on the tiled route
    (fp32, fp64) the forward with its LSE and the backward run again, equal
    bit for bit; the launches by route, and the staged copies, equal to those
    the cases make; the ptxas report of every flash instantiation
    (registers, spills); then the timed shapes.  Returns the sweep's readings and the kernel line's
    new entries."""
    gen = np.random.default_rng(21)
    b, sq, sk, hq, hkv, off = FLASH_DIMS_SHAPE
    start = time.perf_counter()
    fa.reset_launches()
    expect = dict.fromkeys(fa.launches, 0)
    sweep = {}
    for d, dtype in FLASH_DIMS_CASES:
        what = f"D={d} {str(dtype)[6:]}"
        q, k, v = flash_inputs(gen, b, sq, sk, hq, hkv, d, dtype)
        do = torch.from_numpy(gen.normal(size=(b, sq, hq, d)).astype(np.float32)) \
            .to("cuda", dtype)
        route, broute = fa.route(dtype, d), fa.bwd_route(dtype, d)
        err, rel = flash_check(q, k, v, off, f"gqa_flash sweep {what}")
        o, lse = fa.launch(q, k, v, off, with_lse=True)
        same = torch.equal(o, fa.gqa_flash(q, k, v, off))
        lse_err = (lse - fa.gqa_flash_lse_plain(q, k, off)).abs().max().item()
        if not (same and lse_err <= LSE_TOL):
            raise AssertionError(f"gqa_flash sweep {what} with the LSE: output equal "
                                 f"{same}, LSE off by up to {lse_err} (limit {LSE_TOL})")
        calls = 3
        berr, brel, brounded = bwd_check(q, k, v, o, do, off, f"gqa_flash_bwd sweep {what}",
                                         route=broute, lse=lse)
        runs = 1
        if broute == "tiled":           # two runs of either kernel: equal bits
            o2, lse2 = fa.launch(q, k, v, off, with_lse=True)
            first = fa.launch_bwd(q, k, v, o, do, off, lse=lse)
            second = fa.launch_bwd(q, k, v, o2, do, off, lse=lse2)
            if not (torch.equal(o, o2) and torch.equal(lse, lse2)
                    and all(torch.equal(a, c) for a, c in zip(first, second))):
                raise AssertionError(f"gqa_flash sweep {what}: two runs of the tiled "
                                     "kernels differ")
            calls, runs = 4, 3
        expect["gqa_flash"] += calls
        expect[route] += calls
        expect["gqa_flash_bwd"] += runs
        if route == "wgmma" and fa.tma_width(d) != d:    # q, k, v a forward; and dO
            expect["layout_copy"] += 3 * calls + 4
        for name in BWD_ROUTE_KERNELS[broute]:
            expect[name] += runs
        sweep[what] = dict(route=route, kernel=fwd_instance(dtype, d), max_abs_err=err,
                           rel_l2=rel, lse_err=lse_err, bwd_route=broute,
                           bwd_kernel=bwd_instance(dtype, d), bwd_max_abs_err=berr,
                           bwd_rel_l2=brel, bwd_rel_l2_rounded=brounded)
        log(f"gqa_flash sweep {what} B={b} Sq={sq} Sk={sk} Hq={hq} Hkv={hkv} offset={off}: "
            f"forward on {route} ({fwd_instance(dtype, d)}) max abs diff {err}, relative L2 "
            f"{rel} (limit {FLASH_REL[dtype]}), LSE {lse_err}; backward on {broute} max abs "
            f"diff {berr}, relative L2 {brel}, against the plain version from the LSE "
            f"{brounded}")
    if fa.launches != expect:
        raise AssertionError(f"sweep launches by route {fa.launches}, expected {expect}")
    log(f"gqa_flash sweep: {len(FLASH_DIMS_CASES)} cases agree with the plain versions; "
        f"launches by route {dict(fa.launches)}, as expected")
    # the wgmma kernels on the tiles past 128 (192 and 256 wide, bf16 and
    # fp16, head dims a multiple of 8 and any): eight in the forward's
    # report, sixteen (dQ's and dK/dV's) in the backward's; the same on the
    # narrow tiles (16 and 32 wide); the guarded instantiations of the tiles
    # 64 and 128 wide: four and eight; the mma route's kernels (dQ and dK/dV,
    # bf16 and fp16, widths 16 and 32): eight in the backward's; the forward
    # yardstick at those widths (flash_mma_kernel): four; and fp32's tiled kernels,
    # one of each for every count J of accumulator slots (1..8, 10, 12, 14,
    # 16: tiled_slots): twelve forward, twenty-four backward; none of which
    # may spill or serialise its products
    ptx, gated = {}, {}
    for src, pattern, count in (
            ("flash_attention.cu", r"wgmma_kernelILi(192|256)E", 8),
            ("flash_attention_bwd.cu", r"wgmma_kernelILi(192|256)E", 16),
            ("flash_attention.cu", r"wgmma_kernelILi(16|32)E", 8),
            ("flash_attention_bwd.cu", r"wgmma_kernelILi(16|32)E", 16),
            ("flash_attention.cu", r"wgmma_kernelILi(64|128)ELin1E", 4),
            ("flash_attention_bwd.cu", r"wgmma_kernelILi(64|128)ELin1E", 8),
            ("flash_attention.cu", r"flash_mma_kernelI\w+Li(16|32)EE", 4),
            ("flash_attention_bwd.cu", r"flash_bwd_(dq|dkdv)_mma_kernel", 8),
            ("flash_attention.cu", r"flash_tiled_kernelILi\d+EE", len(TILED_SLOTS)),
            ("flash_attention_bwd.cu", r"flash_bwd_(dq|dkdv)_tiled_kernelILi\d+EE",
             2 * len(TILED_SLOTS))):
        rep = ptxas_report(reports[f"src/repro_torch/csrc/{src}"], "flash_")
        if not rep:
            log(f"{src}: no ptxas report (the library was built before this run)")
            continue
        ptx.update(rep)
        found = {n: r for n, r in rep.items() if re.search(pattern, n)}
        if len(found) != count:
            raise AssertionError(f"{src}: {len(found)} instantiations of {pattern} reported, "
                                 f"expected {count}: {sorted(found)}")
        gated.update(found)
    spills = {n: r for n, r in ptx.items() if r.get("spill_stores") or r.get("spill_loads")}
    log(f"flash ptxas: {len(ptx)} instantiations, {len(spills)} with spills: "
        + "; ".join(f"{n}: {r}" for n, r in spills.items()))
    bad = {n: r for n, r in gated.items()
           if r.get("spill_stores") or r.get("spill_loads") or r["remarks"]}
    if bad:
        raise AssertionError(f"the wide or narrow wgmma, the mma backward or the tiled "
                             f"instantiations spill or serialise: {bad}")
    log("wide and narrow wgmma, mma backward and tiled instantiations, ptxas: " + "; ".join(
        f"{n}: {r.get('registers')} registers, spills {r.get('spill_stores', 0)}/"
        f"{r.get('spill_loads', 0)}" for n, r in gated.items()))
    walls = {"sweep and ptxas": time.perf_counter() - start}

    def timed(fn, shape):
        start = time.perf_counter()
        out = fn(gen, *shape)
        walls[out["name"]] = time.perf_counter() - start
        return out

    fwd = [timed(flash_dims_fwd_timing, shape) for shape in DIMS_FWD_TIMED]
    bwd = [timed(flash_dims_bwd_timing, shape) for shape in DIMS_BWD_TIMED]
    d192 = dict(forward=timed(flash_dims_fwd_timing, DIMS_D192_TIMED[0]),
                backward=timed(flash_dims_bwd_timing, DIMS_D192_TIMED[1]))
    log("head-dim phase walls (s): " + ", ".join(f"{k} {v:.3f}" for k, v in walls.items()))
    return dict(sweep=sweep, ptxas=ptx, spilled=sorted(spills), d192=d192, walls=walls), \
        fwd, bwd


def in_turns_ms(runs):
    """{key: (fn, iters, warmup)} timed there and back (each key twice, in
    turns) by CUDA events: (turns, mean ms of each key)."""
    turns = {key: [] for key in runs}
    for key in list(runs) + list(runs)[::-1]:
        fn, iters, warmup = runs[key]
        turns[key].append(time_ms(fn, iters, warmup=warmup))
    return turns, {key: float(np.mean(v)) for key, v in turns.items()}


def flash_dims_fwd_timing(gen, tag, b, sq, sk, hq, hkv, d, dtype):
    """One timed forward of the sweep's routes: the kernel (its route), the
    plain version and SDPA in turns by CUDA events, and by profiler device
    time, beside the bound (16-bit tensor-core peak; fp32's 67 TFLOP/s for
    fp32).  At a D past 128 off a multiple of 8 (staged) the route it
    replaced (mma.sync) runs in the same turns, and the kernel must take at
    most WIDE_FWD_RATIO of its time; in fp32 the first design's
    flash_f32_kernel ("fp32_simple") does, held to the plain version too,
    and the tiled kernel must take at most FP32_FWD_RATIO of its time; on the
    narrow tiles (D <= 32) mma.sync does, and the kernel must take at most
    NARROW_FWD_RATIO of its profiler device time in turns (the exponentials'
    floor printed beside the bound).  The yardstick's own entry, for the
    yardsticks' line, comes under "yardstick" at D <= 32."""
    q, k, v = card_normal(gen, (b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d), dtype=dtype)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    route = fa.route(dtype, d)
    wide = route == "wgmma" and d > 128 and fa.tma_width(d) != d
    narrow = route == "wgmma" and d <= fa.WGMMA_NARROW
    fp32 = route == "fp32"
    old, ratio_limit = ("fp32_simple", FP32_FWD_RATIO) if fp32 else \
        ("mma_sync", NARROW_FWD_RATIO if narrow else WIDE_FWD_RATIO)
    paired = wide or fp32 or narrow

    def kernel():
        return fa.launch(q, k, v, 0)

    def previous():
        return fa.launch(q, k, v, 0, old)

    def plain():
        return fa.gqa_flash_plain(q, k, v)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    got, want = kernel(), plain()
    err, rel = (got.float() - want.float()).abs().max().item(), rel_l2(got, want)
    if not rel <= FLASH_REL[dtype]:
        raise AssertionError(f"gqa_flash {tag}: relative L2 {rel} to the plain version")
    lib_diff = (library().transpose(1, 2).float() - got.float()).abs().max().item()
    checked = {}
    if paired:
        # the yardstick is held to the plain version too before it is timed
        prev = previous()
        checked = dict(previous_max_abs_err=(prev.float() - want.float()).abs().max().item(),
                       previous_rel_l2=rel_l2(prev, want), previous=old)
        if not checked["previous_rel_l2"] <= FLASH_REL[dtype]:
            raise AssertionError(f"gqa_flash {tag} on {old}: relative L2 "
                                 f"{checked['previous_rel_l2']} to the plain version")
        del prev
    del got, want
    n = 20 if dtype != torch.float32 else 5
    runs = dict(ms=(kernel, n, 3))
    if route == "wgmma" and fa.tma_width(d) != d:
        # the call's split: the three staging copies, and the kernel on
        # inputs staged beforehand
        tq, tk, tv = (fa.stage(t) for t in (q, k, v))
        runs.update(stage_ms=(lambda: [fa.stage(t) for t in (q, k, v)], n, 3),
                    prestaged_ms=(lambda: fa.launch(tq, tk, tv, 0), n, 3))
    if paired:
        runs["previous_ms"] = (previous, 10 if wide else n, 2 if wide else 1)
    runs.update(plain_ms=(plain, 3, 1), library_ms=(library, n, 3))
    turns, t = in_turns_ms(runs)
    # each function warmed by its turns; a trace that recorded no device
    # time (the fp32 kernel's, now and then) is taken again, at most twice
    t.update(device_ms=device_ms_again(kernel, n), plain_device_ms=device_ms(plain, 3, 1),
             library_device_ms=device_ms(library, n // 2, 1))
    if fp32:
        t["previous_device_ms"] = device_ms_again(previous, n)
    if narrow:      # the gate's reading: profiler device time, in turns
        dev_turns = in_turns({"device_ms": kernel, "previous_device_ms": previous})
        t.update({key: float(np.mean(val)) for key, val in dev_turns.items()},
                 device_turns=dev_turns)
    nbytes, flops = flash_work(b, sq, sk, hq, hkv, d, 0, q.element_size())
    bound, by = bound_ms(nbytes, flops,
                         FP32_FLOP_PER_S if dtype == torch.float32 else BF16_FLOP_PER_S)
    scores = b * hq * sum(min(sk, r + 1) for r in range(sq))
    exp_floor = scores / EXP2_PER_S * 1e3
    log(f"gqa_flash {tag} (B={b} S={sq} Hq={hq} Hkv={hkv} D={d} {str(dtype)[6:]}, "
        f"{route}), in turns {turns}")
    log(f"gqa_flash {tag}: kernel {t['ms']:.6f} ms/call ({flops / t['ms'] / 1e9:.3f} TFLOP/s, "
        f"{bound / t['ms']:.4f} of the bound), plain {t['plain_ms']:.6f}, SDPA "
        f"{t['library_ms']:.6f} (kernel / SDPA {t['ms'] / t['library_ms']:.3f}), bound "
        f"{bound:.6f} by {by}; device time {t['device_ms']} ms/call (plain "
        f"{t['plain_device_ms']}, SDPA {t['library_device_ms']}); max abs diff {err}, "
        f"relative L2 {rel}; SDPA differs by up to {lib_diff}; the exponentials' floor "
        f"{exp_floor:.6f} ({scores} scores at {EXP2_PER_S:.3g}/s)"
        + (f"; staging q, k, v {t['stage_ms']:.6f}, the kernel on staged inputs "
           f"{t['prestaged_ms']:.6f}" if "stage_ms" in t else "")
        + (f"; the {old} kernel {t['previous_ms']:.6f} (device "
           f"{t.get('previous_device_ms')}; kernel / it {t['ms'] / t['previous_ms']:.4f}"
           + (f", by device time {t['device_ms'] / t['previous_device_ms']:.4f}"
              if narrow else "")
           + f", limit {ratio_limit}; max abs diff {checked['previous_max_abs_err']}, relative "
           f"L2 {checked['previous_rel_l2']})" if paired else ""))
    if narrow:
        if not t["device_ms"] <= ratio_limit * t["previous_device_ms"]:
            raise AssertionError(f"gqa_flash {tag}: the narrow wgmma kernel takes "
                                 f"{t['device_ms']} ms of device time, more than {ratio_limit} "
                                 f"of the mma.sync kernel's {t['previous_device_ms']} ms")
    elif (wide or fp32) and not t["ms"] <= ratio_limit * t["previous_ms"]:
        raise AssertionError(f"gqa_flash {tag}: the {route} kernel takes {t['ms']} ms, more "
                             f"than {ratio_limit} of the {old} kernel's "
                             f"{t['previous_ms']} ms")
    shape = f"B={b} Sq={sq} Sk={sk} Hq={hq} Hkv={hkv} D={d} {str(dtype)[6:]} causal"
    if narrow:
        checked["yardstick"] = dict(
            name=f"gqa_flash_mma_sync_{tag.replace('-', '_')}", route="cuda",
            kernel=f"flash_mma_kernel<{str(dtype)[6:]}, {fa.padded_dim(d)}> "
                   "(kernel=\"mma_sync\")",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:94",
            max_abs_err=checked["previous_max_abs_err"], rel_l2=checked["previous_rel_l2"],
            ms=t["previous_ms"], device_ms=t["previous_device_ms"], plain_ms=t["plain_ms"],
            bound_ms=bound, bound_by=by, library_ms=t["library_ms"],
            library_device_ms=t["library_device_ms"], shape=shape)
    return dict(name=f"gqa_flash_{tag.replace('-', '_')}", route="cuda",
                kernel=fwd_instance(dtype, d), flash_route=route,
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:94",
                max_abs_err=err, rel_l2=rel, bound_ms=bound, bound_by=by,
                tflops=flops / t["ms"] / 1e9, bound_share=bound / t["ms"],
                over_sdpa=t["ms"] / t["library_ms"], exp_floor_ms=exp_floor, shape=shape,
                sdpa_max_abs_diff=lib_diff, turns=turns, **checked, **t)


def flash_dims_bwd_timing(gen, tag, b, sq, sk, hq, hkv, d, dtype):
    """One timed backward: the whole route (``launch_bwd`` as the Function
    calls it: on the wgmma route with q, k, v as the forward staged them, so
    that a D off a multiple of 8 stages dO alone), the plain backward and
    SDPA's backward (its forward + backward less its forward) in turns by
    CUDA events, and by profiler device time, beside the function's bound
    (five products; fp32's 67 TFLOP/s for fp32).  On the wgmma route at a D
    past 128 off a multiple of 8 (staged) and on the tiled route (fp32), the
    route it replaced (fma) runs in the same turns: the wgmma route must
    take at most WIDE_BWD_RATIO of its time, the tiled route FP32_BWD_RATIO.
    On the narrow wgmma tiles (D <= 32) the route they replaced, the mma
    pair (by name, the yardstick), runs in the same turns with its own
    yardstick, fma: the mma pair must take at most MMA_BWD_RATIO of fma's
    time, and the wgmma pair at most NARROW_BWD_RATIO of the
    mma pair's profiler device time in turns; the mma pair's entry, for the
    yardsticks' line, comes under "yardstick".  On the tiled route each
    of its two kernels is timed in the same turns too (``launch_bwd_kernel``
    on the whole route's buffers), and returned as the kernel line's entries
    under "kernel_entries"."""
    q, k, v, do = card_normal(gen, (b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d),
                              (b, sq, hq, d), dtype=dtype)
    route = fa.bwd_route(dtype, d)
    o, lse = fa.launch(q, k, v, 0, with_lse=True)
    tq, tk, tv = (fa._readable_copy(t, "wgmma") for t in (q, k, v)) if route == "wgmma" \
        else (q, k, v)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2)

    def kernels():
        return fa.launch_bwd(tq, tk, tv, o, do, 0, lse=lse)

    def previous():
        return fa.launch_bwd(q, k, v, o, do, 0, route="fma")

    def mma():
        return fa.launch_bwd(q, k, v, o, do, 0, lse=lse, route="mma")

    def plain():
        return fa.gqa_flash_bwd_plain(q, k, v, o, do, 0)

    def sdpa_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        return torch.autograd.grad(out, (qt, kt, vt), dot)

    def held(got, want, what, limit):
        """(max abs difference, largest relative L2) of dQ, dK, dV to the
        plain backward's, within ``limit``."""
        err, rel = 0.0, 0.0
        for g, w in zip(got, want):
            err = max(err, (g.float() - w.float()).abs().max().item())
            rel = max(rel, rel_l2(g, w))
        if not rel <= limit:
            raise AssertionError(f"gqa_flash_bwd {tag} on {what}: relative L2 {rel} "
                                 f"(limit {limit})")
        return err, rel

    tiled = route == "tiled"
    narrow = route == "wgmma" and d <= fa.WGMMA_NARROW
    wide = (route == "wgmma" and d > 128 and fa.tma_width(d) != d) or route == "tiled" or narrow
    ratio_limit = {"tiled": FP32_BWD_RATIO}.get(route, WIDE_BWD_RATIO)
    want = plain()
    limit = BWD_REL[dtype] if route in ("fma", "tiled") else BWD_WGMMA_REL
    err, rel = held(kernels(), want, route, limit)
    # the yardsticks are held to the plain backward too before they are timed
    prev_err, prev_rel = held(previous(), want, "fma", BWD_REL[dtype]) if wide else (None, None)
    mma_err, mma_rel = held(mma(), want, "mma", BWD_WGMMA_REL) if narrow else (None, None)
    del want
    iters = 3 if route in ("fma", "tiled") else 10
    runs = dict(ms=(kernels, iters, 1))
    if route == "wgmma" and fa.tma_width(d) != d:
        runs["stage_ms"] = (lambda: fa.stage(do), iters, 1)    # the call's dO copy
    if narrow:
        runs["mma_ms"] = (mma, iters, 1)
    if wide:
        runs["previous_ms"] = (previous, 2, 1)
    if tiled:       # each kernel alone, on the whole route's buffers (D_i in place)
        pl, bufs = fa.plan_bwd(q, k, v, o, do, 0), fa.bwd_buffers(q, k, lse)
        for which, name in enumerate(fa.BWD_TILED_KERNELS):
            fa.launch_bwd_kernel(which, q, k, v, o, do, bufs, 0, pl)
            runs[name] = (lambda w=which: fa.launch_bwd_kernel(w, q, k, v, o, do, bufs, 0, pl),
                          iters, 1)
    runs.update(plain_ms=(plain, 2, 1), sdpa_fwd=(sdpa_fwd, 10, 2),
                sdpa_fwd_bwd=(sdpa_fwd_bwd, 10, 2))
    turns, t = in_turns_ms(runs)
    dev = {key: device_ms(fn, n, 1) for key, fn, n in (    # each warmed by its turns
        ("device_ms", kernels, iters), ("plain_device_ms", plain, 2),
        ("sdpa_fwd", sdpa_fwd, 10), ("sdpa_fwd_bwd", sdpa_fwd_bwd, 10))}
    if wide:
        dev["previous_device_ms"] = device_ms(previous, 2, 1)
    for name in fa.BWD_TILED_KERNELS if tiled else ():
        dev[name] = device_ms_again(runs[name][0], iters)
    if tiled:       # the profiler drops events of these long kernels: the sum of the two
        parts = [dev[name] for name in fa.BWD_TILED_KERNELS]
        dev["device_ms"] = None if None in parts else sum(parts)
    if narrow:      # the gate's reading: profiler device time, in turns
        dev_turns = in_turns({"device_ms": kernels, "mma_device_ms": mma})
        dev.update({key: float(np.mean(val)) for key, val in dev_turns.items()})
    library = t["sdpa_fwd_bwd"] - t["sdpa_fwd"]
    library_dev = (dev["sdpa_fwd_bwd"] - dev["sdpa_fwd"]
                   if dev["sdpa_fwd_bwd"] and dev["sdpa_fwd"] else None)
    over = t["ms"] / library if library > 0 else None
    work = bwd_work(b, sq, sk, hq, hkv, d, 0, q.element_size())
    bound, by = bound_ms(*work["gqa_flash_bwd"],
                         FP32_FLOP_PER_S if dtype == torch.float32 else BF16_FLOP_PER_S)
    log(f"gqa_flash_bwd {tag} (B={b} S={sq} Hq={hq} Hkv={hkv} D={d} {str(dtype)[6:]}, "
        f"{route}), in turns {turns}")
    log(f"gqa_flash_bwd {tag}: the {route} route {t['ms']:.6f} ms/call (device "
        f"{dev['device_ms']}; {bound / t['ms']:.4f} of the bound), plain {t['plain_ms']:.6f} "
        f"(device {dev['plain_device_ms']}), SDPA's backward {library:.6f} (device "
        f"{library_dev}; route / SDPA {over}), bound {bound:.6f} by {by}; "
        f"max abs diff {err}, relative L2 {rel} (limit {limit})"
        + (f"; staging dO {t['stage_ms']:.6f}" if "stage_ms" in t else "")
        + (f"; the fma route {t['previous_ms']:.6f} (device {dev.get('previous_device_ms')}; "
           f"route / it {t['ms'] / t['previous_ms']:.4f}, limit {ratio_limit}; max abs diff "
           f"{prev_err}, relative L2 {prev_rel} (limit {BWD_REL[dtype]}))"
           if wide and not narrow else "")
        + (f"; the mma pair {t['mma_ms']:.6f} (device {dev['mma_device_ms']}; the wgmma pair "
           f"over it by device time in turns {dev['device_ms'] / dev['mma_device_ms']:.4f}, "
           f"limit {NARROW_BWD_RATIO}; max abs diff {mma_err}, relative L2 {mma_rel}); the fma "
           f"route {t['previous_ms']:.6f} (device {dev.get('previous_device_ms')}; the mma pair "
           f"over it {t['mma_ms'] / t['previous_ms']:.4f}, limit {MMA_BWD_RATIO})"
           if narrow else "")
        + "".join(f"; {name} {t[name]:.6f} (device {dev[name]})"
                  for name in (fa.BWD_TILED_KERNELS if tiled else ())))
    if narrow:
        if not t["mma_ms"] <= MMA_BWD_RATIO * t["previous_ms"]:
            raise AssertionError(f"gqa_flash_bwd {tag}: the mma route takes {t['mma_ms']} ms, "
                                 f"more than {MMA_BWD_RATIO} of the fma route's "
                                 f"{t['previous_ms']} ms")
        if not dev["device_ms"] <= NARROW_BWD_RATIO * dev["mma_device_ms"]:
            raise AssertionError(f"gqa_flash_bwd {tag}: the narrow wgmma pair takes "
                                 f"{dev['device_ms']} ms of device time, more than "
                                 f"{NARROW_BWD_RATIO} of the mma pair's {dev['mma_device_ms']} ms")
    elif wide and not t["ms"] <= ratio_limit * t["previous_ms"]:
        raise AssertionError(f"gqa_flash_bwd {tag}: the {route} route takes {t['ms']} ms, more "
                             f"than {ratio_limit} of the fma route's {t['previous_ms']} ms")
    extra = dict(previous_ms=t["previous_ms"], previous="the fma route",
                 previous_device_ms=dev["previous_device_ms"],
                 previous_max_abs_err=prev_err, previous_rel_l2=prev_rel) if wide else {}
    shape = f"B={b} Sq={sq} Sk={sk} Hq={hq} Hkv={hkv} D={d} {str(dtype)[6:]} causal"
    if narrow:      # one exponential a score in each kernel
        extra["exp_floor_ms"] = 2 * b * hq * sum(min(sk, r + 1) for r in range(sq)) \
            / EXP2_PER_S * 1e3
        extra.update(mma_ms=t["mma_ms"], mma_device_ms=dev["mma_device_ms"],
                     over_mma_device=dev["device_ms"] / dev["mma_device_ms"],
                     device_turns=dev_turns)
        extra["yardstick"] = dict(
            name=f"gqa_flash_bwd_mma_{tag.replace('-', '_')}", route="cuda",
            kernel=f"flash_bwd_{{dq,dkdv}}_mma_kernel<{str(dtype)[6:]}, {fa.padded_dim(d)}> "
                   "(route=\"mma\")", bwd_route="mma",
            source="src/repro_torch/csrc/flash_attention_bwd.cu",
            replaces="src/repro/models/common.py:255 (XLA autodiff of chunked_attention)",
            max_abs_err=mma_err, rel_l2=mma_rel, ms=t["mma_ms"], device_ms=dev["mma_device_ms"],
            plain_ms=t["plain_ms"], bound_ms=bound, bound_by=by, library_ms=library,
            library_device_ms=library_dev, previous="the fma route",
            previous_ms=t["previous_ms"], over_previous=t["mma_ms"] / t["previous_ms"],
            shape=shape)
    if "stage_ms" in t:
        extra["stage_ms"] = t["stage_ms"]
    if tiled:
        extra["kernel_entries"] = [dict(
            name=f"gqa_flash_{name}", route="cuda",
            kernel=f"flash_bwd_{name[len('bwd_tiled_'):]}_tiled_kernel<{fa.tiled_slots(d)}>",
            bwd_route=route, source="src/repro_torch/csrc/flash_attention_bwd.cu",
            replaces="src/repro/models/common.py:255 (XLA autodiff of chunked_attention; "
                     "the Pallas gqa_flash at src/repro/kernels/flash_attention.py:94 has "
                     "no gradient)",
            max_abs_err=err, rel_l2=rel, ms=t[name], device_ms=dev[name],
            plain_ms=t["plain_ms"], plain_device_ms=dev["plain_device_ms"],
            plain_of="the whole backward",
            bound_ms=kb, bound_by=kby, bound_share=kb / t[name],
            library_ms=library, library_device_ms=library_dev,
            library_of="the whole backward: SDPA forward + backward less forward",
            whole_ms=t["ms"], whole_device_ms=dev["device_ms"], previous_whole_ms=t["previous_ms"],
            shape=f"B={b} Sq={sq} Sk={sk} Hq={hq} Hkv={hkv} D={d} {str(dtype)[6:]} causal",
            turns={key: turns[key] for key in (name, "ms", "previous_ms")})
            for name in fa.BWD_TILED_KERNELS
            for kb, kby in [bound_ms(*work[name], FP32_FLOP_PER_S)]]
    return dict(name=f"gqa_flash_bwd_{tag.replace('-', '_')}", route="cuda",
                kernel=bwd_instance(dtype, d), bwd_route=route,
                source="src/repro_torch/csrc/flash_attention_bwd.cu",
                replaces="src/repro/models/common.py:255 (XLA autodiff of chunked_attention; "
                         "the Pallas gqa_flash at src/repro/kernels/flash_attention.py:94 has "
                         "no gradient)",
                max_abs_err=err, rel_l2=rel, ms=t["ms"], device_ms=dev["device_ms"],
                plain_ms=t["plain_ms"], plain_device_ms=dev["plain_device_ms"],
                plain_of="the whole backward", bound_ms=bound, bound_by=by,
                bound_share=bound / t["ms"], library_ms=library, library_device_ms=library_dev,
                library_of="the whole backward: SDPA forward + backward less forward",
                over_sdpa=over, shape=shape, turns=turns, **extra)


def dims_path_phase(device="cuda"):
    """The head-dim path: for each (D, dtype) of ``DIMS_PATH`` one train
    step of reduced llama3-8b at that head dim and compute dtype through
    ``make_train_step``, launch counts reset just before and read just
    after: two forwards a layer (the recompute) on its route and one
    backward on the route that pairs with it (``train_launch_counts``).
    Returns each case's launches, loss and grad norm."""
    from repro_torch.configs import reduced
    from repro_torch.train import (DataConfig, OptimizerConfig, SyntheticLM, init_state,
                                   make_train_step)

    out = {}
    for d, dtype in DIMS_PATH:
        cfg = dataclasses.replace(reduced(ARCHS[SERVE_ARCH]), head_dim=d, compute_dtype=dtype,
                                  name=f"llama3-8b-smoke-d{d}-{str(dtype)[6:]}")
        state = init_state(cfg, seed=0, device=device)
        src = SyntheticLM(DataConfig(batch=DIMS_PATH_BATCH, seq_len=DIMS_PATH_SEQ,
                                     vocab_size=cfg.vocab_size, seed=0))
        batch = {"tokens": torch.from_numpy(src.batch_at(0)).to(device)}
        step = make_train_step(cfg, OptimizerConfig(warmup_steps=1, total_steps=2))
        fa.reset_launches()
        _, met = step(state, batch)
        torch.cuda.synchronize()
        counts = dict(fa.launches)
        want = train_launch_counts(dtype, d, cfg.num_layers, 1)
        loss, gnorm = float(met["loss"]), float(met["grad_norm"])
        if counts != want or not math.isfinite(loss) or not math.isfinite(gnorm):
            raise AssertionError(f"head-dim path D={d} {dtype}: launches {counts} (expected "
                                 f"{want}), loss {loss}, grad norm {gnorm}")
        out[f"D={d} {str(dtype)[6:]}"] = dict(launches=counts, loss=loss, grad_norm=gnorm,
                                              kernel=fwd_instance(dtype, d),
                                              bwd_kernel=bwd_instance(dtype, d))
        log(f"head-dim path: {cfg.name} ({cfg.num_layers} layers, d {cfg.d_model}, "
            f"{cfg.num_heads} x {d} heads), one train step of {DIMS_PATH_BATCH} x "
            f"{DIMS_PATH_SEQ}: loss {loss}, grad norm {gnorm}, launches {counts}")
    return out


def teacher_forced(params, prompts, cfg, chunked, finite=None):
    """Layer by layer on the chunked model's input to each layer: the
    relative L2 of the kernel's attention output against the chunked
    attention's on that layer's own q/k/v, and of the last-position logits
    of the flash model's last layer so fed against the chunked model's.
    With a list ``finite``, each layer's input and q/k/v are checked and
    whether all are finite appended to it."""
    lp = params["layers"]
    x = params["embed"][prompts].to(cfg.compute_dtype)
    pos = torch.arange(x.shape[1], device=x.device)
    rels = []
    for li in range(cfg.num_layers):
        h = rms_norm(x, lp["ln1"][li], cfg.norm_eps)
        q, k, v = transformer.qkv(h, lp, li)
        q, k = rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta)
        if finite is not None:
            finite.append(all(bool(torch.isfinite(t).all()) for t in (x, q, k, v)))
        rels.append(rel_l2(fa.gqa_flash(q, k, v),
                           chunked_attention(q, k, v, 0, chunked.attention_chunk)))
        del h, q, k, v
        if li == cfg.num_layers - 1:
            got, _ = transformer.decoder_layer(x, lp, li, cfg, pos)
        x, _ = transformer.decoder_layer(x, lp, li, chunked, pos)

    def logits(h):
        return rms_norm(h[:, -1], params["ln_f"], cfg.norm_eps) \
            @ transformer.output_head(params).to(h.dtype)

    return rels, rel_l2(logits(got), logits(x))


def fp16_prefill(params, prompts, cfg, max_seq):
    """llama3-8b's prefill at ``compute_dtype=torch.float16`` on the serving
    phase's weights, counts reset just before and read just after: one
    launch a layer, all on the Hopper kernel's fp16 instantiation; then each
    layer's attention on the chunked path's own input within ATTN_REL of the
    chunked attention (``teacher_forced``), every non-finite value traced to
    the first layer whose input or q/k/v holds one (those layers printed,
    not gated: fp16 tops out at 65504)."""
    cfg16 = dataclasses.replace(cfg, compute_dtype=torch.float16)
    fa.reset_launches()
    t = time.perf_counter()
    logits, cache = make_prefill(cfg16, max_seq)(params, prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    counts = dict(fa.launches)
    finite_logits = bool(torch.isfinite(logits).all())
    del logits, cache
    if counts["gqa_flash"] != cfg.num_layers or counts["wgmma"] != cfg.num_layers:
        raise AssertionError(f"fp16 prefill: launches {counts}, expected {cfg.num_layers} "
                             f"on the Hopper kernel")
    finite = []
    rels, forced = teacher_forced(params, prompts, cfg16,
                                  dataclasses.replace(cfg16, attention_backend="chunked"),
                                  finite)
    held = [r for r, ok in zip(rels, finite) if ok]
    first_bad = finite.index(False) if False in finite else None
    log(f"serve fp16: prefill {prefill_s:.6f} s, {counts['wgmma']} launches on "
        f"{fwd_instance(torch.float16, cfg.resolved_head_dim)}, logits finite "
        f"{finite_logits}; each layer's attention on the chunked path's input, kernel vs "
        f"chunked: relative L2 max {max(held) if held else None} over {len(held)} layers "
        f"with finite inputs (limit {ATTN_REL}), first layer with a non-finite input or "
        f"q/k/v {first_bad}; last-position logits so fed {forced}")
    if not held or max(held) > ATTN_REL:
        raise AssertionError(f"fp16 prefill: attention relative L2 {rels} (finite {finite})")
    return dict(prefill_s=prefill_s, launches=counts, logits_finite=finite_logits,
                attn_rel_l2=rels, layers_finite=finite, first_nonfinite_layer=first_bad,
                forced_logits_rel_l2=forced)


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
    fp16 = fp16_prefill(params, prompts, cfg, max_seq)

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
                launches=launches, fp16_prefill=fp16)


# --- the MoE serving path -----------------------------------------------------

MOE_ARCH = "qwen3-moe-235b-a22b"
# Depth cut from 94 to 2 layers, width kept: a layer holds 2.452e9 parameters
# (4.90 GB in bf16), so 2 layers and embed/lm_head take ~12.3 GB (8 layers,
# ~41.7 GB, until the shard phase needed the script's time, then 4, ~22.1 GB,
# until the shard phase's cell (f) did); drawing the fp32 w_up leaf beside
# the rest peaks at ~33 GB at 4 layers; 10 layers would peak at ~81.8 GB.
MOE_LAYERS = 2
# Relative L2 of layer 0's MoE output (bf16 products, bf16 combine) against
# an fp32 evaluation of the same routing on the same input.
MOE_REL = 1e-2


def moe_fp32(x, lp, li, r, cap, chunk=16):
    """Layer ``li``'s MoE output in fp32 for the routing ``r``: the kept
    tokens of x in an fp32 buffer, the experts' products in fp32 (16 experts
    at a time), the combine with fp32 gates."""
    b, s, d = x.shape
    e = lp["router"].shape[-1]
    xt = x.reshape(b * s, d).float()
    buf = xt.new_zeros((e * cap + 1, d))
    buf[r.slot] = xt[r.src_tok] * r.keep[:, None].float()
    eb = buf[:e * cap].view(e, cap, d)
    yb = torch.cat([transformer.moe_experts(
        eb[e0:e0 + chunk], lp["w_gate"][li][e0:e0 + chunk].float(),
        lp["w_up"][li][e0:e0 + chunk].float(), lp["w_down"][li][e0:e0 + chunk].float())
        for e0 in range(0, e, chunk)])
    return transformer.moe_combine(yb, r).view(b, s, d)


def same_routing(got, want) -> bool:
    return all(torch.equal(getattr(got, f), getattr(want, f))
               for f in ("eidx", "order", "slot", "keep", "src_tok"))


def moe_serve_phase(device="cuda"):
    """qwen3-moe-235b-a22b at full width, 2 of its 94 layers, through
    ``greedy_generate`` (4 prompts of 2048 tokens, 64 greedy tokens), launch
    counts reset just before and read just after; every dispatch of the run
    (4 in prefill, 4 a decode step) held against the plain dispatch on the
    CPU on the card's own router probabilities, bit for bit."""
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(ARCHS[MOE_ARCH], num_layers=MOE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = init_params(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    init_peak = torch.cuda.max_memory_allocated()
    n_params = sum(x.numel() for x in torch.utils._pytree.tree_leaves(params))
    if n_params != param_count(cfg):
        raise AssertionError(f"{n_params} parameters, param_count says {param_count(cfg)}")
    on_card = torch.cuda.memory_allocated()
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT))).to(device)
    log(f"moe serve: {cfg.name} {cfg.num_layers} of 94 layers d={cfg.d_model} "
        f"{cfg.num_experts} experts top {cfg.experts_per_token} d_ff {cfg.d_ff}: "
        f"{n_params} parameters initialised in {init_s:.3f} s ({on_card / 2**30:.3f} "
        f"GiB on the card, peak while drawing {init_peak / 2**30:.3f} GiB)")

    routes, block_io, captured = [], [], []
    route, block, kernel = transformer.moe_route, transformer.moe_block, fa.gqa_flash

    def capture_route(probs, k, cap):
        r = route(probs, k, cap)
        routes.append((probs.cpu(), k, cap, transformer.Routing(*(x.cpu() for x in r))))
        return r

    def capture_block(x, lp, li, cfg, rules=None):
        y = block(x, lp, li, cfg, rules)
        if not block_io:
            block_io.append((x, li, y, len(routes) - 1))
        return y

    def capture_flash(q, k, v, causal_offset=0):
        if not captured:
            captured.append((q, k, v, causal_offset))
        return kernel(q, k, v, causal_offset=causal_offset)

    transformer.moe_route, transformer.moe_block = capture_route, capture_block
    fa.gqa_flash = capture_flash
    fa.reset_launches()
    try:
        out = greedy_generate(params, prompts, cfg, SERVE_TOKENS)
    finally:
        transformer.moe_route, transformer.moe_block = route, block
        fa.gqa_flash = kernel
    launches = dict(fa.launches)
    prefill_n, decode_n = out["prefill_flash_launches"], out["decode_flash_launches"]
    peak = torch.cuda.max_memory_allocated()
    log(f"moe serve, first run (each dispatch copied to the host): prefill "
        f"{out['prefill_s']:.6f} s, decode {out['decode_s']:.6f} s, gqa_flash launches "
        f"{prefill_n} in prefill + {decode_n} in decode ({launches}), peak "
        f"{peak / 2**30:.3f} GiB")
    if (prefill_n, decode_n) != (cfg.num_layers, 0) \
            or launches["gqa_flash"] != cfg.num_layers \
            or launches["wgmma"] != cfg.num_layers:
        raise AssertionError(f"gqa_flash launched {prefill_n} times in prefill and "
                             f"{decode_n} in decode ({launches}); expected "
                             f"{cfg.num_layers} and 0, all on the Hopper kernel")
    cache, toks = out["cache"], out["tokens"]
    max_seq = SERVE_PROMPT + SERVE_TOKENS
    want_shape = (cfg.num_layers, SERVE_BATCH, max_seq, cfg.num_kv_heads,
                  cfg.resolved_head_dim)
    if cache["length"] != max_seq or tuple(cache["k"].shape) != want_shape \
            or want_shape != (MOE_LAYERS, 4, 2112, 4, 64):
        raise AssertionError(f"cache length {cache['length']}, shape "
                             f"{tuple(cache['k'].shape)}")
    for name in ("prefill_logits", "last_logits"):
        x = out[name]
        if x.shape != (SERVE_BATCH, cfg.vocab_size) or not torch.isfinite(x).all():
            raise AssertionError(f"{name}: shape {tuple(x.shape)} or non-finite")
    if toks.shape != (SERVE_BATCH, SERVE_TOKENS) or toks.min() < 0 \
            or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"generated ids out of range: {toks.min()}..{toks.max()}")

    # Every dispatch of the run against the plain dispatch on the CPU, on
    # the card's own router probabilities.
    n_prefill = cfg.num_layers
    if len(routes) != n_prefill * (1 + SERVE_TOKENS):
        raise AssertionError(f"{len(routes)} dispatches, expected "
                             f"{n_prefill * (1 + SERVE_TOKENS)}")
    t = time.perf_counter()
    differ = [i for i, (probs, k, cap, r) in enumerate(routes)
              if not same_routing(r, route(probs, k, cap))]
    check_s = time.perf_counter() - t
    caps = sorted({cap for _, _, cap, _ in routes})
    drops = [int((~r.keep).sum()) for _, _, _, r in routes]
    prefill_drops, decode_drops = drops[:n_prefill], drops[n_prefill:]
    ties = sum(int((p.sort(dim=-1, descending=True).values[:, k - 1:k + 1].diff(dim=-1)
                    == 0).sum()) for p, k, _, _ in routes)
    log(f"moe serve: {len(routes)} dispatches ({n_prefill} prefill at C="
        f"{routes[0][2]}, {len(routes) - n_prefill} decode at C={routes[-1][2]}; "
        f"capacities {caps}) against the plain dispatch on the CPU: {len(differ)} "
        f"differ ({check_s:.3f} s); dropped pairs per prefill layer {prefill_drops}, in "
        f"decode {sum(decode_drops)} of {len(decode_drops) * SERVE_BATCH * cfg.experts_per_token}"
        f" (first step {decode_drops[:n_prefill]}); ties at the top-k boundary {ties}")
    if differ or caps != [1, 640]:
        raise AssertionError(f"routing differs from the CPU's in dispatches {differ[:8]} "
                             f"(capacities {caps})")

    # Layer 0's MoE output on its real input against an fp32 evaluation of
    # the same routing.
    x0, li, y0, ri = block_io[0]
    probs, k, cap, r = routes[ri]
    dev_r = transformer.Routing(*(v.to(device) for v in r))
    y32 = moe_fp32(x0, params["layers"], li, dev_r, cap)
    moe_rel = rel_l2(y0, y32)
    log(f"moe serve: layer {li}'s MoE output {tuple(y0.shape)} {y0.dtype} against an "
        f"fp32 evaluation of the same routing: relative L2 {moe_rel} (limit {MOE_REL})")
    if not moe_rel <= MOE_REL:
        raise AssertionError(f"layer 0's MoE output: relative L2 {moe_rel}")
    del block_io[:], x0, y0, y32, dev_r

    # Layer 0's q/k/v (D = 64, 16 query heads a KV head) through the kernel
    # against the plain version, then timed beside it and SDPA.  Under the
    # reference init v has a std of ~20 here, and the output scales with v:
    # FLASH_TOL's elementwise limits are stated for unit-scale v, so the gate
    # runs on v divided by the power of two nearest its std (exact in bf16),
    # and holds the unscaled output within FLASH_REL.  The unscaled elements
    # outside FLASH_TOL are printed beside SDPA's on the same inputs.
    q, kk, v, off = captured[0]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, kk, v))
    raw, want = fa.gqa_flash(q, kk, v, causal_offset=off), fa.gqa_flash_plain(q, kk, v, off)
    sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                          enable_gqa=True).transpose(1, 2)
    tol = FLASH_TOL[q.dtype]

    def outside(o):
        return int((~torch.isclose(o.float(), want.float(), rtol=tol, atol=tol)).sum())

    raw_rel, sdpa_rel = rel_l2(raw, want), rel_l2(sdpa, want)
    raw_outside, sdpa_outside = outside(raw), outside(sdpa)
    raw_err = (raw.float() - want.float()).abs().max().item()
    del raw, want, sdpa
    v_scale = 2.0 ** round(math.log2(v.float().std().item()))
    layer0_err, layer0_rel = flash_check(q, kk, v / v_scale, off,
                                         f"gqa_flash on layer 0's q, k and v / {v_scale:g}")
    log(f"moe serve: layer 0's v has std {v.float().std().item():.3f}; unscaled, the "
        f"kernel against the plain version: max abs diff {raw_err}, relative L2 {raw_rel} "
        f"(limit {FLASH_REL[q.dtype]}), {raw_outside} of {q.numel()} elements outside "
        f"{tol} (SDPA: relative L2 {sdpa_rel}, {sdpa_outside} outside)")
    if not raw_rel <= FLASH_REL[q.dtype]:
        raise AssertionError(f"gqa_flash on layer 0's q/k/v: relative L2 {raw_rel}")
    flash_t = dict(
        ms=time_ms(lambda: fa.launch(q, kk, v, off, "wgmma"), 50, warmup=5),
        plain_ms=time_ms(lambda: fa.gqa_flash_plain(q, kk, v), 5, warmup=2),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 50, warmup=5))
    b, sq, hq, d = q.shape
    nbytes, flops = flash_work(b, sq, kk.shape[1], hq, kk.shape[2], d, off, 2)
    flash_t["bound_ms"], flash_t["bound_by"] = bound_ms(nbytes, flops, BF16_FLOP_PER_S)
    log(f"moe serve: layer 0's q {tuple(q.shape)} {q.dtype}, k {tuple(kk.shape)}, v / "
        f"{v_scale:g}: kernel agrees with the plain version (max abs diff {layer0_err}, "
        f"relative L2 {layer0_rel}); Hopper kernel {flash_t['ms']:.6f} ms, plain "
        f"{flash_t['plain_ms']:.6f}, SDPA {flash_t['library_ms']:.6f}, bound "
        f"{flash_t['bound_ms']:.6f} by {flash_t['bound_by']}")
    del captured[:], q, kk, v, qt, kt, vt

    first_run = dict(prefill_s=out["prefill_s"], decode_s=out["decode_s"],
                     tokens_per_s=SERVE_BATCH * SERVE_TOKENS / out["decode_s"])
    first_logits = out["prefill_logits"]
    gen = toks.cpu()
    del out, cache, toks

    # A warm run: the times, and the same tokens (the combine has no atomics).
    warm = greedy_generate(params, prompts, cfg, SERVE_TOKENS)
    same = torch.equal(warm["tokens"].cpu(), gen)
    same_logits = torch.equal(warm["prefill_logits"], first_logits)
    warm_run = dict(prefill_s=warm["prefill_s"], decode_s=warm["decode_s"],
                    decode_ms_per_step=1e3 * warm["decode_s"] / SERVE_TOKENS,
                    tokens_per_s=SERVE_BATCH * SERVE_TOKENS / warm["decode_s"])
    log(f"moe serve, warm run: prefill {warm_run['prefill_s']:.6f} s, decode "
        f"{warm_run['decode_s']:.6f} s ({warm_run['decode_ms_per_step']:.6f} ms a step, "
        f"{warm_run['tokens_per_s']:.3f} tok/s); same tokens as the first run: {same}; "
        f"bit-equal prefill logits: {same_logits}")
    if not same:
        raise AssertionError("the warm run's tokens differ from the first run's")
    del warm, first_logits

    # A traced prefill and 8 decode steps: where the card's time goes.
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        traced = greedy_generate(params, prompts, cfg, 8)
        traced_wall = time.perf_counter() - t
    events = device_events(prof)
    busy_ms = busy_us(events) / 1e3
    per_name = {}
    for e in events:
        per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
    log(f"moe serve, traced (prefill {traced['prefill_s']:.6f} s + 8 decode steps "
        f"{traced['decode_s']:.6f} s): {traced_wall:.6f} s wall under the profiler, card "
        f"busy {busy_ms:.6f} ms = {100 * busy_ms / 1e3 / traced_wall:.6f} %")
    for name, ms in top:
        log(f"  device {ms:.6f} ms  {name[:100]}")
    del traced, params
    torch.cuda.empty_cache()
    return dict(arch=cfg.name, layers=cfg.num_layers, params=n_params, init_s=init_s,
                gib_on_card=on_card / 2**30, init_peak_gib=init_peak / 2**30,
                peak_gib=peak / 2**30, batch=SERVE_BATCH, prompt=SERVE_PROMPT,
                new_tokens=SERVE_TOKENS, first_run=first_run, warm_run=warm_run,
                warm_same_tokens=same, warm_same_prefill_logits=same_logits,
                dispatches=len(routes), routing_differ=len(differ),
                prefill_capacity=routes[0][2], decode_capacity=routes[-1][2],
                prefill_drops=prefill_drops, decode_drops=sum(decode_drops),
                decode_pairs=len(decode_drops) * SERVE_BATCH * cfg.experts_per_token,
                topk_boundary_ties=ties, moe_rel_l2=moe_rel, moe_rel_limit=MOE_REL,
                prefill_flash_launches=prefill_n, decode_flash_launches=decode_n,
                layer0_max_abs_err=layer0_err, layer0_rel_l2=layer0_rel,
                layer0_v_scale=v_scale, layer0_unscaled=dict(
                    max_abs_err=raw_err, rel_l2=raw_rel, outside=raw_outside,
                    sdpa_rel_l2=sdpa_rel, sdpa_outside=sdpa_outside),
                flash_d64=flash_t, traced_wall_s=traced_wall, traced_busy_ms=busy_ms,
                traced_busy_share=busy_ms / 1e3 / traced_wall,
                traced_top=[[n[:100], ms] for n, ms in top], launches=launches)


# --- the rwkv6 and zamba2 families: the chunked linear recurrence --------------

SSM_ARCHS = ("rwkv6-7b", "zamba2-7b")
# The forward at the serving path's batch and prompt length; the replay
# prefill (one decode step a prompt token, as the reference prefills these
# families) on prompts of 32 tokens with 16 new ones: 48 decode steps of
# host dispatch, 53-200 ms each on H100 hosts (PERF.md), run twice.  (64 + 32
# until the training phase needed the room: 48 steps fewer, ~21 s on a mid
# host, ~40 s on the slowest seen.)
SSM_BATCH, SSM_SEQ = 4, 2048
SSM_PROMPT, SSM_TOKENS = 32, 16
# The per-layer check: the first, middle and last layer's recurrence inputs
# of the serving run's 48 decode steps (one chunk; the decode path holds one
# token a chunk, so its inputs stay finite), through the chunked
# form against the sequential oracle in fp32, relative L2 of the outputs and
# final states over the (row, head) pairs whose chunks stay inside fp32's
# exp range.
SSM_CHECK_TOKENS = SSM_PROMPT + SSM_TOKENS
SSM_REL = 1e-4
# ln of fp32's largest value: the chunked form's k * exp(-cum) overflows
# where log|k| - cum passes it (the reference's expression, reproduced
# unguarded; PERF.md §6, ROADMAP queue 3).
LOG_FP32_MAX = math.log(torch.finfo(torch.float32).max)


def chunk_exponents(k, log_w, chunk):
    """Per (row, head): the largest exponent log|k_j| - cum_j that the
    chunked form's k * exp(-cum) reaches, and the largest chunk decay sum
    -sum(log_w) over channels.  NaN where the inputs are."""
    b, s, h, _ = k.shape
    nchunk = -(-s // chunk)

    def chunks(x):
        x = F.pad(x.float(), (0, 0, 0, 0, 0, nchunk * chunk - s))
        return x.reshape(b, nchunk, chunk, h, x.shape[-1])

    cum = chunks(log_w).cumsum(2)
    exponent = (torch.log(chunks(k).abs()) - cum).amax(dim=(1, 2, 4))
    return exponent, (-cum[:, :, -1]).amax(dim=(1, 3))


def ssm_serve_phase(cfgs=None, device="cuda"):
    """Phase 4c: rwkv6-7b and zamba2-7b at full width and full depth, one
    after the other, each freed before the next (``ssm_family_run``)."""
    out = {}
    for cfg in cfgs or [ARCHS[a] for a in SSM_ARCHS]:
        t = time.perf_counter()
        out[cfg.name] = ssm_family_run(cfg, device)
        out[cfg.name]["wall_s"] = time.perf_counter() - t
        torch.cuda.empty_cache()
    return out


def recurrence_check(inputs, u, chunk):
    """One layer's recorded recurrence inputs (B, T, H, .) in fp32 through
    the chunked form and the sequential oracle.  The (row, head) pairs whose
    chunks overflow (``chunk_exponents`` past LOG_FP32_MAX) are counted
    apart; the gate holds the others."""
    q, k, v, log_w = inputs
    y, st = ssm.chunked_linear_attention(q, k, v, log_w, u=u, chunk=chunk,
                                         return_state=True)
    y_ref, st_ref = ssm.reference_scan(q, k, v, log_w, u=u)
    exponent, decay = chunk_exponents(k, log_w, chunk)
    over = exponent > LOG_FP32_MAX                                   # (B, H)
    bad = ~(torch.isfinite(y).all(dim=(1, 3)) & torch.isfinite(st).all(dim=(2, 3)))
    ok = ~over
    out = dict(pairs=int(ok.numel()), overflow_pairs=int(over.sum()),
               nonfinite_pairs=int(bad.sum()), unexplained=int((bad & ok).sum()),
               oracle_nonfinite=int((~torch.isfinite(y_ref)).sum()),
               y_rel_l2=None, state_rel_l2=None, y_max_abs_diff=None,
               max_exponent=float(exponent.max()), max_decay=float(decay.max()))
    if ok.any():
        yo, yr = y.transpose(1, 2)[ok], y_ref.transpose(1, 2)[ok]
        out.update(y_rel_l2=rel_l2(yo, yr), state_rel_l2=rel_l2(st[ok], st_ref[ok]),
                   y_max_abs_diff=(yo - yr).abs().max().item())
    return out


def ssm_family_run(cfg, device="cuda"):
    """One family: init (seconds, bytes on the card, peak); the forward at
    B=4 x S=2048 through ``models.forward``, every chunked recurrence
    recorded (finite inputs and output, its largest exponent of k * exp(-cum)
    and chunk decay sum), gated on its flash launches (zamba2: one per
    shared-block application, all on the Hopper kernel at D 112; rwkv6:
    none) and on every non-finite value being the reference expression's
    fp32 overflow, then a warm forward for the time; ``greedy_generate``
    twice on the same prompts (equal tokens, finite logits, no flash launch:
    the replay prefill and decode attend through the plain chunked
    attention), the first run's recurrence inputs of three layers recorded
    and checked (``recurrence_check``); a traced short run for the card's
    busy share."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = init_params(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = sum(x.numel() for x in torch.utils._pytree.tree_leaves(params))
    on_card, init_peak = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
    log(f"ssm serve: {cfg.name} [{cfg.family}] {cfg.num_layers} layers d={cfg.d_model} "
        f"{n_params} parameters initialised in {init_s:.3f} s ({on_card / 2**30:.3f} GiB "
        f"on the card, peak {init_peak / 2**30:.3f} GiB)")
    if n_params != param_count(cfg):
        raise AssertionError(f"{cfg.name}: {n_params} parameters, param_count says "
                             f"{param_count(cfg)}")
    hybrid = cfg.family == "hybrid"
    groups = cfg.num_layers // cfg.shared_attn_every if hybrid else 0
    L = cfg.num_layers

    # The forward, every chunked recurrence recorded (calls run in layer order).
    calls = []
    recurrence = ssm.chunked_linear_attention

    def recording(q, k, v, log_w, u=None, chunk=128, initial_state=None,
                  return_state=False):
        out = recurrence(q, k, v, log_w, u=u, chunk=chunk, initial_state=initial_state,
                         return_state=return_state)
        exponent, decay = chunk_exponents(k, log_w, chunk)
        y = out[0] if return_state else out
        calls.append(dict(finite_in=all(bool(torch.isfinite(x).all())
                                        for x in (q, k, v, log_w)),
                          finite_out=bool(torch.isfinite(y).all()),
                          exponent=float(exponent.max()), decay=float(decay.max())))
        return out

    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SSM_BATCH, SSM_SEQ))).to(device)
    torch.cuda.reset_peak_memory_stats()
    ssm.chunked_linear_attention = recording
    fa.reset_launches()
    try:
        logits = model_forward(params, tokens, cfg)
        torch.cuda.synchronize()
    finally:
        ssm.chunked_linear_attention = recurrence
    launches = dict(fa.launches)
    nonfinite = int((~torch.isfinite(logits)).sum())
    shape = tuple(logits.shape)
    del logits
    overflow = [li for li, c in enumerate(calls)
                if c["finite_in"] and c["exponent"] > LOG_FP32_MAX]
    first_bad = next((li for li, c in enumerate(calls) if not c["finite_out"]), None)
    finite_calls = [c for c in calls if c["finite_in"]]
    decay_max = max(c["decay"] for c in finite_calls)
    want = dict.fromkeys(fa.launches, 0)            # no backward launch when serving
    if hybrid:
        want.update(gqa_flash=groups, wgmma=groups)
    if device != "cuda":
        want = {k: 0 for k in want}                 # a CPU rehearsal: the plain version
    log(f"ssm serve: {cfg.name} forward B={SSM_BATCH} S={SSM_SEQ}: logits {shape}, "
        f"{nonfinite} non-finite; {len(calls)} chunked recurrences, {len(finite_calls)} on "
        f"finite inputs; largest chunk decay sum {decay_max}, largest exponent of "
        f"k * exp(-cum) {max(c['exponent'] for c in finite_calls)} (fp32 overflows past "
        f"{LOG_FP32_MAX}); layers whose recurrence overflows {overflow}, first non-finite "
        f"output at layer {first_bad}; per layer (decay, exponent) "
        f"{[(round(c['decay'], 3), round(c['exponent'], 3)) for c in calls]}; gqa_flash "
        f"launches {launches}")
    if shape != (SSM_BATCH, SSM_SEQ, cfg.vocab_size) or len(calls) != L:
        raise AssertionError(f"{cfg.name}: logits {shape}, {len(calls)} recurrences")
    if launches != want:
        raise AssertionError(f"{cfg.name} forward: flash launches {launches}, expected {want}")
    # Every non-finite value is the reference expression's overflow: the first
    # non-finite recurrence output comes from finite inputs that overflow, a
    # recurrence on finite inputs that does not overflow gives finite outputs,
    # and without an overflow the logits are finite.
    unexplained = [li for li, c in enumerate(calls) if c["finite_in"] and not
                   c["finite_out"] and li not in overflow]
    if unexplained or (first_bad is not None and first_bad not in overflow) \
            or (not overflow and nonfinite):
        raise AssertionError(f"{cfg.name} forward: non-finite values not explained by an "
                             f"overflow: layers {unexplained}, first {first_bad}, overflow "
                             f"{overflow}, {nonfinite} non-finite logits")
    fa.reset_launches()
    t = time.perf_counter()
    warm = model_forward(params, tokens, cfg)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t
    forward_peak = torch.cuda.max_memory_allocated()
    if dict(fa.launches) != want:
        raise AssertionError(f"{cfg.name} warm forward: flash launches {fa.launches}")
    del warm, tokens

    # Serving: the replay prefill and greedy decode, twice; the first run's
    # recurrence inputs of the first, middle and last layer (and of the
    # forward's first overflowing one) recorded (each decode step runs one
    # recurrence a layer, in layer order: rwkv6 through the chunked form on
    # its one token, zamba2 through ``recurrence_step``).
    check_layers = sorted({0, L // 2, L - 1, *overflow[:1]})
    captured = {li: [] for li in check_layers}
    step_fn = "recurrence_step" if hybrid else "chunked_linear_attention"
    step_recurrence = getattr(ssm, step_fn)
    n_calls = [0]

    def capture(q, k, v, log_w, *args, **kw):
        li = n_calls[0] % L
        n_calls[0] += 1
        if li in captured:
            one = (lambda x: x[:, None]) if hybrid else (lambda x: x)
            captured[li].append(tuple(one(x).float().clone() for x in (q, k, v, log_w)))
        return step_recurrence(q, k, v, log_w, *args, **kw)

    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (SSM_BATCH, SSM_PROMPT))).to(device)
    fa.reset_launches()
    setattr(ssm, step_fn, capture)
    try:
        runs = [greedy_generate(params, prompts, cfg, SSM_TOKENS)]
    finally:
        setattr(ssm, step_fn, step_recurrence)
    runs.append(greedy_generate(params, prompts, cfg, SSM_TOKENS))
    if fa.launches["gqa_flash"] or any(r["prefill_flash_launches"] or
                                       r["decode_flash_launches"] for r in runs):
        raise AssertionError(f"{cfg.name} serving launched gqa_flash: {fa.launches}")
    same = torch.equal(runs[0]["tokens"], runs[1]["tokens"])
    serve_nonfinite = sum(int((~torch.isfinite(r[k])).sum()) for r in runs
                          for k in ("prefill_logits", "last_logits"))
    toks = runs[1]["tokens"]
    cache = runs[1]["cache"]
    steps = SSM_PROMPT + SSM_TOKENS
    timing = [dict(prefill_s=r["prefill_s"], decode_s=r["decode_s"],
                   prefill_ms_per_token=1e3 * r["prefill_s"] / SSM_PROMPT,
                   decode_ms_per_step=1e3 * r["decode_s"] / SSM_TOKENS,
                   tokens_per_s=SSM_BATCH * SSM_TOKENS / r["decode_s"]) for r in runs]
    log(f"ssm serve: {cfg.name} replay prefill {SSM_BATCH} x {SSM_PROMPT} + {SSM_TOKENS} "
        f"greedy tokens, twice: {timing}; same tokens {same}; {serve_nonfinite} non-finite "
        "logits; no flash launch")
    if hybrid:
        cache_ok = cache["length"] == steps and tuple(cache["k"].shape) == (
            groups, SSM_BATCH, steps, cfg.num_kv_heads, cfg.resolved_head_dim)
    else:
        cache_ok = tuple(cache["state"].shape) == (L, SSM_BATCH, cfg.d_model // 64, 64, 64)
    if not (same and cache_ok) or serve_nonfinite or toks.shape != (SSM_BATCH, SSM_TOKENS) \
            or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"{cfg.name} serving: same tokens {same}, cache ok {cache_ok}, "
                             f"{serve_nonfinite} non-finite, ids {toks.min()}..{toks.max()}")
    del runs, cache
    if n_calls[0] != L * SSM_CHECK_TOKENS:
        raise AssertionError(f"{cfg.name}: {n_calls[0]} recurrences in the first serving "
                             f"run, expected {L} x {SSM_CHECK_TOKENS}")
    chunk = cfg.attention_chunk // 8 or 128
    layer_check = {}
    for li, steps_in in captured.items():
        inputs = tuple(torch.cat(xs, dim=1) for xs in zip(*steps_in))
        u = None if hybrid else params["layers"]["u"][li].float()
        layer_check[li] = recurrence_check(inputs, u, chunk)
    del captured
    log(f"ssm serve: {cfg.name} the serving run's recurrence inputs ({SSM_CHECK_TOKENS} "
        f"tokens) of layers {check_layers}, chunked form vs reference_scan in fp32: "
        f"{layer_check} (limit {SSM_REL} over the (row, head) pairs that do not overflow)")
    for li, c in layer_check.items():
        if c["unexplained"] or c["oracle_nonfinite"] or c["overflow_pairs"] == c["pairs"] \
                or not (c["y_rel_l2"] <= SSM_REL and c["state_rel_l2"] <= SSM_REL):
            raise AssertionError(f"{cfg.name} layer {li}: chunked recurrence vs the "
                                 f"sequential oracle {c}")

    # A traced short run (1 replayed prompt token and 1 new one, both decode
    # steps) for the card's busy share: the profiler takes ~0.4 ms of host
    # time to read back each of the ~3,700 (rwkv6) to ~5,700 (zamba2) device
    # events of a step.
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        greedy_generate(params, prompts[:, :1], cfg, 1)
        traced_wall = time.perf_counter() - t
    events = device_events(prof)
    busy_ms = busy_us(events) / 1e3
    per_name = {}
    for e in events:
        per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"ssm serve: {cfg.name} traced 2 decode steps: {traced_wall:.6f} s wall under "
        f"the profiler, {len(events)} device events, card busy {busy_ms:.6f} ms = "
        f"{100 * busy_ms / 1e3 / traced_wall:.6f} %")
    for name, ms in top:
        log(f"  device {ms:.6f} ms  {name[:100]}")
    del params, prompts
    return dict(arch=cfg.name, family=cfg.family, layers=L, params=n_params, init_s=init_s,
                gib_on_card=on_card / 2**30, init_peak_gib=init_peak / 2**30,
                forward_peak_gib=forward_peak / 2**30, forward_s=forward_s,
                forward_shape=list(shape), forward_nonfinite=nonfinite,
                chunk_decay_max=decay_max, overflow_layers=overflow,
                first_nonfinite_layer=first_bad, forward_calls=calls,
                forward_flash=launches, layer_check=layer_check, serve=timing,
                same_tokens=same, serve_nonfinite=serve_nonfinite,
                prompt=SSM_PROMPT, new_tokens=SSM_TOKENS, traced_wall_s=traced_wall,
                traced_busy_ms=busy_ms, traced_busy_share=busy_ms / 1e3 / traced_wall,
                traced_events=len(events), traced_top=[[n[:100], ms] for n, ms in top])


# --- training: the backward kernels, the train step, the elastic trainer ------

TRAIN_ARCH = "internvl2-2b"
TRAIN_PARAMS = 1_889_146_880
# Four sequences of 2048 text tokens behind the config's 256-position
# prefix: attention at S 2304, Hq 16, Hkv 8, D 128 in bf16.
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
TRAIN_TIMED = 3
TRAIN_CHECK_LAYERS = (0, 12, 23)
# The backward kernels against the plain backward, elementwise as the card
# tests (tests/test_torch_cuda.py BWD_TOL) and as a whole by relative L2.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2, torch.float16: 2e-2,
           torch.float64: 1e-4}
# The fma route computes in fp32 and rounds once to the inputs' dtype:
# limits set from readings on an H100 80GB HBM3 (bf16 5.2e-5 at the train
# shape, fp32 2.3e-7 at D 32); fp16, rounded once to 11 bits, held to bf16's
# limit; float64 (the fp32 kernels on copies) to fp32's.
BWD_REL = {torch.float32: 2e-5, torch.bfloat16: 2.5e-4, torch.float16: 2.5e-4,
           torch.float64: 2e-5}
# The wgmma and mma routes round P and dS to bf16 (fp16 for fp16 inputs)
# before their products, as the forward rounds P: against the fp32 plain backward
# the forward's bf16 FLASH_REL, for either type; against the plain version
# that rounds where it rounds (``gqa_flash_bwd_lse_plain(round_bf16=True)``,
# which rounds to the inputs' 16-bit type), where only roundings that fall
# the other way differ, BWD_ROUNDED_REL.
BWD_WGMMA_REL = FLASH_REL[torch.bfloat16]
BWD_ROUNDED_REL = 1e-3
# The same on the model's own layers (0, 12, 23 of the chunked attention's
# q/k/v/dO at the first step; fma readings 2.5e-4, 3.1e-4, 7.6e-4): gradients
# there span many decades under the reference init (dO std 5e9 at layer 0,
# 3e-8 at layer 23), so the whole output's relative L2 is the measure.
TRAIN_LAYER_REL = 3e-3
# The whole model's first-step gradient through the backward kernels on the
# chunked path's own forward against that path's autodiff: the norm and
# each layer's within 10 % (readings on an H100 80GB HBM3: 3.4 % and 2.3 %,
# largest at the first layers: the layers' ~5e-4 accumulate through depth,
# over which the gradient grows ~1e17-fold under the reference init).
TRAIN_GRAD_REL = 0.1
# (name, B, Sq, Sk, Hq, Hkv, D, causal_offset, dtype): the train step's
# attention, and the fp32 D-32 shape of the launcher's reduced stablelm.
BWD_SHAPES = [("train", 4, 2304, 2304, 16, 8, 128, 0, torch.bfloat16),
              ("fp32-d32", 4, 128, 128, 4, 4, 32, 0, torch.float32),
              ("tiny", 4, 128, 128, 4, 2, 16, 0, torch.bfloat16),
              ("tiny-rank", 2, 128, 128, 4, 2, 16, 0, torch.bfloat16),
              ("tiny-edge", 2, 130, 167, 4, 2, 16, 37, torch.bfloat16)]
# The largest share of the fma route's time that the wgmma route's whole
# backward may take at the train shape, in turns (readings ~0.04 on an H100
# 80GB HBM3; the forward's Hopper kernel is held to 0.5 of mma.sync's).
BWD_RATIO = 0.2
ELASTIC_ARCH = "stablelm-1.6b"
BWD_ROUTE_KERNELS = fa.BWD_ROUTE_KERNELS


def bwd_work(b, sq, sk, hq, hkv, d, offset, elt):
    """(bytes, FLOPs) of each backward kernel, of the function and of the
    wgmma (and mma) route: each input read once, each output written once;
    a product over the unmasked (row, key) pairs is 2·D FLOPs a pair per
    head.  The function needs five products (S, dP, dV, dK, dQ).  The fma
    route's stats pass does Q K^T, its dK/dV four products (S, dP, dV,
    dK), its dQ three (S, dP, dQ); the wgmma and mma routes take the LSE
    from the forward and run seven: dQ (S, dP, dQ; it reads o and writes
    D_i) and dK/dV (S, dP, dV, dK), and so do the tiled route's fp32
    kernels.  The second S and dP are the price of determinism, not the
    bound's."""
    pairs = sum(min(sk, offset + r + 1) for r in range(sq))
    product = 2.0 * b * hq * d * pairs
    qs, ks, stats = elt * b * sq * hq * d, elt * b * sk * hkv * d, 4.0 * b * hq * sq
    return {"bwd_stats": (3 * qs + ks + 2 * stats, product),
            "bwd_dkdv": (2 * qs + 4 * ks + 2 * stats, 4 * product),
            "bwd_dq": (3 * qs + 2 * ks + 2 * stats, 3 * product),
            "bwd_wgmma_dq": (4 * qs + 2 * ks + 2 * stats, 3 * product),
            "bwd_wgmma_dkdv": (2 * qs + 4 * ks + 2 * stats, 4 * product),
            "bwd_mma_dq": (4 * qs + 2 * ks + 2 * stats, 3 * product),
            "bwd_mma_dkdv": (2 * qs + 4 * ks + 2 * stats, 4 * product),
            "bwd_tiled_dq": (4 * qs + 2 * ks + 2 * stats, 3 * product),
            "bwd_tiled_dkdv": (2 * qs + 4 * ks + 2 * stats, 4 * product),
            "gqa_flash_bwd": (4 * qs + 4 * ks, 5 * product),
            "gqa_flash_bwd_wgmma": (4 * qs + 4 * ks + stats, 7 * product)}


def bwd_check(q, k, v, o, do, offset, what, elementwise=True, rel_limit=None, route=None,
              lse=None):
    """The kernels of ``route`` (default: the inputs' ``bwd_route``; wgmma,
    mma and tiled read ``lse``) against ``gqa_flash_bwd_plain`` on the same
    inputs: each output within ``rel_limit`` relative L2 (default BWD_REL
    for fma and tiled, BWD_WGMMA_REL for wgmma and mma) and, on unit-normal
    inputs (``elementwise``), elementwise within BWD_TOL; a model layer's
    gradients span many decades under the reference init, so there the
    whole output's relative L2 is the measure.  The wgmma and mma routes are
    also held against the plain version that rounds P and dS to bf16 where
    they do, within BWD_ROUNDED_REL (and BWD_TOL elementwise) when
    ``elementwise``, printed otherwise; the tiled route against its own
    plain version, the unrounded one from the LSE, within BWD_REL.  Returns
    (max abs difference, largest relative L2, largest relative L2 against
    the plain version from the LSE or None)."""
    route = route or fa.bwd_route(q.dtype, q.shape[-1])
    got = fa.launch_bwd(q, k, v, o, do, offset, lse=lse, route=route)
    torch.cuda.synchronize()
    fp32 = route in ("fma", "tiled")
    wants = [(fa.gqa_flash_bwd_plain(q, k, v, o, do, offset),
              rel_limit or (BWD_REL[q.dtype] if fp32 else BWD_WGMMA_REL))]
    if route != "fma":
        wants.append((fa.gqa_flash_bwd_lse_plain(q, k, v, o, do, lse, offset,
                                                 round_bf16=not fp32),
                      (rel_limit or BWD_REL[q.dtype] if fp32 else BWD_ROUNDED_REL)
                      if elementwise else math.inf))
    err, rels = 0.0, [0.0] * len(wants)
    for i, (want, limit) in enumerate(wants):
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            if g.shape != w.shape or g.dtype != w.dtype or not torch.isfinite(g.float()).all():
                raise AssertionError(f"{what} {name}: bad output {tuple(g.shape)} {g.dtype}")
            e, r = (g.float() - w.float()).abs().max().item(), rel_l2(g, w)
            tol = BWD_TOL[w.dtype]
            if (elementwise and not torch.allclose(g.float(), w.float(), rtol=tol, atol=tol)) \
                    or not r <= limit:
                raise AssertionError(f"{what} {name} on {route}: kernels and plain version "
                                     f"{'(rounding) ' if i else ''}differ by up to {e}, "
                                     f"relative L2 {r} (limit {limit})")
            if i == 0:
                err = max(err, e)
            rels[i] = max(rels[i], r)
    return err, rels[0], rels[1] if route != "fma" else None


def flash_bwd_kernel_phase(report):
    """Phase 2 for the backward of ``gqa_flash``: each route against the
    plain backward, twice (equal bits), at the train step's shape (bf16, on
    both routes: the wgmma route on the forward kernel's LSE), the
    launcher's fp32 D-32 shape (the tiled route, its own, on the tiled
    forward's LSE, and fma beside it) and the tiny preset's
    shapes (bf16 D 16: the wgmma route on the narrow tiles, and the mma and
    fma routes, the yardsticks, beside it, all on the forward's LSE); at the
    train shape each
    kernel and each route's whole backward timed in turns by CUDA events and
    by profiler device time beside their bounds, the plain backward, and
    SDPA's backward (its forward + backward less its forward, for timing
    only); the wgmma route's whole backward at most BWD_RATIO of the fma
    route's.  Returns the five kernels' entries (the fma route's three,
    on no default path since the tiled route, leave the kernel line for the
    yardsticks' line in ``main``) and the tiny preset's
    (``flash_bwd_d16_timing``)."""
    gen = np.random.default_rng(11)
    ptx = ptxas_report(report, "flash_bwd_")
    for name, rep in ptx.items():
        log(f"{name}: ptxas {rep}")
    # the gate holds the pinned bf16 instantiations (D 64, 112, 128), the
    # narrow ones (tiles 16 and 32 wide) and the mma route's kernels; the
    # others' spills are reported (flash_dims_phase)
    def narrow(n):
        return "wgmma" in n and wgmma_template(n)[0] <= fa.WGMMA_NARROW

    gated = {n: r for n, r in ptx.items()
             if ("wgmma" in n and (pinned_wgmma(n) or narrow(n)))
             or ("_mma_kernel" in n and "wgmma" not in n)}
    spilled = {n: r for n, r in gated.items()
               if r.get("spill_stores", 0) or r.get("spill_loads", 0) or r["remarks"]}
    if ptx and (sum("_mma_kernel" in n and "wgmma" not in n for n in gated) != 8
                or sum(map(narrow, gated)) != 16):
        raise AssertionError(f"expected 8 mma and 16 narrow wgmma backward instantiations in "
                             f"the ptxas report: {sorted(gated)}")
    if spilled:
        raise AssertionError(f"the wgmma and mma backward kernels spill or serialise: {spilled}")
    checks, inputs = {}, {}
    for what, b, sq, sk, hq, hkv, d, off, dtype in BWD_SHAPES:
        q, k, v = flash_inputs(gen, b, sq, sk, hq, hkv, d, dtype)
        do = torch.from_numpy(gen.normal(size=(b, sq, hq, d)).astype(np.float32)) \
            .to("cuda", dtype)
        broute = fa.bwd_route(dtype, d)
        # the narrow tiles' yardstick, the mma route, beside them by name
        routes = ["fma", broute] + (["mma"] if what.startswith("tiny") else [])
        o, lse = fa.launch(q, k, v, off, with_lse=True) if broute != "fma" \
            else (fa.launch(q, k, v, off), None)
        inputs[what] = q, k, v, o, do, lse
        for route in routes:
            checks[what, route] = bwd_check(q, k, v, o, do, off,
                                            f"gqa_flash_bwd {what} {route}", route=route, lse=lse)
            again = fa.launch_bwd(q, k, v, o, do, off, lse=lse, route=route)
            if not all(torch.equal(a, c) for a, c in
                       zip(again, fa.launch_bwd(q, k, v, o, do, off, lse=lse, route=route))):
                raise AssertionError(f"gqa_flash_bwd {what} {route}: two runs differ")
            log(f"gqa_flash_bwd {what} B={b} Sq={sq} Sk={sk} Hq={hq} Hkv={hkv} D={d} "
                f"{str(dtype)[6:]} on {route}: agrees with the plain backward (max abs diff "
                f"{checks[what, route][0]}, largest relative L2 {checks[what, route][1]}, "
                f"against the plain version from the LSE {checks[what, route][2]}); two runs "
                f"equal")

    what, b, sq, sk, hq, hkv, d, off, dtype = BWD_SHAPES[0]
    q, k, v, o, do, lse = inputs[what]
    train_routes = {r: BWD_ROUTE_KERNELS[r] for r in ("fma", "wgmma")}
    plans = {route: fa.plan_bwd(q, k, v, o, do, off, route=route) for route in train_routes}
    bufs = {"fma": fa.bwd_buffers(q, k), "wgmma": fa.bwd_buffers(q, k, lse)}
    for route, names in train_routes.items():   # LSE and D_i in place for the others
        for which in range(len(names)):
            fa.launch_bwd_kernel(which, q, k, v, o, do, bufs[route], off, plans[route])
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        return torch.autograd.grad(out, (qt, kt, vt), dot)

    runs = {}
    for route, names in train_routes.items():
        for which, name in enumerate(names):
            runs[name] = (lambda w=which, r=route: fa.launch_bwd_kernel(
                w, q, k, v, o, do, bufs[r], off, plans[r]))
    runs.update(whole=lambda: fa.launch_bwd(q, k, v, o, do, off, route="fma"),
                whole_wgmma=lambda: fa.launch_bwd(q, k, v, o, do, off, lse=lse),
                plain=lambda: fa.gqa_flash_bwd_plain(q, k, v, o, do, off),
                plain_lse=lambda: fa.gqa_flash_bwd_lse_plain(q, k, v, o, do, lse, off,
                                                             round_bf16=True),
                sdpa_fwd=sdpa_fwd, sdpa_fwd_bwd=sdpa_fwd_bwd)
    turns = {key: [] for key in runs}
    for key in list(runs) + list(runs)[::-1]:
        turns[key].append(time_ms(runs[key], 5, warmup=2))
    t = {key: float(np.mean(val)) for key, val in turns.items()}
    # profiler device ms per call; a kernel run makes one device event a
    # call, so its busy time per recorded event (the profiler drops events
    # now and then: 4 of 5 recorded in some turns on an H100)
    kernel_names = fa.BWD_KERNELS + fa.BWD_WGMMA_KERNELS
    dev = {}
    for key in runs:
        us, n = device_trace(runs[key], 5)
        dev[key] = (us / n if key in kernel_names else us / 5) / 1e3 if us > 0 else None
    sdpa_bwd = t["sdpa_fwd_bwd"] - t["sdpa_fwd"]
    sdpa_bwd_dev = (dev["sdpa_fwd_bwd"] - dev["sdpa_fwd"]
                    if dev["sdpa_fwd_bwd"] and dev["sdpa_fwd"] else None)
    work = bwd_work(b, sq, sk, hq, hkv, d, off, 2)
    whole_bound, whole_by = bound_ms(*work["gqa_flash_bwd"], BF16_FLOP_PER_S)
    route_bound, route_by = bound_ms(*work["gqa_flash_bwd_wgmma"], BF16_FLOP_PER_S)
    ratio = t["whole_wgmma"] / t["whole"]
    log(f"gqa_flash_bwd train shape, in turns {turns}")
    done = {route: sum(work[name][1] for name in names)
            for route, names in train_routes.items()}
    log(f"gqa_flash_bwd train shape: wgmma route {t['whole_wgmma']:.6f} ms/call (device "
        f"{dev['whole_wgmma']}; {ratio:.4f} of the fma route, limit {BWD_RATIO}), fma route "
        f"{t['whole']:.6f} (device {dev['whole']}); the function's bound {whole_bound:.6f} by "
        f"{whole_by} ({work['gqa_flash_bwd'][1] / 1e9:.3f} GFLOP), the wgmma route's seven "
        f"products {route_bound:.6f} by {route_by} ({done['wgmma'] / 1e9:.3f} GFLOP; the fma "
        f"route does {done['fma'] / 1e9:.3f}); plain {t['plain']:.6f} (device {dev['plain']}), "
        f"the rounding plain version {t['plain_lse']:.6f}; SDPA's backward {sdpa_bwd:.6f} "
        f"(device {sdpa_bwd_dev}; forward {t['sdpa_fwd']:.6f}, forward + backward "
        f"{t['sdpa_fwd_bwd']:.6f})")
    if not ratio <= BWD_RATIO:
        raise AssertionError(f"the wgmma backward takes {t['whole_wgmma']} ms, more than "
                             f"{BWD_RATIO} of the fma route's {t['whole']} ms")
    entries = []
    for route, names in train_routes.items():
        whole = "whole" if route == "fma" else "whole_wgmma"
        err, rel, rel_rounded = checks["train", route]
        for name in names:
            bound, by = bound_ms(*work[name], BF16_FLOP_PER_S)
            log(f"{name}: {t[name]:.6f} ms/call (device {dev[name]}), "
                f"{work[name][1] / t[name] / 1e9:.3f} TFLOP/s, bound {bound:.6f} by {by} "
                f"({bound / t[name]:.4f} of it)")
            kernel = (f"flash_{name}_kernel" if route == "fma"
                      else f"flash_bwd_{name[len('bwd_wgmma_'):]}_wgmma_kernel")
            entries.append(dict(
                name=f"gqa_flash_{name}", route="cuda", kernel=kernel, bwd_route=route,
                source="src/repro_torch/csrc/flash_attention_bwd.cu",
                replaces="src/repro/models/common.py:255 (XLA autodiff of chunked_attention; "
                         "the Pallas gqa_flash at src/repro/kernels/flash_attention.py:94 has "
                         "no gradient)",
                max_abs_err=err, rel_l2=rel, rel_l2_rounded=rel_rounded,
                **({"max_abs_err_f32": checks["fp32-d32", "fma"][0],
                    "rel_l2_f32": checks["fp32-d32", "fma"][1]} if route == "fma" else {}),
                ms=t[name], device_ms=dev[name],
                plain_ms=t["plain"] if route == "fma" else t["plain_lse"],
                plain_device_ms=dev["plain"] if route == "fma" else dev["plain_lse"],
                plain_of="the whole backward" + ("" if route == "fma" else
                                                 ", from the LSE, rounding as the kernels"),
                bound_ms=bound, bound_by=by, bound_share=bound / t[name],
                library_ms=sdpa_bwd, library_device_ms=sdpa_bwd_dev,
                library_of="the whole backward: SDPA forward + backward less forward",
                whole_ms=t[whole], whole_device_ms=dev[whole], whole_bound_ms=whole_bound,
                whole_gflop=work["gqa_flash_bwd"][1] / 1e9, kernels_gflop=done[route] / 1e9,
                **({"route_bound_ms": route_bound, "wgmma_over_fma": ratio}
                   if route == "wgmma" else {}),
                shape=f"B={b} Sq={sq} Sk={sk} Hq={hq} Hkv={hkv} D={d} bf16 causal",
                ptxas={n: r for n, r in ptx.items() if kernel in n},
                turns={key: turns[key] for key in (name, whole, "plain", "plain_lse")}))
    tiny = ("tiny", "tiny-rank", "tiny-edge")
    return entries, flash_bwd_d16_timing(
        inputs["tiny"], {route: [max(checks[w, route][i] for w in tiny) for i in range(3)]
                         for route in ("wgmma", "mma")})


def flash_bwd_d16_timing(inputs, checks):
    """The backward at train_carbon_aware's tiny preset (bf16, D 16): the
    wgmma route's two kernels on the 16-wide tiles and the whole route, and
    beside them the mma route's (by name, the yardstick it replaced) and the
    fma route, in turns by CUDA events and by profiler device time, beside
    the function's bound, the plain backward from the LSE (rounding as the
    kernels) and SDPA's backward (forward + backward less forward); all sit
    at the launch floor, so no ratio is gated.  ``checks`` holds each route's
    (max abs difference, relative L2, relative L2 to the rounding plain
    version) over the tiny shapes.  Returns the wgmma route's entries (the
    whole route's, then one a kernel) and the mma route's (the yardsticks'
    line)."""
    q, k, v, o, do, lse = inputs
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    pls = {r: fa.plan_bwd(q, k, v, o, do, route=r) for r in ("wgmma", "mma")}
    bufs = {r: fa.bwd_buffers(q, k, lse) for r in pls}
    for r, pl in pls.items():                     # D_i in place for dK/dV
        for which in range(len(fa.BWD_ROUTE_KERNELS[r])):
            fa.launch_bwd_kernel(which, q, k, v, o, do, bufs[r], 0, pl)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        return torch.autograd.grad(out, (qt, kt, vt), dot)

    kernel_names = fa.BWD_WGMMA_KERNELS + fa.BWD_MMA_KERNELS
    runs = {name: (lambda w=which, r=r: fa.launch_bwd_kernel(w, q, k, v, o, do, bufs[r], 0,
                                                               pls[r]))
            for r in pls for which, name in enumerate(fa.BWD_ROUTE_KERNELS[r])}
    runs.update(whole=lambda: fa.launch_bwd(q, k, v, o, do, 0, lse=lse),
                mma=lambda: fa.launch_bwd(q, k, v, o, do, 0, lse=lse, route="mma"),
                previous=lambda: fa.launch_bwd(q, k, v, o, do, 0, route="fma"),
                plain=lambda: fa.gqa_flash_bwd_lse_plain(q, k, v, o, do, lse, 0,
                                                         round_bf16=True),
                sdpa_fwd=sdpa_fwd, sdpa_fwd_bwd=sdpa_fwd_bwd)
    turns = {key: [] for key in runs}
    for key in list(runs) + list(runs)[::-1]:
        turns[key].append(time_ms(runs[key], 100, warmup=10))
    t = {key: float(np.mean(val)) for key, val in turns.items()}
    dev = {}
    for key in runs:
        us, n = device_trace(runs[key], 20)
        dev[key] = (us / n if key in kernel_names else us / 20) / 1e3 if us > 0 else None
    sdpa_bwd = t["sdpa_fwd_bwd"] - t["sdpa_fwd"]
    sdpa_bwd_dev = (dev["sdpa_fwd_bwd"] - dev["sdpa_fwd"]
                    if dev["sdpa_fwd_bwd"] and dev["sdpa_fwd"] else None)
    work = bwd_work(b, sq, sk, hq, hkv, d, 0, 2)
    bound, by = bound_ms(*work["gqa_flash_bwd"], BF16_FLOP_PER_S)
    log(f"gqa_flash_bwd tiny shape bf16 D=16 (wgmma; mma and fma beside it), in turns {turns}")
    log(f"gqa_flash_bwd tiny shape bf16 D=16: the wgmma route {t['whole']:.6f} ms/call (device "
        f"{dev['whole']}; kernels {[dev[n] for n in fa.BWD_WGMMA_KERNELS]}), the mma route "
        f"{t['mma']:.6f} (device {dev['mma']}; kernels {[dev[n] for n in fa.BWD_MMA_KERNELS]}),"
        f" the fma route {t['previous']:.6f} (device {dev['previous']}); the function's bound "
        f"{bound:.6f} by {by} ({work['gqa_flash_bwd'][1] / 1e9:.6f} GFLOP); the rounding plain "
        f"version {t['plain']:.6f} (device {dev['plain']}); SDPA's backward {sdpa_bwd:.6f} "
        f"(device {sdpa_bwd_dev})")
    out = {}
    for route, whole, tile in (("wgmma", "whole", "16, 0, bf16"), ("mma", "mma", "bf16, 16")):
        err, rel, rel_rounded = checks[route]
        common = dict(route="cuda", bwd_route=route,
                      source="src/repro_torch/csrc/flash_attention_bwd.cu",
                      replaces="src/repro/models/common.py:255 (XLA autodiff of "
                               "chunked_attention; the Pallas gqa_flash at "
                               "src/repro/kernels/flash_attention.py:94 has no gradient)",
                      max_abs_err=err, rel_l2=rel, rel_l2_rounded=rel_rounded,
                      plain_ms=t["plain"], plain_device_ms=dev["plain"],
                      plain_of="the whole backward, from the LSE, rounding as the kernels",
                      library_ms=sdpa_bwd, library_device_ms=sdpa_bwd_dev,
                      library_of="the whole backward: SDPA forward + backward less forward",
                      shape=f"B={b} Sq={sq} Sk={sk} Hq={hq} Hkv={hkv} D={d} bf16 causal")
        name = "gqa_flash_bwd_d16" if route == "wgmma" else "gqa_flash_bwd_mma_d16"
        out[route] = [dict(name=name, kernel=f"flash_bwd_{{dq,dkdv}}_{route}_kernel<{tile}> "
                                             f"(the {route} route)",
                           ms=t[whole], device_ms=dev[whole], bound_ms=bound, bound_by=by,
                           bound_share=bound / t[whole], previous="the fma route",
                           previous_ms=t["previous"], previous_device_ms=dev["previous"],
                           turns={key: turns[key] for key in (whole, "previous", "plain")},
                           **common)]
        for name in fa.BWD_ROUTE_KERNELS[route]:
            kb, kby = bound_ms(*work[name], BF16_FLOP_PER_S)
            which = name[len(f"bwd_{route}_"):]
            out[route].append(dict(
                name=f"gqa_flash_{name}" + ("_d16" if route == "wgmma" else ""),
                kernel=f"flash_bwd_{which}_{route}_kernel<{tile}>", ms=t[name],
                device_ms=dev[name], bound_ms=kb, bound_by=kby, bound_share=kb / t[name],
                whole_ms=t[whole], turns={key: turns[key] for key in (name, whole, "plain")},
                **common))
    return out["wgmma"], out["mma"]


def traced_step(fn):
    """The card's busy microseconds and device events that ``torch.profiler``
    records over one call of ``fn``, and the 8 names that took the most
    device milliseconds."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = device_events(prof)
    by_name = {}
    for e in events:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + \
            (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return busy_us(events), len(events), top


def train_model_flops(cfg, b, s):
    """Model FLOPs of one step (forward and backward, no recompute): 6 per
    weight of every matrix (the embedding is a gather) per position, and
    the causal attention's two products, three times over."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    weights = param_count(cfg) - cfg.vocab_size * d
    attention = 3 * 2 * 2.0 * b * cfg.num_heads * hd * (s * (s + 1) / 2) * cfg.num_layers
    return 6.0 * weights * b * s + attention


def grad_probe(cfg, state, batch, backend, forward=None, capture=False):
    """Loss, gradient norm and each layer's gradient norm of one forward and
    backward (no update) on ``backend``'s attention; ``forward`` stands in
    for the flash route's forward (q, k, v, offset, with_lse) -> (o, lse) in
    this call.  With ``capture``
    (the chunked attention), also layers TRAIN_CHECK_LAYERS' attention
    inputs (q, k, v), output and output gradient."""
    from repro_torch.models import common
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.step import chunked_cross_entropy, leaves, unflatten
    cfg = dataclasses.replace(cfg, attention_backend=backend)
    taken, calls = {}, [0]
    inner = common.chunked_attention
    saved = fa._forward

    def capture_attention(q, k, v, offset, chunk):
        out = inner(q, k, v, offset, chunk)
        li = calls[0]
        calls[0] += 1
        if li in TRAIN_CHECK_LAYERS:       # the forward's call (recompute comes later)
            taken[li] = [q.detach(), k.detach(), v.detach(), out.detach()]
            out.register_hook(lambda g, li=li: taken[li].append(g.detach()))
        return out

    flat = leaves(state.params)
    live = [t.detach().requires_grad_() for _, t in flat]
    if capture:
        common.chunked_attention = capture_attention
    fa._forward = forward or fa._forward
    try:
        x, head = model_forward(unflatten([p for p, _ in flat], live), batch["tokens"],
                                cfg, return_hidden=True,
                                prefix_embeds=batch["prefix_embeds"])
        loss = chunked_cross_entropy(x, head, batch["tokens"], prefix=cfg.prefix_len)
        grads = torch.autograd.grad(loss, live)
    finally:
        common.chunked_attention = inner
        fa._forward = saved
    layers = [g for (path, _), g in zip(flat, grads) if path[0] == "layers"]
    per_layer = [global_norm([g[li] for g in layers]).item() for li in range(cfg.num_layers)]
    return loss.item(), global_norm(grads).item(), per_layer, taken


def train_phase(device="cuda"):
    """internvl2-2b trained at full width and depth on the card (seed-0
    fp32 master weights, AdamW moments in fp32): ``PrefetchLoader`` batches
    of 4 x 2048 tokens behind the 256-position prefix; the chunked
    attention's forward and backward first (loss, gradient norm, and the
    check layers' attention inputs and output gradients, on which the
    forward kernel and the backward kernels are held against their plain
    versions); the first step's gradient through the backward kernels
    under the chunked forward (``grad_probe``) held against the chunked
    path's autodiff; then the flash
    train step on the first batch twice from one state (equal bits; launch
    gates), 3 timed steps (forward + backward and optimizer split by CUDA
    events around ``adamw_update``) and a traced one; then the elastic
    trainer and the launcher on reduced stablelm-1.6b."""
    from repro_torch.train import (DataConfig, OptimizerConfig, PrefetchLoader, SyntheticLM,
                                   init_state, make_train_step)
    from repro_torch.train import step as step_mod
    from repro_torch.train.step import leaves

    cfg = ARCHS[TRAIN_ARCH]
    if param_count(cfg) != TRAIN_PARAMS:
        raise AssertionError(f"{cfg.name}: {param_count(cfg)} params")
    torch.cuda.empty_cache()               # the serving phases' blocks
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    state = init_state(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    state_gib = sum(x.numel() * x.element_size() for tree in (state.params, state.m, state.v)
                    for _, x in leaves(tree)) / 2**30
    log(f"train: {cfg.name} init {init_s:.3f} s, {param_count(cfg)} params, state "
        f"{state_gib:.3f} GiB (fp32 params and both moments), allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    loader = PrefetchLoader(SyntheticLM(DataConfig(
        batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, vocab_size=cfg.vocab_size, seed=0)),
        device=device, model_cfg=cfg)
    batches = [next(loader) for _ in range(2 + TRAIN_TIMED)]
    loader.close()
    s = TRAIN_SEQ + cfg.prefix_len

    # The chunked attention's gradient, and the kernels on its own inputs.
    t = time.perf_counter()
    loss_c, gnorm_c, layers_c, taken = grad_probe(cfg, state, batches[0], "chunked",
                                                  capture=True)
    chunked_s = time.perf_counter() - t
    layer_checks = {}
    for li in TRAIN_CHECK_LAYERS:
        q, k, v, o, do = taken[li]
        # the step's forward kernel (its route: wgmma) and the LSE it saves
        out, lse = fa.launch(q, k, v, 0, with_lse=True)
        fwd = dict(plain=rel_l2(out, fa.gqa_flash_plain(q, k, v)), chunked=rel_l2(out, o))
        if not max(fwd.values()) <= ATTN_REL:
            raise AssertionError(f"train layer {li}: the forward kernel differs from the "
                                 f"plain version and the chunked attention by relative L2 "
                                 f"{fwd} (limit {ATTN_REL})")
        layer_checks[li] = dict(fwd_rel_l2=fwd, do_std=float(do.float().std()))
        for route in ("wgmma", "fma"):     # the step's route, and the earlier one beside it
            err, rel, rel_rounded = bwd_check(q, k, v, o, do, 0, f"train layer {li}",
                                              elementwise=False, rel_limit=TRAIN_LAYER_REL,
                                              route=route, lse=lse)
            layer_checks[li][route] = dict(max_abs_err=err, rel_l2=rel,
                                           rel_l2_rounded=rel_rounded)
    del taken, out, lse
    log(f"train: chunked attention forward + backward {chunked_s:.3f} s, loss {loss_c}, "
        f"gradient norm {gnorm_c}; on its layers' q/k/v the forward kernel (relative L2 "
        f"against the plain version and the chunked attention, limit {ATTN_REL}) and, on "
        f"their dO, the backward kernels {layer_checks}")

    # The first step's gradient through the backward kernels under the
    # chunked forward, from one state on one batch: that pairing sees the
    # chunked path's own activations, so only the backward differs, and it is
    # gated.  (The pairings whose forwards differ were printed only until the
    # shard phase's cell (f) needed their time: under the reference init the
    # gradient moves 3x with the KV chunk size alone.)
    from repro_torch.models import common

    def chunked_forward(q, k, v, offset, with_lse=False):
        # the backward kernels read the LSE of this forward's own q and k
        return (common.chunked_attention(q, k, v, offset, cfg.attention_chunk),
                fa.gqa_flash_lse_plain(q, k, offset) if with_lse else None)

    probes = {"chunked": (loss_c, gnorm_c, layers_c),
              "chunked forward, backward kernels": grad_probe(
                  cfg, state, batches[0], "flash", forward=chunked_forward)[:3]}
    for name, (loss, gnorm, per_layer) in probes.items():
        log(f"train probe {name}: loss {loss}, gradient norm {gnorm} ({gnorm / gnorm_c} of "
            f"the chunked one); each layer's over the chunked one's "
            f"{[a / b for a, b in zip(per_layer, layers_c)]}")
    loss_k, gnorm_k, layers_k = probes["chunked forward, backward kernels"]
    grad_off = max(abs(a / b - 1) for a, b in zip([gnorm_k] + layers_k, [gnorm_c] + layers_c))
    if not (loss_k == loss_c and grad_off <= TRAIN_GRAD_REL):
        raise AssertionError(f"train: under the chunked forward the backward kernels give loss "
                             f"{loss_k} (chunked {loss_c}) and gradient norms up to {grad_off} "
                             f"from the chunked path's (limit {TRAIN_GRAD_REL})")

    opt = OptimizerConfig(warmup_steps=1, total_steps=2 + TRAIN_TIMED)
    step = make_train_step(cfg, opt)
    marks = []
    adamw = step_mod.adamw_update

    def timed_adamw(*args, **kw):          # events around the optimizer
        a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = adamw(*args, **kw)
        z.record()
        marks.append((a, z))
        return out

    step_mod.adamw_update = timed_adamw
    try:
        fa.reset_launches()
        t = time.perf_counter()
        s1, m1 = step(state, batches[0])
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t
        launches = dict(fa.launches)
        L = cfg.num_layers
        want = dict.fromkeys(fa.launches, 0)
        if device == "cuda":
            want.update(gqa_flash=2 * L, wgmma=2 * L, gqa_flash_bwd=L,
                        **{n: L for n in fa.BWD_WGMMA_KERNELS})
        if launches != want:
            raise AssertionError(f"train step: flash launches {launches}, expected {want}")
        moved = [p for (p, a), (_, b) in zip(leaves(state.params), leaves(s1.params))
                 if torch.equal(a, b)]
        if moved:
            raise AssertionError(f"train step: leaves that did not move {moved}")
        host = [x.cpu() for _, x in leaves(s1.params)]
        mv_bits = [int(x.view(torch.int32).sum(dtype=torch.int64))
                   for tree in (s1.m, s1.v) for _, x in leaves(tree)]
        del s1
        nccl = nccl_step_check(cfg, opt, state, batches[0], m1, host, mv_bits)
        s1, m1b = step(state, batches[0])
        torch.cuda.synchronize()
        same = (all(float(m1[k]) == float(m1b[k]) for k in m1)
                and all(torch.equal(a, x.cpu()) for a, (_, x) in zip(host, leaves(s1.params)))
                and mv_bits == [int(x.view(torch.int32).sum(dtype=torch.int64))
                                for tree in (s1.m, s1.v) for _, x in leaves(tree)])
        del host, state
        if not same:
            raise AssertionError("two train steps from one state differ")
        metrics = [{k: float(v) for k, v in m1.items()}]
        log(f"train: first step {first_s:.3f} s, loss {metrics[0]['loss']} (chunked "
            f"{loss_c}), gradient norm {metrics[0]['grad_norm']} (chunked {gnorm_c}); flash "
            f"launches {launches}; every leaf moved; the step again from the same state: "
            f"params bit for bit, moments' bit sums and metrics equal")

        state = s1
        torch.cuda.reset_peak_memory_stats()
        timed = []
        for i in range(1, 1 + TRAIN_TIMED):
            marks.clear()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            start.record()
            state, m = step(state, batches[i])
            end.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            a, z = marks[0]
            timed.append(dict(wall_s=wall, step_ms=start.elapsed_time(end),
                              fwd_bwd_ms=start.elapsed_time(a), optimizer_ms=a.elapsed_time(z)))
            metrics.append({k: float(v) for k, v in m.items()})
        peak = torch.cuda.max_memory_allocated()
        busy_us, n_events, top = traced_step(lambda: step(state, batches[-1]))
    finally:
        step_mod.adamw_update = adamw
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]) for m in metrics):
        raise AssertionError(f"train: non-finite metrics {metrics}")
    wall = float(np.mean([x["wall_s"] for x in timed]))
    flops = train_model_flops(cfg, TRAIN_BATCH, s)
    out = dict(arch=cfg.name, params=param_count(cfg), state_gib=state_gib, init_s=init_s,
               busy_share=busy_us / 1e3 / (wall * 1e3), traced_events=n_events,
               traced_top_ms=top,
               batch=TRAIN_BATCH, text_tokens=TRAIN_SEQ, positions=s, first_step_s=first_s,
               metrics=metrics, steps=timed, step_s=wall,
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / wall, positions_per_s=TRAIN_BATCH * s / wall,
               model_tflop=flops / 1e12, mfu=flops / wall / BF16_FLOP_PER_S,
               peak_gib=peak / 2**30, launches=launches, chunked=dict(
                   loss=loss_c, grad_norm=gnorm_c, wall_s=chunked_s), layer_checks=layer_checks,
               probes={name: dict(loss=v[0], grad_norm=v[1], layers=v[2])
                       for name, v in probes.items()}, grad_off=grad_off, nccl=nccl)
    log(f"train: {TRAIN_TIMED} timed steps {timed}; {wall:.3f} s a step, "
        f"{out['tokens_per_s']:.1f} text tokens/s ({out['positions_per_s']:.1f} positions/s), "
        f"{flops / 1e12:.2f} model TFLOP a step, {out['mfu']:.4f} of 989 TFLOP/s; peak "
        f"{out['peak_gib']:.3f} GiB; traced step busy {out['busy_share']} of the mean "
        f"step, top device ms {top}; losses "
        f"{[m['loss'] for m in metrics]}")
    del state, batches
    out["elastic"] = elastic_phase(device)
    return out


def nccl_step_check(cfg, opt, state, batch, metrics, host, mv_bits):
    """(e) The gated train step again from the same state, through
    ``make_train_step(cfg, rules=)`` on a 1 x 1 mesh of a one-rank NCCL
    process group (the sharded code path at the world of one): its loss,
    grad norm, every leaf and the moments' bits must equal the unsharded
    step's; the loss then crosses an NCCL ``all_reduce`` of the world."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import DistMesh, make_mesh
    from repro_torch.models.common import LogicalRules
    from repro_torch.train import make_train_step
    from repro_torch.train.step import leaves

    with tempfile.TemporaryDirectory(prefix="nccl_") as tmp:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(tmp, "rdzv"),
                                rank=0, world_size=1)
        try:
            rules = LogicalRules(DistMesh(make_mesh((1, 1), ("data", "model")),
                                          device_type="cuda"))
            t = time.perf_counter()
            sn, mn = make_train_step(cfg, opt, rules=rules)(state, batch)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t
            loss = mn["loss"].clone()
            dist.all_reduce(loss)
            torch.cuda.synchronize()
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    same = dict(
        metrics=all(float(mn[k]) == float(metrics[k]) for k in metrics),
        params=all(torch.equal(a, x.cpu()) for a, (_, x) in zip(host, leaves(sn.params))),
        moments=mv_bits == [int(x.view(torch.int32).sum(dtype=torch.int64))
                            for tree in (sn.m, sn.v) for _, x in leaves(tree)],
        all_reduce=float(loss) == float(metrics["loss"]))
    del sn
    log(f"train (e): the step through make_train_step(cfg, rules) on a 1 x 1 mesh over a "
        f"one-rank {backend} group ({step_s:.3f} s): equal to the unsharded step {same}")
    if not all(same.values()):
        raise AssertionError(f"train (e): the sharded step at world size 1 differs: {same}")
    return dict(backend=backend, step_s=step_s, **same)


def elastic_phase(device="cuda"):
    """``python -m repro_torch.launch.train --arch stablelm-1.6b --reduced``
    in its own process, then in this one the elastic trainer's plan of
    k 1, 0, 1 with a fault, a second trainer resuming from its checkpoint,
    and the launcher with ``--compress``: launch counts against the steps
    taken (the fp32 D-32 route: two forwards and a backward a layer)."""
    import tempfile

    from repro_torch.configs import reduced
    from repro_torch.elastic import ElasticTrainer, RescalePlan
    from repro_torch.launch import train as launch_train
    from repro_torch.train import DataConfig, OptimizerConfig, SyntheticLM

    cfg = reduced(ARCHS[ELASTIC_ARCH])
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                               ELASTIC_ARCH, "--reduced", "--steps", "6", "--device", device,
                               "--ckpt",
                               os.path.join(tmp, "cli")], capture_output=True, text=True,
                              env=env, cwd=root, timeout=300)
        cli_s = time.perf_counter() - t
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or len(lines) != 2 \
                or not lines[1].endswith("resumed_from_ckpt=False"):
            raise AssertionError(f"launch.train exited {proc.returncode}: {proc.stdout}"
                                 f"{proc.stderr[-2000:]}")
        log(f"elastic: python -m repro_torch.launch.train --arch {ELASTIC_ARCH} --reduced "
            f"({cli_s:.3f} s): {lines}")

        data = SyntheticLM(DataConfig(batch=4, seq_len=32, vocab_size=cfg.vocab_size, seed=3))
        fa.reset_launches()
        tr = ElasticTrainer(cfg, data, OptimizerConfig(total_steps=60), os.path.join(tmp, "el"),
                            device=device)
        plan = tr.run([RescalePlan(k=1, steps=3), RescalePlan(k=0, steps=5),
                       RescalePlan(k=1, steps=3)], checkpoint_every=2, fault_at=4)
        launches = dict(fa.launches)
        tr2 = ElasticTrainer(cfg, data, OptimizerConfig(total_steps=60),
                             os.path.join(tmp, "el"), device=device)
        resumed = tr2.run([RescalePlan(k=1, steps=2)])
        comp = launch_train.main(["--arch", ELASTIC_ARCH, "--reduced", "--steps", "4",
                                  "--compress", "--device", device, "--ckpt",
                                  os.path.join(tmp, "comp")])
    L, n = cfg.num_layers, len(plan["losses"])
    want = dict.fromkeys(fa.launches, 0)
    if device == "cuda":      # the tiled forward and backward, no stats pass
        want.update(gqa_flash=2 * L * n, fp32=2 * L * n, gqa_flash_bwd=L * n,
                    **{k: L * n for k in fa.BWD_TILED_KERNELS})
    ok = (plan["final_step"] == 6 and plan["recoveries"] >= 1
          and resumed["final_step"] == 8 and tr2.recoveries >= 1
          and all(math.isfinite(x) for x in plan["losses"] + resumed["losses"]
                  + comp["losses"]) and launches == want)
    log(f"elastic: plan k 1, 0, 1 with a fault at step 4: {plan}; flash launches "
        f"{launches}; resumed: {resumed}; --compress losses {comp['losses']}")
    if not ok:
        raise AssertionError(f"elastic: plan {plan}, resumed {resumed}, launches {launches} "
                             f"(expected {want})")
    return dict(cli=lines, cli_s=cli_s, plan=plan, launches=launches, resumed=resumed,
                compress_losses=comp["losses"])


# --- the sharding layer on two ranks sharing the card ------------------------

# The smoke run has one card: the multi-rank paths run as two spawned ranks
# on it over gloo (NCCL refuses two ranks on one device), each mesh (1, 2)
# unless said otherwise.
SHARD_WORLD = 2
# The ranks are spawned once the kernels are built and wait, with no CUDA
# context, until the phase lets them go: their start-up (Python imports,
# the first call of torch.utils.checkpoint) overlaps the earlier phases.
# SHARD_TIMEOUT bounds the phase from then on, SHARD_WAIT a rank's wait.
SHARD_TIMEOUT = 420
SHARD_WAIT = 1200
# (a) the expert-parallel MoE layer's output (each rank's partial combine in
# bf16, summed in fp32 and rounded once) against the global dispatch on the
# whole layer (one bf16 combine): relative L2, the gate the serving path's
# MoE output has against fp32 (MOE_REL).
SHARD_MOE_REL = 1e-2
# (b) the sequence-sharded decode attention against the one-device one, and
# the cache lengths of its steps (the split at 1056 crossed).
SHARD_DECODE_REL = 1e-3
SHARD_DECODE_LENGTHS = (1054, 1055, 1056, 1057, 2111)
# (c) each tensor-parallel layer on the one-rank path's own input against
# that path's output of the layer, relative L2; depth cut to 2 layers.
SHARD_LAYER_REL = 1e-3
SHARD_PREFILL_LAYERS = 2
# (d) the elastic trainer's losses on the card against the same plan on two
# CPU ranks (fp32, the kernels against the plain versions), relative: the
# reading 1.5e-7 on an H100 (PERF.md), gated at ~67 times it.  And against one
# unbroken one-rank run on the card from the same state, which has no
# rollback, no rescale and no split batch: the CPU test of the same pair
# holds it at 1e-6; gated at 1e-5.
SHARD_ELASTIC_RTOL = 1e-5
SHARD_ONE_RTOL = 1e-5
SHARD_PLAN = ((1, 2), (2, 2), (1, 2))
SHARD_RESUME = ((2, 2),)
# (f) rwkv6-7b and zamba2-7b on their own tensor-parallel layers at full
# width, depth cut to 2 and 6 layers (zamba2's: one group and its shared-block
# application), on prompts of 4 x 512: gloo carries each fp32 psum through
# the host at ~0.15 GB/s, and 4 x 2048 would take ~0.9 s a psum.  Each layer
# is held as (c)'s, at SHARD_LAYER_REL on its finite entries, its non-finite
# ones (the reference recurrence's fp32 overflow) at the same positions as
# the one-rank layer's.  Then the replay of a 4 x 16 prompt and 8 greedy
# decode steps on the one-rank path, and each of its 24 steps again, block by
# block, as tensor-parallel blocks on the one-rank blocks' own inputs and on
# that path's cache, sharded: each block and each cache block it writes
# within SHARD_SSM_DECODE_REL (one token a row: two bf16 roundings of one
# value differ by ~1.6e-3 relative L2 where they fall independently, u /
# sqrt(12) * sqrt(2) with u = 2^-8; the forward's layers round most values
# alike); the vocabulary-parallel head on the one-rank's last
# hidden state within SHARD_SSM_STEP_REL, its greedy token equal wherever the
# one-rank's top two logits lie further apart than twice the largest logit
# difference on that row (closer ones, near ties, counted and printed).  Then
# the chained run on the sharded caches through the entry points
# (``make_prefill``, ``make_serve_step``), fed the one-rank path's tokens,
# held at SHARD_SSM_LOGITS_REL only: under the reference init one token's
# pass through zamba2's Mamba layers amplifies a difference layer by layer
# (``scripts/shard_decode_drift.py``: 1.1e-5 after the first layer, 0.103
# after the sixth, in bf16 on CPU ranks), so its chained logits sat 0.085
# from the one-rank path's after the replay and 0.22 over the steps, and a
# token that flips at a near tie sends two greedy runs down different texts
# (rwkv6's, in an earlier form of this check).
SHARD_SSM = (("rwkv6-7b", 2), ("zamba2-7b", 6))
SHARD_SSM_PROMPT = 512
SHARD_SSM_REPLAY, SHARD_SSM_DECODE = 16, 8
# The first readings (chip run 7, NVIDIA H100 80GB HBM3, 700.00 W): decode
# blocks and written cache up to 1.67e-3 (zamba2's shared block; rwkv6's
# layers 1.40e-3), the head 0.0 (bit for bit), the chained logits 6.8e-3
# (rwkv6) and 0.223 (zamba2).
SHARD_SSM_DECODE_REL = 3e-3
SHARD_SSM_STEP_REL = 1e-3
SHARD_SSM_LOGITS_REL = 0.5


def start_shard_ranks():
    """Spawn the shard phase's ranks (``shard_rank``); they warm up and wait
    for ``shard_phase``.  Returns the handle that ``shard_phase`` and
    ``stop_shard_ranks`` take."""
    import tempfile

    import torch.multiprocessing as mp

    root = tempfile.mkdtemp(prefix="shard_phase_")
    ctx = mp.start_processes(shard_rank, args=("file://" + os.path.join(root, "rendezvous"),
                                               root, os.getpid()),
                             nprocs=SHARD_WORLD, join=False, start_method="spawn")
    return dict(ctx=ctx, root=root)


def stop_shard_ranks(ranks):
    """Stop every rank still alive and remove the ranks' directory."""
    import shutil

    for proc in ranks["ctx"].processes:
        if proc.is_alive():
            proc.kill()
        proc.join()
    shutil.rmtree(ranks["root"], ignore_errors=True)


def shard_rules(shape=(1, SHARD_WORLD)):
    from repro_torch.launch.mesh import DistMesh, make_mesh
    from repro_torch.models.common import LogicalRules

    return LogicalRules(DistMesh(make_mesh(shape, ("data", "model"))))


def kept_keys(r, e0, experts, cap):
    """A routing's kept pairs as sorted keys (token, expert, slot in the
    expert), for experts [e0, e0 + experts); ``r``'s expert ids are global."""
    ex = r.eidx.reshape(-1)[r.order][r.keep]
    tok = r.src_tok[r.keep]
    pos = r.slot[r.keep] % cap
    mine = (ex >= e0) & (ex < e0 + experts)
    key = (tok[mine] * (e0 + experts + 1) + ex[mine]) * cap + pos[mine]
    return key.sort().values


def shard_moe(rank):
    """(a) One qwen3-moe-235b-a22b MoE layer at full width, seed-0 weights,
    each rank holding its 64 experts: ``moe_block_local`` at 4 x 2048 tokens
    (C = 640) and at the decode's 4 (C = 1); each rank's kept pairs against
    the global dispatch's for its experts, and the combined output against
    ``moe_block_global`` on the whole layer (rank 0)."""
    cfg = dataclasses.replace(ARCHS[MOE_ARCH], num_layers=1)
    rules = shard_rules()
    params = init_params(cfg, seed=0, device="cuda")
    full = {k: params["layers"][k] for k in ("router", "w_gate", "w_up", "w_down")}
    del params
    local = _layer_blocks(cfg, rules, full)
    e_loc = cfg.num_experts // rules.tp
    e0 = rules.coords["model"] * e_loc
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    out = {}
    for name, shape in (("prefill", (SERVE_BATCH, SERVE_PROMPT, cfg.d_model)),
                        ("decode", (SERVE_BATCH, 1, cfg.d_model))):
        x = torch.randn(shape, generator=gen, device="cuda").to(cfg.compute_dtype)
        routing = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        y = transformer.moe_block_local(x, local, 0, cfg, rules, routing=routing)
        torch.cuda.synchronize()
        local_s = time.perf_counter() - t
        r = routing[0]
        t_all = x.shape[0] * x.shape[1]
        cap = transformer.local_capacity(cfg, t_all)
        xt = x.reshape(t_all, -1)
        probs = torch.softmax((xt @ full["router"][0].to(x.dtype)).float(), dim=-1)
        g = transformer.moe_route(probs, cfg.experts_per_token, transformer.capacity(cfg, t_all))
        same = torch.equal(kept_keys(r, e0, e_loc, cap), kept_keys(g, e0, e_loc, cap))
        row = dict(capacity=cap, local_s=local_s, kept=int(r.keep.sum()),
                   pairs_equal=same)
        if not same or cap != transformer.capacity(cfg, t_all):
            raise AssertionError(f"shard moe {name}, rank {rank}: kept pairs differ from the "
                                 f"global dispatch's for experts {e0}..{e0 + e_loc - 1} "
                                 f"(capacity {cap})")
        if rank == 0:
            torch.cuda.synchronize()
            t = time.perf_counter()
            want = transformer.moe_block_global(x, full, 0, cfg)
            torch.cuda.synchronize()
            row.update(global_s=time.perf_counter() - t, rel_l2=rel_l2(y, want),
                       dropped=int((~g.keep).sum()))
            if not row["rel_l2"] <= SHARD_MOE_REL:
                raise AssertionError(f"shard moe {name}: relative L2 {row['rel_l2']} against "
                                     f"the global dispatch (limit {SHARD_MOE_REL})")
        out[name] = row
        del x, y, routing, r, g, probs
    del full, local
    torch.cuda.empty_cache()
    return out


def _layer_blocks(cfg, rules, full):
    """This rank's blocks of a layer's stacked leaves (as ``param_shardings``
    places them)."""
    from repro_torch.models.api import param_shardings

    sh = param_shardings(cfg, rules)["layers"]
    return {k: sh[k].local(v) for k, v in full.items()}


def shard_decode(rank):
    """(b) ``sharded_decode_attention`` at llama3-8b's decode shape: B 4, a
    cache of 2048 + 64 positions split 1056 / 1056 over the two ranks, 32
    query heads of 128 over 8 KV heads, bf16; steps at lengths across the
    split.  Each step's new K/V must land in one rank's slice alone, and the
    output match the one-device ``decode_attention`` on the whole cache."""
    from repro_torch import distributed as D
    from repro_torch.serve.decode import decode_attention, sharded_decode_attention

    cfg = ARCHS[SERVE_ARCH]
    rules = shard_rules()
    b, s = SERVE_BATCH, SERVE_PROMPT + SERVE_TOKENS
    kvh, hd, hq = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_heads
    s_loc = s // rules.tp
    off = rules.coords["model"] * s_loc
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(cfg.compute_dtype)

    kf, vf = draw(b, s, kvh, hd), draw(b, s, kvh, hd)
    kc, vc = kf[:, off:off + s_loc].clone(), vf[:, off:off + s_loc].clone()
    steps = []
    for length in SHARD_DECODE_LENGTHS:
        q, kn, vn = draw(b, 1, hq, hd), draw(b, 1, kvh, hd), draw(b, 1, kvh, hd)
        before = kc.clone()
        torch.cuda.synchronize()
        t = time.perf_counter()
        o = sharded_decode_attention(q, kc, vc, kn, vn, length, rules, True)
        torch.cuda.synchronize()
        sharded_s = time.perf_counter() - t
        rows = (kc != before).flatten(2).any(dim=-1).any(dim=0).nonzero().flatten().tolist()
        mine = [off + i for i in rows]
        owners = int(D.all_reduce(torch.tensor(len(mine), device="cuda"), rules, "model"))
        if owners != 1 or (mine and mine != [length]):
            raise AssertionError(f"shard decode at length {length}: rank {rank} wrote "
                                 f"positions {mine}; {owners} ranks wrote")
        row = dict(length=length, wrote=mine, sharded_s=sharded_s)
        if rank == 0:
            t = time.perf_counter()
            want = decode_attention(q, kf, vf, kn, vn, length)
            torch.cuda.synchronize()
            row.update(plain_s=time.perf_counter() - t, rel_l2=rel_l2(o, want))
            if not row["rel_l2"] <= SHARD_DECODE_REL:
                raise AssertionError(f"shard decode at length {length}: relative L2 "
                                     f"{row['rel_l2']} (limit {SHARD_DECODE_REL})")
        steps.append(row)
    del kf, vf, kc, vc
    return dict(shape=[b, s, hq, kvh, hd], split=[s_loc] * rules.tp, steps=steps)


def shard_prefill(rank):
    """(c) The tensor-parallel prefill of llama3-8b at full width on
    (1, 2), depth cut to 2 layers: ``make_prefill`` with the rank's blocks,
    ``gqa_flash`` launches counted by route (2, all ``wgmma``, each on the
    rank's 16 query heads and the 4 KV heads they read); then each layer on
    the one-rank
    path's own input against that path's output of the layer; the chained
    last-position logits printed only."""
    from repro_torch.models.api import shard_params

    cfg = dataclasses.replace(ARCHS[SERVE_ARCH], num_layers=SHARD_PREFILL_LAYERS)
    rules = shard_rules()
    params = init_params(cfg, seed=0, device="cuda")
    local = shard_params(params, cfg, rules)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT))).to("cuda")
    heads, first, kernel = [], [], fa.gqa_flash

    def counted_flash(q, k, v, causal_offset=0):
        heads.append((q.shape[2], k.shape[2]))
        if not first:
            first.append((q.clone(), k.clone(), v.clone(), causal_offset))
        return kernel(q, k, v, causal_offset=causal_offset)

    fa.gqa_flash = counted_flash
    fa.reset_launches()
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.no_grad():
            last, cache = make_prefill(cfg, SERVE_PROMPT + SERVE_TOKENS, rules)(local, prompts)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        launches = dict(fa.launches)
    finally:
        fa.gqa_flash = kernel
    want = dict.fromkeys(fa.launches, 0)
    want.update(gqa_flash=cfg.num_layers, wgmma=cfg.num_layers)
    local_heads = cfg.num_heads // rules.tp
    if launches != want or heads != [(local_heads, cfg.num_kv_heads // rules.tp)] * cfg.num_layers:
        raise AssertionError(f"shard prefill, rank {rank}: flash launches {launches} on heads "
                             f"{heads}; expected {want} on {local_heads} query heads")
    cache_shape = list(cache["k"].shape)
    del cache
    # the kernel on the rank's local heads against its plain version
    q, k, v, offset = first.pop()
    flash_err, flash_rel = flash_check(q, k, v, offset, f"shard prefill, rank {rank}: "
                                       "gqa_flash on the local heads")
    del q, k, v
    lp, llp = params["layers"], local["layers"]
    pos = torch.arange(SERVE_PROMPT, device="cuda")
    rels = []
    with torch.no_grad():
        x = transformer.embed(params, prompts, cfg)
        for li in range(cfg.num_layers):
            y, _ = transformer.decoder_layer(x, lp, li, cfg, pos)
            got, _ = transformer.decoder_layer(x, llp, li, cfg, pos, rules)
            rels.append(rel_l2(got, y))
            x = y
        one = rms_norm(x[:, -1], params["ln_f"], cfg.norm_eps) @ params["lm_head"].to(x.dtype)
    chained = rel_l2(last, one)
    if not max(rels) <= SHARD_LAYER_REL or last.shape != one.shape:
        raise AssertionError(f"shard prefill, rank {rank}: layers' relative L2 {rels} "
                             f"(limit {SHARD_LAYER_REL})")
    del params, local, x, y, got
    torch.cuda.empty_cache()
    return dict(layers=cfg.num_layers, prefill_s=prefill_s, launches=launches, heads=heads,
                flash_max_abs_err=flash_err, flash_rel_l2=flash_rel, cache_shape=cache_shape, layer_rel_l2=rels, chained_logits_rel_l2=chained,
                finite=bool(torch.isfinite(last).all()))


def ssm_blocks(cfg, params, positions, rules=None):
    """The family's blocks in order as (name, fn(x) -> x) on ``params`` (a
    rank's blocks under ``rules``, else the whole leaves): rwkv6's layers;
    zamba2's Mamba layers and its shared-block applications."""
    from repro_torch.models import rwkv6, zamba2
    from repro_torch.models.common import layer

    if cfg.family == "ssm":
        return [(f"layer {li}", lambda x, lp=layer(params["layers"], li):
                 rwkv6._layer(x, lp, cfg, rules)) for li in range(cfg.num_layers)]
    p = cfg.shared_attn_every
    out = []
    for li in range(cfg.num_layers):
        out.append((f"mamba {li}", lambda x, lp=layer(params["layers"], li):
                    x + zamba2._mamba_sublayer(x, lp, cfg, rules)))
        if (li + 1) % p == 0:
            out.append((f"shared after {li}", lambda x: zamba2.shared_block(
                x, params["shared"], cfg, positions, rules)))
    return out


def ssm_serve(cfg, params, prompts, rules=None, feed=None):
    """The replay prefill of ``prompts`` and SHARD_SSM_DECODE decode steps
    through the entry points, each fed the last step's greedy token or, with
    ``feed``, that step's token of ``feed``: (every output's logits over the
    whole vocabulary, the greedy tokens)."""
    from repro_torch.serve import make_serve_step

    p = prompts.shape[1]
    with torch.no_grad():
        logits, cache = make_prefill(cfg, p + SHARD_SSM_DECODE, rules)(params, prompts)
        step = make_serve_step(cfg, rules)
        outs, toks = [logits], [logits.argmax(-1)]
        for i in range(SHARD_SSM_DECODE):
            logits, cache = step(params, cache, toks[-1] if feed is None else feed[i])
            outs.append(logits)
            toks.append(logits.argmax(-1))
    return torch.stack(outs), torch.stack(toks)


def ssm_steps(cfg, params, prompts):
    """The one-rank replay of ``prompts`` and SHARD_SSM_DECODE greedy steps
    (the loop ``make_prefill`` runs, then ``make_serve_step``'s): each
    step's (cache before it, its token, its logits)."""
    from repro_torch.serve import make_serve_step
    from repro_torch.serve.decode import rank_cache

    p = prompts.shape[1]
    step = make_serve_step(cfg)
    out = []
    with torch.no_grad():
        cache = rank_cache(cfg, prompts, p + SHARD_SSM_DECODE)
        tok = prompts[:, 0]
        for i in range(p + SHARD_SSM_DECODE):
            logits, new = step(params, copy_cache(cache), tok)
            out.append((cache, tok, logits))
            cache = new
            tok = prompts[:, i + 1] if i + 1 < p else logits.argmax(-1)
    return out


def copy_cache(cache):
    return {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in cache.items()}


def cache_blocks(cfg, rules, cache):
    """This rank's blocks of a whole decode cache (``cache_shardings``)."""
    from repro_torch.serve.decode import cache_shardings

    b = cache["tok1" if cfg.family == "ssm" else "conv"].shape[1]
    max_seq = cache["k"].shape[2] if "k" in cache else 1
    shard = cache_shardings(cfg, rules, b, max_seq)
    out = {k: shard[k].local(v) if isinstance(v, torch.Tensor) else v for k, v in cache.items()}
    if "k" in cache:
        out["max_seq"] = max_seq
    return out


def decode_blocks(cfg, params, cache, rules=None, attend=None):
    """One decode step's blocks in order as (name, fn(x) -> x) on ``params``
    and ``cache`` (a rank's blocks under ``rules``), each writing its part of
    the cache in place: rwkv6's layers; zamba2's Mamba layers and its
    shared-block applications (``attend`` as ``zamba2.decode_step`` takes
    it)."""
    from repro_torch.models import rwkv6, zamba2
    from repro_torch.models.common import layer

    layers = params["layers"]
    if cfg.family == "ssm":
        return [(f"layer {li}", lambda x, li=li: rwkv6.decode_layer(
            x, layer(layers, li), li, cache, cfg, rules)) for li in range(cfg.num_layers)]
    p = cfg.shared_attn_every
    out = []
    for li in range(cfg.num_layers):
        out.append((f"mamba {li}", lambda x, li=li: zamba2.mamba_decode_layer(
            x, layer(layers, li), li, cache, cfg, rules)))
        if (li + 1) % p == 0:
            out.append((f"shared {li // p}", lambda x, g=li // p: zamba2._shared_decode(
                x, params["shared"], cfg, cache["k"][g], cache["v"][g], cache["length"],
                rules, attend)))
    return out


def block_rel(a, b) -> float:
    """Relative L2 of ``a`` against ``b``; the largest difference where
    ``b`` is all zeros (a cache block no rank has written)."""
    n = torch.linalg.vector_norm(b.float()).item()
    return rel_l2(a, b) if n else (a.float() - b.float()).abs().max().item()


def sharded_steps(cfg, params, local, rules, steps):
    """Each one-rank step of ``steps`` again, block by block, as the rank's
    tensor-parallel blocks on the one-rank blocks' inputs and on the rank's
    blocks of that step's cache: each block's and each written cache leaf's
    largest relative L2 over the steps, and the vocabulary-parallel head's
    logits on the one-rank's last hidden state, step by step."""
    from repro_torch import distributed as D
    from repro_torch.serve.decode import seq_split, sharded_decode_attention

    blocks, written, logits = {}, {}, []
    with torch.no_grad():
        for cache, tok, _ in steps:
            whole, mine = copy_cache(cache), cache_blocks(cfg, rules, cache)
            attend = None
            if seq_split(mine, rules):
                def attend(q, kc, vc, kn, vn, length):
                    return sharded_decode_attention(q, kc, vc, kn, vn, length, rules, True)
            x = transformer.embed(params, tok, cfg)[:, None]
            for (name, one), (_, tp) in zip(decode_blocks(cfg, params, whole),
                                            decode_blocks(cfg, local, mine, rules, attend)):
                y, got = one(x), tp(x)
                blocks[name] = max(blocks.get(name, 0.0), rel_l2(got, y))
                x = y
            for k, v in cache_blocks(cfg, rules, whole).items():
                if isinstance(v, torch.Tensor):
                    written[k] = max(written.get(k, 0.0), block_rel(mine[k], v))
            h = rms_norm(x, params["ln_f"], cfg.norm_eps)
            logits.append(D.all_gather(transformer.lm_logits(h, local, cfg, rules), -1, rules,
                                       "model")[:, 0])
    return blocks, written, torch.stack(logits)


def shard_ssm(rank, cfgs=None, device="cuda"):
    """(f) rwkv6-7b and zamba2-7b at full width on (1, 2), seed-0 bf16
    weights, depth cut (SHARD_SSM): the tensor-parallel forward through
    ``models.forward`` on 4 x 512 prompts (zamba2: ``gqa_flash`` launches
    counted, 1 a rank, ``wgmma``, on its 16 local query heads and the 16 KV
    heads they read; the kernel on those heads against its plain version);
    each block on the one-rank path's own input against that path's output
    of the block; the replay prefill and decode on the sharded caches
    against the one-rank path; on rank 0 the local-heads kernel timed
    against SDPA (the other rank waiting).  ``cfgs`` and ``device``: other
    configs, and the CPU, for a rehearsal (the plain versions, nothing
    timed)."""
    import torch.distributed as dist

    from repro_torch.models.api import shard_params

    rules = shard_rules()
    out = {}
    for cfg in cfgs or [dataclasses.replace(ARCHS[a], num_layers=n) for a, n in SHARD_SSM]:
        arch, layers = cfg.name, cfg.num_layers
        params = init_params(cfg, seed=0, device=device)
        local = shard_params(params, cfg, rules)
        prompts = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab_size, (SERVE_BATCH, SHARD_SSM_PROMPT))).to(device)
        heads, first, kernel = [], [], fa.gqa_flash

        def counted_flash(q, k, v, causal_offset=0):
            heads.append((q.shape[2], k.shape[2]))
            if not first:
                first.append((q.clone(), k.clone(), v.clone(), causal_offset))
            return kernel(q, k, v, causal_offset=causal_offset)

        fa.gqa_flash = counted_flash
        fa.reset_launches()
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            with torch.no_grad():
                logits = model_forward(local, prompts, cfg, rules=rules)
            torch.cuda.synchronize()
            forward_s = time.perf_counter() - t
            launches = dict(fa.launches)
        finally:
            fa.gqa_flash = kernel
        groups = layers // cfg.shared_attn_every if cfg.family == "hybrid" else 0
        want = dict.fromkeys(fa.launches, 0)
        if device == "cuda":
            want.update(gqa_flash=groups, wgmma=groups)
        local_heads = cfg.num_heads // rules.tp
        if launches != want or heads != [(local_heads, local_heads)] * groups \
                or tuple(logits.shape) != (SERVE_BATCH, SHARD_SSM_PROMPT,
                                           cfg.vocab_size // rules.tp):
            raise AssertionError(f"shard ssm {arch}, rank {rank}: flash launches {launches} on "
                                 f"heads {heads}, logits {tuple(logits.shape)}; expected "
                                 f"{want} on {local_heads} query and KV heads")
        row = dict(layers=layers, forward_s=forward_s, launches=launches, heads=heads,
                   logits_nonfinite=int((~torch.isfinite(logits)).sum()))
        del logits
        if first:
            q, k, v, offset = first.pop()
            row["flash_max_abs_err"], row["flash_rel_l2"] = flash_check(
                q, k, v, offset, f"shard ssm {arch}, rank {rank}: gqa_flash on the local heads")
            dist.barrier()              # the other rank waits while rank 0 times
            if rank == 0 and device == "cuda":
                row["flash_timing"] = local_heads_timing(q, k, v)
            dist.barrier()
            del q, k, v
        # each block on the one-rank path's own input
        positions = torch.arange(SHARD_SSM_PROMPT, device=device)
        blocks = []
        with torch.no_grad():
            x = transformer.embed(params, prompts, cfg)
            for (name, one), (_, tp) in zip(ssm_blocks(cfg, params, positions),
                                            ssm_blocks(cfg, local, positions, rules)):
                y, got = one(x), tp(x)
                fin = torch.isfinite(y)
                same = torch.equal(fin, torch.isfinite(got))
                rel = rel_l2(got[fin], y[fin]) if same and fin.any() else math.inf
                blocks.append(dict(block=name, nonfinite=int((~fin).sum()),
                                   same_nonfinite=same, rel_l2=rel))
                x = y
        del x, y, got
        if not all(b["same_nonfinite"] and b["rel_l2"] <= SHARD_LAYER_REL for b in blocks):
            raise AssertionError(f"shard ssm {arch}, rank {rank}: blocks against the one-rank "
                                 f"path {blocks} (limit {SHARD_LAYER_REL} on finite entries)")
        # each replay and decode step, block by block, on the one-rank
        # path's own inputs and cache
        short = prompts[:, :SHARD_SSM_REPLAY]
        steps = ssm_steps(cfg, params, short)
        t = time.perf_counter()
        step_blocks, written, got = sharded_steps(cfg, params, local, rules, steps)
        torch.cuda.synchronize()
        steps_s = time.perf_counter() - t
        want = torch.stack([lg for _, _, lg in steps])
        del steps
        diff = (got.float() - want.float()).abs().amax(-1)
        top2 = want.float().topk(2, dim=-1).values
        clear = top2[..., 0] - top2[..., 1] > 2 * diff
        differ = got.argmax(-1) != want.argmax(-1)
        # the chained run on the sharded caches, fed the one-rank's tokens
        want_logits, want_tokens = ssm_serve(cfg, params, short)
        t = time.perf_counter()
        got_logits, _ = ssm_serve(cfg, local, short, rules, feed=want_tokens[:-1])
        torch.cuda.synchronize()
        decode = dict(steps=len(want), steps_s=steps_s, block_rel_l2=step_blocks,
                      cache_rel_l2=written, logits_rel_l2=rel_l2(got, want),
                      tokens_equal=not bool(differ[clear].any()),
                      tokens_differing=int(differ.sum()), near_ties=int((~clear).sum()),
                      finite=bool(torch.isfinite(got_logits).all()),
                      chained_s=time.perf_counter() - t,
                      chained_rel_l2=rel_l2(got_logits, want_logits),
                      chained_step_rel_l2=[rel_l2(a, b) for a, b in
                                           zip(got_logits, want_logits)])
        if not (decode["tokens_equal"] and decode["finite"]
                and max(list(step_blocks.values()) + list(written.values()))
                <= SHARD_SSM_DECODE_REL
                and decode["logits_rel_l2"] <= SHARD_SSM_STEP_REL
                and decode["chained_rel_l2"] <= SHARD_SSM_LOGITS_REL):
            raise AssertionError(f"shard ssm {arch}, rank {rank}: sharded decode against the "
                                 f"one-rank decode {decode} (limits {SHARD_SSM_DECODE_REL} a "
                                 "block, "
                                 f"{SHARD_SSM_STEP_REL} the head, {SHARD_SSM_LOGITS_REL} "
                                 "chained)")
        row.update(blocks=blocks, decode=decode)
        out[arch] = row
        del params, local, prompts, got_logits, want_logits
        torch.cuda.empty_cache()
    return out


def local_heads_timing(q, k, v):
    """``gqa_flash`` on one rank's heads (zamba2's 16 of 32 at D 112, B 4,
    S 512) against SDPA on the same inputs, in turns by CUDA events, beside
    the bound."""
    b, sq, hq, d = q.shape
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    runs = dict(ms=lambda: fa.launch(q, k, v, 0, "wgmma"),
                library_ms=lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    turns = {key: [] for key in runs}
    for key in list(runs) + list(runs)[::-1]:
        turns[key].append(time_ms(runs[key], 50, warmup=5))
    nbytes, flops = flash_work(b, sq, sq, hq, k.shape[2], d, 0, 2)
    bound, by = bound_ms(nbytes, flops, BF16_FLOP_PER_S)
    return dict(shape=f"B={b} Sq=Sk={sq} Hq={hq} Hkv={k.shape[2]} D={d} bf16 causal",
                turns=turns, ms=float(np.mean(turns["ms"])),
                library_ms=float(np.mean(turns["library_ms"])), bound_ms=bound, bound_by=by)


def shard_elastic(rank, root):
    """(d) ``ElasticTrainer`` in both ranks on reduced stablelm-1.6b (fp32,
    the D-32 flash route): the plan k 1, 2, 1 with a fault at step 4 and a
    checkpoint every 2 steps, then a second trainer resuming at k 2, on the
    card and on the CPU, both from one step-0 checkpoint of the CPU's
    seed-0 state; the steps each rank took counted at the step function,
    flash launches against them, losses against the CPU's and (rank 0)
    against one unbroken run of the one-device step on the card from the
    same checkpoint."""
    from repro_torch.configs import reduced
    from repro_torch.elastic import ElasticTrainer, RescalePlan
    from repro_torch.elastic import rescale
    from repro_torch.train import DataConfig, OptimizerConfig, SyntheticLM

    cfg = reduced(ARCHS[ELASTIC_ARCH])
    data = SyntheticLM(DataConfig(batch=4, seq_len=32, vocab_size=cfg.vocab_size, seed=3))
    made = rescale.make_train_step
    taken = [0]

    def counting(*args, **kw):
        fn = made(*args, **kw)

        def step(state, batch):
            out = fn(state, batch)
            taken[0] += 1
            return out
        return step

    # both runs start from one checkpoint: the CPU's and the card's
    # generators draw different weights from one seed
    import torch.distributed as dist

    from repro_torch.train import CheckpointManager, init_state, state_template

    if rank == 0:
        start = init_state(cfg, 0, "cpu")
        for device in ("cuda", "cpu", "one"):
            CheckpointManager(os.path.join(root, f"elastic_{device}")).save(
                0, start, blocking=True)
    dist.barrier()
    runs = {}
    rescale.make_train_step = counting
    try:
        for device in ("cuda", "cpu"):
            t = time.perf_counter()
            taken[0] = 0
            fa.reset_launches()
            ckpt = os.path.join(root, f"elastic_{device}")
            kw = dict(device=device)
            tr = ElasticTrainer(cfg, data, OptimizerConfig(total_steps=60), ckpt, **kw)
            plan = tr.run([RescalePlan(k=k, steps=n) for k, n in SHARD_PLAN],
                          checkpoint_every=2, fault_at=4)
            tr2 = ElasticTrainer(cfg, data, OptimizerConfig(total_steps=60), ckpt, **kw)
            resumed = tr2.run([RescalePlan(k=k, steps=n) for k, n in SHARD_RESUME])
            runs[device] = dict(plan=plan, resumed=resumed, taken=taken[0],
                                launches=dict(fa.launches), wall_s=time.perf_counter() - t,
                                step_s=tr.step_times + tr2.step_times)
    finally:
        rescale.make_train_step = made
    card, cpu = runs["cuda"], runs["cpu"]
    L, n = cfg.num_layers, card["taken"]
    want = dict.fromkeys(fa.launches, 0)
    want.update(gqa_flash=2 * L * n, fp32=2 * L * n, gqa_flash_bwd=L * n,
                **{k: L * n for k in fa.BWD_TILED_KERNELS})
    planned = (sum(s for _, s in SHARD_PLAN + SHARD_RESUME) if rank == 0
               else sum(s for k, s in SHARD_PLAN + SHARD_RESUME if k > 1))
    losses = card["plan"]["losses"] + card["resumed"]["losses"]
    cpu_losses = cpu["plan"]["losses"] + cpu["resumed"]["losses"]
    off = max(abs(a / b - 1) for a, b in zip(losses, cpu_losses))
    one_losses, one_off = None, 0.0
    if rank == 0:
        t = time.perf_counter()
        state = CheckpointManager(os.path.join(root, "elastic_one")).restore(
            state_template(cfg), step=0, device="cuda")
        step = made(cfg, OptimizerConfig(total_steps=60), ce_chunk=128)
        one_losses = []
        for i in range(len(losses)):
            state, metrics = step(state, {"tokens": torch.from_numpy(data.batch_at(i)).to("cuda")})
            one_losses.append(float(metrics["loss"]))
        one_off = max(abs(a / b - 1) for a, b in zip(losses, one_losses))
        runs["one"] = dict(wall_s=time.perf_counter() - t)
        del state
    if card["launches"] != want or n != planned or cpu["launches"]["gqa_flash"] \
            or card["plan"]["final_step"] != 6 or card["resumed"]["final_step"] != 8 \
            or card["plan"]["rescales"] != 2 or not all(map(math.isfinite, losses)) \
            or not off <= SHARD_ELASTIC_RTOL or not one_off <= SHARD_ONE_RTOL:
        raise AssertionError(f"shard elastic, rank {rank}: {n} steps taken ({planned} "
                             f"planned), launches {card['launches']} (expected {want}), "
                             f"plan {card['plan']}, resumed {card['resumed']}, losses off the "
                             f"CPU's by {off} (limit {SHARD_ELASTIC_RTOL}), off the unbroken "
                             f"one-rank run's {one_losses} by {one_off} (limit {SHARD_ONE_RTOL})")
    return dict(card=card, cpu_losses=cpu_losses, loss_rel_off=off, one_losses=one_losses,
                one_rel_off=one_off, walls={d: r["wall_s"] for d, r in runs.items()},
                step_s={d: r["step_s"] for d, r in runs.items() if "step_s" in r})


def shard_tiny(rank, root):
    """(g) ``train_carbon_aware --preset tiny --max-dp 2 --fault-at 6`` in
    both ranks on the card (bf16, head dim 16: the wgmma forward and backward
    on the 16-wide tiles, no mma.sync, mma or fma kernel): the plan the host
    computes, its steps and rescales, one
    recovery, finite losses; the steps each rank took counted at the step
    function, and the D-16 route's launches against them."""
    import contextlib
    import io

    from repro_torch.elastic import rescale

    tca = example_module("train_carbon_aware")
    made = rescale.make_train_step
    taken = [0]

    def counting(*args, **kw):
        fn = made(*args, **kw)

        def step(state, batch):
            out = fn(state, batch)
            taken[0] += 1
            return out
        return step

    argv = ["--preset", "tiny", "--max-dp", str(SHARD_WORLD), "--fault-at",
            str(EXAMPLE_TINY_FAULT), "--device", "cuda", "--ckpt", os.path.join(root, "tiny")]
    text = io.StringIO()
    fa.reset_launches()
    rescale.make_train_step = counting
    try:
        with contextlib.redirect_stdout(text):
            res = tca.main(argv)
        torch.cuda.synchronize()
    finally:
        rescale.make_train_step = made
    launches = dict(fa.launches)
    ks, steps, rescales = example_plan(argv)
    cfg = tca.PRESETS["tiny"]
    want = train_launch_counts(cfg.compute_dtype, cfg.resolved_head_dim, cfg.num_layers,
                               taken[0])
    # rank 0 takes every step, a failed one re-taken after the rollback
    own = len(res["losses"]) if rank == 0 else None
    if not (res["plan"] == ks and res["final_step"] == steps and res["rescales"] == rescales
            and res["recoveries"] == 1 and len(res["losses"]) == steps + 1
            and all(map(math.isfinite, res["losses"])) and launches == want
            and launches["wgmma"] > 0 and launches["bwd_wgmma_dq"] > 0
            and launches["mma_sync"] == 0 and launches["bwd_mma_dq"] == 0
            and (own is None or taken[0] == own)
            and 0 < taken[0] <= len(res["losses"])):
        raise AssertionError(f"shard tiny, rank {rank}: plan {res['plan']} (host {ks}), "
                             f"{res['final_step']} steps ({steps}), {res['rescales']} rescales "
                             f"({rescales}), {res['recoveries']} recoveries, {taken[0]} taken, "
                             f"losses {res['losses']}, launches {launches} (expected {want})")
    return dict(text=text.getvalue(), plan=res["plan"], final_step=res["final_step"],
                rescales=res["rescales"], recoveries=res["recoveries"], losses=res["losses"],
                taken=taken[0], launches=launches)


def shard_rank(rank, init, root, parent):
    """One of the two ranks of ``shard_phase``: warm up on the host, wait
    for the phase's ``go`` file in ``root`` (or return if the parent
    process ``parent`` is gone), then (a)-(c), (f) and (d), each rank's
    record written to ``root``."""
    import torch.distributed as dist

    torch.set_num_threads(max(1, (os.cpu_count() or SHARD_WORLD) // SHARD_WORLD))
    warm_s = warm_checkpoint()
    go, deadline = os.path.join(root, "go"), time.perf_counter() + SHARD_WAIT
    while not os.path.exists(go):
        if os.getppid() != parent or time.perf_counter() > deadline:
            return
        time.sleep(0.05)
    t = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=SHARD_WORLD)
    try:
        res = dict(rank=rank, warm_s=warm_s, startup_s=time.perf_counter() - t)
        for name, fn in (("moe", shard_moe), ("decode", shard_decode),
                         ("prefill", shard_prefill), ("ssm", shard_ssm)):
            t = time.perf_counter()
            res[name] = fn(rank)
            res[name]["wall_s"] = time.perf_counter() - t
        for name, fn in (("elastic", shard_elastic), ("tiny", shard_tiny)):
            t = time.perf_counter()
            res[name] = fn(rank, root)
            res[name]["wall_s"] = time.perf_counter() - t
        with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
            json.dump(res, f, default=str)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def shard_phase(handle):
    """The sharding layer on two ranks sharing the card over gloo, started
    once (``start_shard_ranks``): (a) the expert-parallel MoE layer, (b) the
    sequence-sharded decode attention, (c) the tensor-parallel prefill, (f)
    rwkv6's and zamba2's tensor-parallel layers and decode, (d) the elastic
    trainer at k 1, 2, 1 (``shard_rank``).  The ranks are joined
    within SHARD_TIMEOUT: a rank that raises on a failed gate, or hangs,
    fails the phase."""
    torch.cuda.empty_cache()
    ctx, root = handle["ctx"], handle["root"]
    t = time.perf_counter()
    open(os.path.join(root, "go"), "w").close()
    deadline = t + SHARD_TIMEOUT
    while not ctx.join(timeout=max(deadline - time.perf_counter(), 0.1)):
        if time.perf_counter() > deadline:
            raise AssertionError(f"{SHARD_WORLD} ranks did not finish within "
                                 f"{SHARD_TIMEOUT} s")
    ranks = []
    for r in range(SHARD_WORLD):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    wall = time.perf_counter() - t
    r0 = ranks[0]
    log(f"shard (a) moe, experts over 2 ranks: {[{k: r[k] for k in ('moe',)} for r in ranks]}")
    log(f"shard (b) decode: {[r['decode'] for r in ranks]}")
    log(f"shard (c) tensor-parallel prefill: {[r['prefill'] for r in ranks]}")
    log(f"shard (f) rwkv6 / zamba2 tensor-parallel: {[r['ssm'] for r in ranks]}")
    keys = ("loss_rel_off", "one_rel_off", "walls")
    log(f"shard (d) elastic: {[{k: r['elastic'][k] for k in keys} for r in ranks]}"
        f"; rank 0 {r0['elastic']['card']}")
    log(f"shard (g) train_carbon_aware --preset tiny --max-dp {SHARD_WORLD} --fault-at "
        f"{EXAMPLE_TINY_FAULT}: {r0['tiny']['text'].strip()}; steps taken "
        f"{[r['tiny']['taken'] for r in ranks]}, launches {[r['tiny']['launches'] for r in ranks]}"
        f", walls {[round(r['tiny']['wall_s'], 3) for r in ranks]} s")
    log(f"shard phase: {wall:.3f} s wall (two ranks spawned once; warmed up before it in "
        f"{[round(r['warm_s'], 3) for r in ranks]} s, then started in "
        f"{[round(r['startup_s'], 3) for r in ranks]} s)")
    return dict(wall_s=wall, warm_s=[r["warm_s"] for r in ranks],
                startup_s=[r["startup_s"] for r in ranks],
                moe=[r["moe"] for r in ranks],
                decode=[r["decode"] for r in ranks], prefill=[r["prefill"] for r in ranks],
                ssm=[r["ssm"] for r in ranks], elastic=[r["elastic"] for r in ranks],
                tiny=[r["tiny"] for r in ranks])


# --- DAG gating and the device slot loop -------------------------------------

# The paper's default 150-server cluster, one evaluation week of DAG jobs.
DAG = dict(capacity=150, learn_weeks=1, seed=7)
TILE_REGIONS = tuple(REGIONS)[:8]
TILE_SEEDS = range(8)


def dag_week():
    mat = Scenario(dag=DagConfig(), **DAG).materialize()
    return mat, mat.eval_week(0)


def tile_cases(engine, device, **kw):
    """One full tile: 64 dag-carbon cells on the DAG path's week, 8 regions
    x 8 CI seeds."""
    mat, ev = dag_week()
    cis = [CarbonService.synthetic(r, mat.scenario.hours + CI_MARGIN_HOURS, seed=s)
           for r in TILE_REGIONS for s in TILE_SEEDS]
    return [SimCase(jobs=ev, ci=ci, cluster=mat.cluster, policy=DagCarbonPolicy(),
                    t0=mat.t0, horizon=WEEK, engine=engine, device=device, **kw)
            for ci in cis]


def tile_cpu():
    """The tile on the CPU's vector engine (a CPU twin): its results and wall."""
    cases = tile_cases("vector", "cpu")
    t = time.perf_counter()
    res = simulate_many(cases)
    return dict(results=res, wall_s=time.perf_counter() - t)


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


def dag_path_phase(twins=None):
    """Phase 5: the DAG path through ``run(..., engine="scan")`` on the
    card, its CPU vector twin, the independent twin, and one full tile."""
    gating.reset_launches()
    scan_engine.reset_stats()
    t = time.perf_counter()
    res = run(Scenario(dag=DagConfig(), engine="scan", **DAG), DEFAULT_DAG_POLICIES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    RECORDER_OFF["dag"] = res
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
    # seeds, one batched program on the card; its CPU run is a twin's.
    cases = tile_cases("scan", "cuda")
    gating.reset_launches()
    scan_engine.reset_stats()
    t = time.perf_counter()
    tile = simulate_many(cases)
    torch.cuda.synchronize()
    tile_wall = time.perf_counter() - t
    tile_launches, tile_stats = gating.launches["dep_release"], dict(scan_engine.stats)
    tile_decrements = gating.launches["dep_decrement"]
    cpu_tile = twin_result(twins, "tile")
    tile_cpu_wall = cpu_tile["wall_s"]
    tw, ts = same_results({"c": tile}, {"c": cpu_tile["results"]}, ["c"])
    log(f"tile: {len(cases)} dag-carbon cells in {tile_stats['steps']} batched slot steps, "
        f"{tile_wall:.3f} s wall ({len(cases) / tile_wall:.3f} cells/s, "
        f"{tile_stats['cell_steps'] / tile_wall:.3f} cell slot steps/s; chunk loops "
        f"{tile_stats['loop_s']:.3f} s = {1e3 * tile_stats['loop_s'] / tile_stats['steps']:.6f}"
        f" ms per batched step, host accounting {tile_stats['account_s']:.3f} s); release "
        f"launches {tile_launches}; CPU vector engine {tile_cpu_wall:.3f} s (a CPU twin, "
        f"beside the earlier phases): {tw} cells and {ts} slots differ")
    if (tw or ts or tile_launches != tile_stats["dag_steps"] or tile_decrements
            or tile_stats["cell_steps"] != len(cases) * tile_stats["steps"]):
        raise AssertionError(f"tile: {tw} cells / {ts} slots differ, {tile_launches} "
                             f"launches for {tile_stats}")

    # One traced chunk of the tile: the horizon's 168 slots and no overrun.
    from torch.profiler import ProfilerActivity, profile

    scan_engine.reset_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        simulate_many(tile_cases("scan", "cuda", max_overrun=0))
        torch.cuda.synchronize()
    chunk_s = scan_engine.stats["loop_s"]
    events = device_events(prof)
    busy_ms = busy_us(events) / 1e3
    kernels_ms = busy_us([e for e in events if not e.name.startswith("Memcpy")]) / 1e3
    per_name = {}
    for e in events:
        per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    log(f"traced chunk ({scan_engine.stats['steps']} batched steps of {len(cases)} cells): "
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
                tile_cells=len(cases), tile_wall_s=tile_wall, tile_stats=tile_stats,
                tile_launches=tile_launches, tile_cpu_wall_s=tile_cpu_wall,
                tile_cells_per_s=len(cases) / tile_wall,
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

# --- sweeps, forecast models and receding-horizon execution ----------------------

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data")
GOLDEN_BASE = dict(capacity=8, learn_weeks=1, family="alibaba", seed=101)
SWEEP_POLICIES = ["carbon-agnostic", "wait-awhile", "carbonflex", "carbonflex-mpc",
                  "carbonflex-scale", "oracle-estimated"]
# sweep-full's seeds: one (seeds 1 and 2 until the training phase needed the
# room; the second seed repeated all 60 cells, ~40 s of card and host time).
SWEEP_SEEDS = [1]


def golden_sweeps(device, engine, backend):
    """``tests/test_golden_sweep.py``'s four batch grids: (fixture, Sweep)."""
    def base(**kw):
        return Scenario(**GOLDEN_BASE, engine=engine, **kw)

    common = dict(device=device, backend=backend)
    return [
        ("golden_sweep", Sweep(base=base(), regions=["california", "ontario"],
                               seeds=[11, 12],
                               policies=["carbon-agnostic", "gaia", "wait-awhile"],
                               **common)),
        ("golden_sweep_dag", Sweep(base=base(dag=DagConfig(width=3, depth=3)),
                                   seeds=[11, 12],
                                   policies=["dag-fcfs", "dag-carbon", "dag-cap"],
                                   **common)),
        ("golden_sweep_forecast", Sweep(
            base=base(), seeds=[11],
            policies=["carbon-agnostic", "wait-awhile", "wait-awhile-robust"],
            forecasts=[None, NoisyForecast(sigma=0.3, seed=5),
                       QuantileForecast(sigma=0.2, seed=5, members=7)], **common)),
        ("golden_sweep_mpc", Sweep(base=base(mpc=MPCConfig(scale_rho=0.3)),
                                   seeds=[11, 12],
                                   policies=["carbon-agnostic", "carbonflex-mpc",
                                             "carbonflex-scale", "oracle-estimated"],
                                   **common)),
    ]


def reset_counts():
    for mod in (knn, gating, fill, geo_walk, oracle_greedy):
        mod.reset_launches()
    scan_engine.reset_stats()
    oracle_mod.reset_stats()


def sweep_full(device, engine, backend, record=None):
    """``sweep-full``: the paper's 150-server cluster in all ten regions x
    ``SWEEP_SEEDS``, the six policies; returns the result, the wall time
    split into learning (``prepare_context``: each scenario's knowledge base)
    and execution (the one ``simulate_many`` dispatch), and per tile of the
    slot loop its kind, cells, steps and seconds."""
    sw = Sweep(base=Scenario(capacity=150, learn_weeks=3, eval_weeks=1, seed=1,
                             engine=engine, mpc=MPCConfig(scale_rho=0.3)),
               regions=list(REGIONS), seeds=SWEEP_SEEDS, policies=SWEEP_POLICIES,
               baseline="carbon-agnostic", backend=backend, device=device)
    spent = {"learn_s": 0.0, "execute_s": 0.0}
    tiles = []
    prepare, simulate = sweep_mod.prepare_context, sweep_mod.simulate_many
    run_tile, capacity_fill = scan_engine._run_single_tile, fill.capacity_fill

    def timed(fn, key):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            spent[key] += time.perf_counter() - t
            return out
        return wrapper

    def tile(members, graph, dev, results):
        steps = scan_engine.stats["steps"]
        t = time.perf_counter()
        run_tile(members, graph, dev, results)
        tiles.append(dict(kind=members[0].prog.kind, cells=len(members),
                          steps=scan_engine.stats["steps"] - steps,
                          seconds=time.perf_counter() - t))

    def recorded(*args):
        if len(record) < scan_engine.CHUNK:
            record.append([x.clone() for x in args])
        return capacity_fill(*args)

    sweep_mod.prepare_context = timed(prepare, "learn_s")
    sweep_mod.simulate_many = timed(simulate, "execute_s")
    scan_engine._run_single_tile = tile
    if record is not None:
        fill.capacity_fill = recorded
    try:
        t = time.perf_counter()
        res = sw.run()
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        sweep_mod.prepare_context, sweep_mod.simulate_many = prepare, simulate
        scan_engine._run_single_tile, fill.capacity_fill = run_tile, capacity_fill
    return res, dict(wall_s=wall, tiles=tiles, **spent)



# A redesign pays on its path: its device time in turns over the route it
# replaced, at most this (the geo walk on the busiest recorded geo-flex
# step, the fill at B=64 on the mpc-scale tile's busiest step).
WALK_RATIO = 0.5


def redesign_timing(what, kernel, previous, floor, plain, report, names, plain_iters):
    """A redesigned kernel beside the route it replaced: events ms of each,
    of the floor and of the plain version; profiler device time of both
    routes in turns (new, old, old, new, twice), gated at WALK_RATIO; the
    floor's and the plain version's device time; ptxas for both kernels,
    gated at no spill in the new one."""
    tm = dict(ms=time_ms(kernel, 2000), previous_ms=time_ms(previous, 2000),
              plain_ms=time_ms(plain, plain_iters, warmup=2), floor_ms=time_ms(floor, 2000))
    turns = in_turns(dict(device_ms=kernel, previous_device_ms=previous))
    tm.update({k: float(np.mean(v)) for k, v in turns.items()})
    tm.update(turns=turns, ratio=tm["device_ms"] / tm["previous_device_ms"],
              floor_device_ms=device_ms(floor))
    ptx = {name: ptxas_report(report, name) for name in names}
    spilled = {n: r for n, r in ptx[names[0]].items()
               if r.get("spill_stores", 0) or r.get("spill_loads", 0)}
    if report and not ptx[names[0]]:
        raise AssertionError(f"{what}: ptxas reported nothing for {names[0]}")
    if spilled:
        raise AssertionError(f"{what}: {names[0]} spills: {spilled}")
    if not tm["ratio"] <= WALK_RATIO:
        raise AssertionError(f"{what}: the compact kernel takes {tm['device_ms']} ms of device "
                             f"time, more than {WALK_RATIO} of the chunked kernel's "
                             f"{tm['previous_device_ms']} ({turns})")
    return tm, ptx


def all_compact(what, launches, total):
    """Every launch a path made went to the compact route, none to the
    chunked one."""
    if not (launches["compact"] == launches[total] > 0 and launches["chunked"] == 0):
        raise AssertionError(f"{what}: launches by route {launches}")


def fill_work(cand, kreq):
    """Bytes the fill must move for these inputs: cand and forced (a byte
    per row each), the requests of the candidate rows, m_cap, take (a byte
    per row); operations: an add and a compare per candidate."""
    b, n = cand.shape
    n_cand = int(cand.sum().item())
    return 2 * b * n + 8 * n_cand + 8 * b + b * n, 2 * n_cand


def fill_kernel_phase(record, report):
    """Both fill routes against the plain version with ``torch.equal``:
    random inputs at B=1 and 64 and n_pad 256, 2048, 6144, the edge cases,
    and the mpc-scale tile's own inputs recorded from one chunk of
    ``sweep-full``; then at B=64 and the sweep's n_pad (the busiest step's
    cells repeated to 64) the compact kernel against the chunked one in
    turns (``redesign_timing``), beside the floor (an empty kernel on the
    compact grid), the plain version and the bound."""
    dev = torch.device("cuda")
    gen = np.random.default_rng(19)
    checked = 0

    def check(args, what):
        nonlocal checked
        want = fill.capacity_fill_plain(*(x.cpu() for x in args))
        for route in fill.ROUTES:
            got = fill.capacity_fill(*args, route=route)
            torch.cuda.synchronize()
            if got.dtype != torch.bool or not torch.equal(got.cpu(), want):
                raise AssertionError(f"capacity_fill {what} ({route}): the kernel and the "
                                     f"plain version differ in {int((got.cpu() != want).sum())}"
                                     " rows")
            checked += 1
        return want

    def random_args(b, n, p_cand=None, p_forced=None):
        cand = gen.random((b, n)) < (gen.random() if p_cand is None else p_cand)
        forced = gen.random((b, n)) < (gen.random() if p_forced is None else p_forced)
        kreq = gen.integers(1, 9, (b, n))
        m_cap = gen.integers(0, max(2, int(kreq.sum(1).max() * gen.random())) + 1, b)
        return [torch.from_numpy(x).to(dev) for x in (cand, forced, kreq, m_cap)]

    for b in (1, 64):
        for n in (256, 2048, 6144):
            for _ in range(3):
                check(random_args(b, n), f"random B={b} n={n}")
    for case in ("capacity 0", "everything fits", "nothing fits", "all forced",
                 "one row"):
        cand, forced, kreq, m_cap = random_args(64, 2048, 0.5, 0.2)
        if case == "capacity 0":
            m_cap.zero_()
        elif case == "everything fits":
            m_cap.fill_(int(kreq.sum(1).max()))
        elif case == "nothing fits":
            kreq.fill_(1000)
            m_cap.clamp_(max=999)
        elif case == "all forced":
            forced.fill_(True)
        else:
            cand, forced, kreq = (x[:, :1].contiguous() for x in (cand, forced, kreq))
            cand.fill_(True)
        take = check([cand, forced, kreq, m_cap], case)
        if case == "everything fits" and not torch.equal(take, cand.cpu()):
            raise AssertionError("capacity_fill: not every row taken where all fit")
        if case in ("capacity 0", "nothing fits") and take.any():
            raise AssertionError(f"capacity_fill {case}: a row was taken")
    log("capacity_fill: both routes equal to the plain version on 18 random inputs (B=1/64, "
        "n_pad 256/2048/6144) and 5 edge cases")
    if not record:
        raise AssertionError("capacity_fill: no mpc-scale step was recorded")
    for i, args in enumerate(record):
        check(args, f"recorded step {i}")
    b_tile, n_pad = record[0][0].shape
    cands = [int(r[0].sum()) for r in record]
    log(f"capacity_fill: both routes equal to the plain version on the mpc-scale tile's "
        f"{len(record)} recorded steps (B={b_tile}, n_pad={n_pad}; {min(cands)}-{max(cands)} "
        f"candidates a step)")

    # B=64 at the sweep's n_pad: the busiest recorded step's cells repeated.
    step = max(range(len(record)), key=lambda i: cands[i])
    rows = [i % b_tile for i in range(64)]
    args = [x[rows].contiguous() for x in record[step]]
    check(args, "B=64")
    smem = fill.plan(64, n_pad)["smem_bytes"]
    stream = torch.cuda.current_stream().cuda_stream
    tm, ptx = redesign_timing(
        f"capacity_fill B=64 n_pad={n_pad}", lambda: fill.capacity_fill(*args),
        lambda: fill.capacity_fill(*args, route="chunked"),
        lambda: fill._lib.capacity_fill_floor(0, 64, smem, stream),
        lambda: fill.capacity_fill_plain(*args), report,
        ("capacity_fill_compact_kernel", "capacity_fill_kernel"), 200)
    tm["plain_device_ms"] = device_ms(lambda: fill.capacity_fill_plain(*args), 50)
    nbytes, ops = fill_work(args[0], args[2])
    b, by = bound_ms(nbytes, ops)
    log(f"capacity_fill B=64 n_pad={n_pad} ({int(args[0].sum())} candidates): compact "
        f"{tm['ms']:.6f} ms/call, chunked {tm['previous_ms']:.6f} (plain {tm['plain_ms']:.6f}; "
        f"the floor, an empty kernel on the same grid, {tm['floor_ms']:.6f}); device time in "
        f"turns compact {tm['device_ms']:.6f}, chunked {tm['previous_device_ms']:.6f}: ratio "
        f"{tm['ratio']:.4f} (gate {WALK_RATIO}; {tm['turns']}); floor "
        f"{tm['floor_device_ms']}, plain {tm['plain_device_ms']}; bound {b:.9f} by {by}: "
        f"{nbytes} bytes; no one PyTorch call computes it; ptxas {ptx}")
    return dict(name="capacity_fill", route="cuda", source="src/repro_torch/csrc/fill.cu",
                kernel="capacity_fill_compact_kernel", previous_kernel="capacity_fill_kernel",
                replaces="src/repro/core/scan_engine.py:469 (the variable-k fill, a "
                         "lax.scan over rows; no Pallas kernel)",
                max_abs_err=0.0, checked=checked, shape=f"B=64 n_pad={n_pad} int64",
                bound_ms=b, bound_by=by, bytes=nbytes, library_ms=None,
                library="none: no one PyTorch call computes the fill", ptxas=ptx,
                recorded_steps=len(record), recorded_shape=[b_tile, n_pad], **tm)


def sweep_phase(report, twins=None):
    """Phase 7: the four golden grids on the card, on the vector and scan
    engines; ``sweep-full`` on the card against its CPU run; the fill kernel
    against its plain version and timed; one traced mpc-scale chunk."""
    goldens = {}
    for engine in ("vector", "scan"):
        for name, sw in golden_sweeps("cuda", engine, "device"):
            with open(os.path.join(GOLDEN, f"{name}.json")) as f:
                want = f.read()
            reset_counts()
            t = time.perf_counter()
            got = sw.run().to_json() + "\n"
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            stats = dict(scan_engine.stats)
            if got != want:
                raise AssertionError(f"{name} on {engine}: differs from the fixture")
            if engine == "scan" and name == "golden_sweep_dag" and not (
                    gating.launches["dep_release"] == stats["dag_steps"] > 0):
                raise AssertionError(f"{name}: {gating.launches} for {stats}")
            if engine == "scan" and name == "golden_sweep_mpc":
                if not (stats["delegated"] == 2
                        and fill.launches["capacity_fill"] == stats["fill_steps"] > 0):
                    raise AssertionError(f"{name}: {fill.launches} for {stats}")
                all_compact(name, fill.launches, "capacity_fill")
            goldens[f"{name}/{engine}"] = dict(
                wall_s=wall, steps=stats["steps"], delegated=stats["delegated"],
                fill_launches=fill.launches["capacity_fill"],
                release_launches=gating.launches["dep_release"],
                greedy_launches=oracle_greedy.launches["greedy_pass"])
            log(f"{name} on the card, {engine} engine: byte for byte the fixture "
                f"({wall:.3f} s; {goldens[f'{name}/{engine}']})")

    record = []
    reset_counts()
    card, tc = sweep_full("cuda", "scan", "device", record)
    counts = dict(knn=dict(knn.launches), greedy=dict(oracle_greedy.launches),
                  fill=dict(fill.launches), stats=dict(scan_engine.stats),
                  oracle=dict(oracle_mod.stats))
    cpu = twin_result(twins, "sweep_full")
    tcpu = cpu["timing"]
    log(f"sweep-full ({len(card.rows())} cells): card {tc['wall_s']:.3f} s (learning "
        f"{tc['learn_s']:.3f}, execution {tc['execute_s']:.3f}); CPU vector engine, numpy "
        f"pass {tcpu['wall_s']:.3f} s (learning {tcpu['learn_s']:.3f}, execution "
        f"{tcpu['execute_s']:.3f})")
    log(card.table())
    log(f"  slot-loop tiles on the card {sum(tl['seconds'] for tl in tc['tiles']):.3f} s")
    if card.to_json() != cpu["json"]:
        diff = [(a["region"], a["seed"], a["policy"]) for a, b in
                zip(card.rows(), cpu["rows"]) if a != b]
        raise AssertionError(f"sweep-full: the card and the CPU differ in {diff}")
    flex_slots = sum(len(r.slots) for row, r in zip(card.rows(), card.results)
                     if row["policy"] == "carbonflex")
    stats = counts["stats"]
    if not (counts["knn"]["knn_topk"] == flex_slots > 0):
        raise AssertionError(f"sweep-full: {counts['knn']} knn launches for "
                             f"{flex_slots} carbonflex slots")
    if not (counts["greedy"]["greedy_pass"] == counts["oracle"]["device_passes"] > 0):
        raise AssertionError(f"sweep-full: {counts['greedy']} greedy launches for "
                             f"{counts['oracle']}")
    if not (counts["fill"]["capacity_fill"] == stats["fill_steps"] > 0):
        raise AssertionError(f"sweep-full: {counts['fill']} fill launches for {stats}")
    all_compact("sweep-full", counts["fill"], "capacity_fill")
    n_scen = len(REGIONS) * len(SWEEP_SEEDS)
    if stats["delegated"] != 2 * n_scen:
        raise AssertionError(f"sweep-full: {stats['delegated']} cells delegated, not the "
                             f"{2 * n_scen} carbonflex and oracle-estimated cells")
    by_kind = {}
    for tl in tc["tiles"]:
        k = by_kind.setdefault(tl["kind"], dict(cells=0, steps=0, seconds=0.0))
        for f in ("cells", "steps", "seconds"):
            k[f] += tl[f]
    for kind, k in by_kind.items():
        k.update(cells_per_s=k["cells"] / k["seconds"],
                 ms_per_step=1e3 * k["seconds"] / k["steps"])
        log(f"  slot loop {kind:9s}: {k['cells']} cells, {k['steps']} batched steps, "
            f"{k['seconds']:.3f} s: {k['cells_per_s']:.3f} cells/s, "
            f"{k['ms_per_step']:.6f} ms per batched step")
    if set(by_kind) != {"plain", "thresh", "mpc", "mpc-scale"}:
        raise AssertionError(f"sweep-full: slot-loop kinds {sorted(by_kind)}")
    log(f"sweep-full launches: knn_topk {counts['knn']['knn_topk']} (== carbonflex "
        f"slots), greedy {counts['greedy']} (== device passes "
        f"{counts['oracle']['device_passes']}), capacity_fill "
        f"{counts['fill']['capacity_fill']} (== fill steps); {stats}")

    fill_entry = fill_kernel_phase(record, report)
    fill_entry.update(launches=counts["fill"]["capacity_fill"], path="sweep-full",
                      launches_by_route={r: counts["fill"][r] for r in fill.ROUTES})

    # One traced chunk of the mpc-scale tile: its cells alone, no overrun.
    from torch.profiler import ProfilerActivity, profile

    scen = Sweep(base=Scenario(capacity=150, learn_weeks=3, eval_weeks=1, seed=1),
                 regions=list(REGIONS), seeds=SWEEP_SEEDS).scenarios()
    mats = [sc.materialize() for sc in scen]

    def cases():
        out = []
        for mat in mats:
            pol = CarbonFlexScalePolicy(cfg=MPCConfig(scale_rho=0.3))
            pol.warm_start(mat.hist)
            out.append(SimCase(jobs=mat.eval_jobs, ci=mat.ci, cluster=mat.cluster,
                               policy=pol, t0=mat.t0, horizon=WEEK, max_overrun=0,
                               engine="scan", device="cuda"))
        return out

    simulate_many(cases())                      # warm
    torch.cuda.synchronize()
    scan_engine.reset_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        simulate_many(cases())
        torch.cuda.synchronize()
    chunk_s = scan_engine.stats["loop_s"]
    events = device_events(prof)
    busy = busy_us(events) / 1e3
    fill_ms = sum(e.time_range.elapsed_us() for e in events
                  if "capacity_fill" in e.name) / 1e3
    log(f"traced mpc-scale chunk ({scan_engine.stats['steps']} batched steps of "
        f"{len(mats)} cells): chunk loop {chunk_s:.6f} s, card busy {busy:.6f} ms = "
        f"{100 * busy / 1e3 / chunk_s:.6f} % of it; the fill kernel {fill_ms:.6f} ms")
    return fill_entry, dict(
        goldens=goldens, cells=len(card.rows()), card=tc, cpu=tcpu, by_kind=by_kind,
        launches=counts, summary=card.summary(),
        traced_chunk=dict(loop_s=chunk_s, busy_ms=busy, busy_share=busy / 1e3 / chunk_s,
                          fill_ms=fill_ms, steps=scan_engine.stats["steps"]))


GEO_REGIONS = ("south-australia", "california")
GEO_SEEDS = [7, 8, 9]
GEO_MIXED_REGIONS = ("south-australia", "california", "ontario")
GEO_OUTS = ("take", "placed", "pol_region", "eng_region", "mig_left", "moves", "mig_now")


def geo_full(device, engine, record=None, telemetry=None):
    """``geo-full``: ``benchmarks/bench_engine.py::bench_geo``'s world, the
    150-server cluster split over two regions, 3 seeds x the geo policies;
    returns the result, the wall time, and per slot-loop tile its kind,
    cells, steps and seconds.  ``record`` collects the geo-flex tile's
    first chunk of walk inputs; ``telemetry`` rides on the sweep."""
    sw = Sweep(base=Scenario(regions=GEO_REGIONS, capacity=150, learn_weeks=1, seed=7,
                             engine=engine),
               seeds=GEO_SEEDS, policies=list(DEFAULT_GEO_POLICIES), device=device,
               telemetry=telemetry)
    tiles = []
    run_tile, resolve = scan_engine._run_geo_tile, geo_walk.geo_resolve

    def tile(members, dev, results):
        steps = scan_engine.stats["steps"]
        t = time.perf_counter()
        run_tile(members, dev, results)
        tiles.append(dict(kind=members[0].prog.kind, cells=len(members),
                          n_pad=members[0].prog.n_pad,
                          steps=scan_engine.stats["steps"] - steps,
                          seconds=time.perf_counter() - t))

    def recorded(kind, cand, forced, state, consts, tables):
        if kind == "geo-flex" and len(record) < scan_engine.CHUNK:
            record.append((cand.clone(), forced.clone(),
                           {k: state[k].clone() for k in geo_walk._STATE},
                           {k: consts[k].clone() for k in (*geo_walk._ROW_CONSTS,
                                                           *geo_walk._CELL_CONSTS)},
                           {k: tables[k].clone() for k in geo_walk._TABLES[kind]}))
        return resolve(kind, cand, forced, state, consts, tables)

    scan_engine._run_geo_tile = tile
    if record is not None:
        geo_walk.geo_resolve = recorded
    try:
        t = time.perf_counter()
        res = sw.run()
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        scan_engine._run_geo_tile, geo_walk.geo_resolve = run_tile, resolve
    return res, dict(wall_s=wall, tiles=tiles)


def mixed_k_jobs(jobs, seed):
    """Each job's k_min drawn from {1, 2, 4} within its k_max (the profile
    cut so that k_max stays)."""
    gen = np.random.default_rng(seed)
    out = []
    for j in jobs:
        k = int(gen.choice([k for k in (1, 2, 4) if j.k_min <= k <= j.k_max]))
        out.append(dataclasses.replace(j, k_min=k, profile=j.profile[k - j.k_min:]))
    return out


def geo_fields_differ(a, b):
    """The fields ``tests/test_geo.py::assert_geo_results_identical``
    compares that differ between two results."""
    diff = [f for f in ("carbon_g", "energy_kwh", "migrations", "migration_carbon_g")
            if getattr(a, f) != getattr(b, f)]
    diff += [f for f in ("completion", "violations", "wait_slots", "final_region",
                         "region_carbon_g", "region_energy_kwh")
             if not np.array_equal(getattr(a, f), getattr(b, f))]
    if [vars(x) for x in a.slots] != [vars(y) for y in b.slots]:
        diff.append("slots")
    return diff


def geo_inputs(gen, kind, b, n, regions, dev, mixed):
    """Random ``geo_resolve`` inputs: candidates, forced, started, placed
    and migrating rows, CI values and means with ties."""
    bn = (b, n)
    kmin = gen.choice([1, 2, 4], bn) if mixed else np.ones(bn, dtype=np.int64)
    state = dict(
        remaining=np.where(gen.random(bn) < 0.3, gen.integers(1, 40, bn).astype(float),
                           gen.uniform(0.01, 40.0, bn)),
        slack=gen.integers(-3, 30, bn), started=gen.random(bn) < 0.5,
        placed=gen.random(bn) < 0.4, pol_region=gen.integers(0, regions, bn),
        eng_region=gen.integers(0, regions, bn), mig_left=gen.integers(0, 2, bn),
        moves=gen.integers(0, 2, bn))
    consts = dict(kmin=kmin, ec=kmin * gen.choice([1.0, 0.3, 2.5], bn),
                  mig_e=0.05 * np.maximum(1.0, gen.uniform(0, 8, bn)),
                  mig_slots=gen.integers(1, 4, bn), mig_idx=gen.integers(0, 3, bn),
                  caps=gen.integers(1, max(2, n // 4), (b, regions)),
                  margin_c=np.full(b, 0.75), max_moves=gen.integers(1, 3, b))
    ci = np.round(gen.uniform(10, 700, (b, regions)), -1)
    tables = dict(ci_now=ci, clean_order=np.argsort(ci, axis=1, kind="stable"),
                  thresh_eps=gen.uniform(10, 700, (b, regions)) + 1e-9,
                  means=np.round(gen.uniform(10, 700, (b, regions, 24)), -1),
                  movemeans=gen.uniform(10, 700, (b, 3, regions, 24)))

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return (t(gen.random(bn) < 0.6), t(gen.random(bn) < 0.3),
            {k: t(v) for k, v in state.items()}, {k: t(v) for k, v in consts.items()},
            {k: t(v) for k, v in tables.items() if k in geo_walk._TABLES[kind]})


def geo_walk_work(kind, cand, forced, state, consts, tables):
    """(bytes, operations) one call needs on these inputs: every row's
    candidate flag and the state it copies (placed, regions, countdown,
    moves), every output written once, the candidates' other row fields,
    the cell constants and the slot's tables read once; a compare per
    region and candidate, and the migration rule's four operations per
    region of each started candidate."""
    b, n = cand.shape
    n_cand = int(cand.sum())
    n_started = int((cand & state["started"]).sum())
    regions = consts["caps"].shape[1]
    cells = sum(x.numel() * x.element_size() for x in tables.values()) \
        + sum(consts[k].numel() * consts[k].element_size() for k in geo_walk._CELL_CONSTS)
    nbytes = b * n * (1 + 33 + 35) + n_cand * (2 + 7 * 8) + cells
    return nbytes, n_cand * regions + 4 * regions * n_started


def geo_kernel_phase(record, report):
    """Both geo walk routes against ``geo_resolve_plain`` with ``torch.equal``
    on every output: 16 random inputs (R 2-16, uniform and mixed k, three
    kinds), the edge cases (nothing fits, all forced, one row) and the
    geo-flex tile's recorded steps; then on the busiest recorded step the
    compact kernel against the chunked one in turns (``redesign_timing``),
    beside the floor (an empty kernel on the compact grid), the plain
    version and the bound."""
    dev = torch.device("cuda")
    gen = np.random.default_rng(23)
    checked = 0

    def check(kind, args, what):
        nonlocal checked
        cpu = [{k: v.cpu() for k, v in a.items()} if isinstance(a, dict) else a.cpu()
               for a in args]
        want = geo_walk.geo_resolve_plain(kind, *cpu)
        for route in geo_walk.ROUTES:
            got = geo_walk.geo_resolve(kind, *args, route=route)
            torch.cuda.synchronize()
            for name, a, w in zip(GEO_OUTS, got, want):
                if a.dtype != w.dtype or not torch.equal(a.cpu(), w):
                    raise AssertionError(f"geo_walk {what} ({route}): {name} differs from the "
                                         f"plain version in {int((a.cpu() != w).sum())} rows")
            checked += 1
        return want

    for i in range(16):
        kind = geo_walk.KINDS[i % 3]
        regions = (2, 3, 10, 16)[i % 4]
        check(kind, geo_inputs(gen, kind, 4, 512, regions, dev, mixed=i % 2 == 1),
              f"random {kind} R={regions}")
    for i, case in enumerate(("nothing fits", "all forced", "one row")):
        kind = geo_walk.KINDS[i]
        cand, forced, state, consts, tables = geo_inputs(
            gen, kind, 3, 1 if case == "one row" else 256, 4, dev, mixed=True)
        if case == "nothing fits":
            consts["kmin"].fill_(4)
            consts["caps"].fill_(1)
        elif case == "all forced":
            forced.fill_(True)
        want = check(kind, (cand, forced, state, consts, tables), case)
        if case == "nothing fits" and want[0].any():
            raise AssertionError("geo_walk: a row ran where nothing fits")
    log("geo_walk: both routes equal to the plain version on 16 random inputs (R 2/3/10/16, "
        "uniform and mixed k, the three kinds, B=4 n=512) and 3 edge cases")
    if not record:
        raise AssertionError("geo_walk: no geo-flex step was recorded")
    busiest, walked = 0, []
    for i, args in enumerate(record):
        want = check("geo-flex", args, f"recorded step {i}")
        walked.append(int((args[0] & ~want[6].to(dev)).sum(1).max()))
        if walked[-1] > walked[busiest]:
            busiest = i
    args = record[busiest]
    b, n = args[0].shape
    regions = args[3]["caps"].shape[1]
    log(f"geo_walk: both routes equal to the plain version on the geo-flex tile's "
        f"{len(record)} recorded steps (B={b}, n_pad={n}); candidate rows walked a cell per "
        f"step {min(walked)}-{max(walked)}")
    smem = geo_walk.plan(b, n, regions)["smem_bytes"]
    stream = torch.cuda.current_stream().cuda_stream
    cpu_args = [{k: v.cpu() for k, v in a.items()} if isinstance(a, dict) else a.cpu()
                for a in args]
    tm, ptx = redesign_timing(
        f"geo_walk B={b} n_pad={n} R={regions}", lambda: geo_walk.geo_resolve("geo-flex", *args),
        lambda: geo_walk.geo_resolve("geo-flex", *args, route="chunked"),
        lambda: geo_walk._lib.geo_walk_floor(0, b, smem, stream),
        lambda: geo_walk.geo_resolve_plain("geo-flex", *cpu_args), report,
        ("geo_walk_compact_kernel", "geo_walk_kernel"), 20)
    nbytes, ops_ = geo_walk_work("geo-flex", *args)
    bound, by = bound_ms(nbytes, ops_)
    log(f"geo_walk B={b} n_pad={n} R={regions} (the busiest recorded step: "
        f"{walked[busiest]} candidate rows walked in its busiest cell): compact "
        f"{tm['ms']:.6f} ms/call, chunked {tm['previous_ms']:.6f} (plain {tm['plain_ms']:.6f}; "
        f"the floor, an empty kernel on the same grid, {tm['floor_ms']:.6f}); device time in "
        f"turns compact {tm['device_ms']:.6f}, chunked {tm['previous_device_ms']:.6f}: ratio "
        f"{tm['ratio']:.4f} (gate {WALK_RATIO}; {tm['turns']}); floor {tm['floor_device_ms']}; "
        f"compact {1e6 * tm['device_ms'] / walked[busiest]:.3f} ns a walked candidate; bound "
        f"{bound:.9f} by {by}: {nbytes} bytes; no one PyTorch call computes it; ptxas {ptx}")
    return dict(name="geo_walk", route="cuda", source="src/repro_torch/csrc/geo_walk.cu",
                kernel="geo_walk_compact_kernel", previous_kernel="geo_walk_kernel",
                replaces="src/repro/core/scan_engine.py:751 (_geo_resolve_uniform / "
                         "_geo_resolve_walk :891, a lax.while_loop fixpoint and a "
                         "lax.scan over rows; no Pallas kernel)",
                max_abs_err=0.0, checked=checked,
                shape=f"B={b} n_pad={n} R={regions} float64/int64",
                bound_ms=bound, bound_by=by, bytes=nbytes, library_ms=None,
                library="none: no one PyTorch call computes the walk", ptxas=ptx,
                serial_chain=walked[busiest], recorded_steps=len(record), **tm)


def geo_phase(report, twins=None):
    """Phase 8: ``geo-full`` on the card against the CPU (the CPU twin's
    run); the mixed-k_min world; the walk kernel against its plain version
    and timed."""
    record = []
    reset_counts()
    card, tc = geo_full("cuda", "scan", record)
    launches = geo_walk.launches["geo_walk"]
    by_route = {r: geo_walk.launches[r] for r in geo_walk.ROUTES}
    all_compact("geo-full", geo_walk.launches, "geo_walk")
    stats = dict(scan_engine.stats)
    cpu = twin_result(twins, "geo_full")
    tcpu = cpu["timing"]
    log(f"geo-full ({len(card.rows())} cells): card {tc['wall_s']:.3f} s, CPU vector "
        f"engine {tcpu['wall_s']:.3f} s")
    log(card.table())
    RECORDER_OFF["geo-full"] = card.to_json()
    if card.to_json() != cpu["json"]:
        diff = [(a["seed"], a["policy"]) for a, b in zip(card.rows(), cpu["rows"]) if a != b]
        raise AssertionError(f"geo-full: the card and the CPU differ in {diff}")
    if not (launches == stats["geo_steps"] >= 1):
        raise AssertionError(f"geo-full: {launches} geo_walk launches for {stats}")
    if stats["delegated"] != 0:
        raise AssertionError(f"geo-full: {stats['delegated']} cells delegated")
    by_kind = {}
    for tl in tc["tiles"]:
        k = by_kind.setdefault(tl["kind"], dict(cells=0, steps=0, seconds=0.0,
                                                n_pad=tl["n_pad"]))
        for f in ("cells", "steps", "seconds"):
            k[f] += tl[f]
    if set(by_kind) != set(DEFAULT_GEO_POLICIES):
        raise AssertionError(f"geo-full: slot-loop kinds {sorted(by_kind)}")
    migrations = {}
    for row in card.rows():
        migrations[row["policy"]] = migrations.get(row["policy"], 0) + row["migrations"]
    for kind, k in by_kind.items():
        k["ms_per_step"] = 1e3 * k["seconds"] / k["steps"]
        log(f"  slot loop {kind:10s}: {k['cells']} cells (n_pad {k['n_pad']}), "
            f"{k['steps']} batched steps, {k['seconds']:.3f} s: {k['ms_per_step']:.6f} ms "
            f"per batched step; migrations {migrations[kind]}")
    log(f"geo-full launches: geo_walk {launches} (== geo steps; by route {by_route}); {stats}")

    mat = Scenario(regions=GEO_MIXED_REGIONS, capacity=150, learn_weeks=1,
                   seed=7).materialize()
    jobs = mixed_k_jobs(mat.eval_jobs, 5)
    mixed = {}
    for pol in (GeoGreedyPolicy, GeoFlexPolicy):
        reset_counts()
        t = time.perf_counter()
        got = simulate(jobs, mat.mci, mat.geo, pol(), t0=mat.t0, horizon=WEEK,
                       engine="scan", device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        n_launch, steps = geo_walk.launches["geo_walk"], scan_engine.stats["geo_steps"]
        all_compact(f"mixed k_min {pol().name}", geo_walk.launches, "geo_walk")
        want = simulate(jobs, mat.mci, mat.geo, pol(), t0=mat.t0, horizon=WEEK)
        diff = geo_fields_differ(got, want)
        if diff or not (n_launch == steps >= 1):
            raise AssertionError(f"mixed k_min {pol().name}: fields {diff} differ; "
                                 f"{n_launch} launches for {steps} geo steps")
        mixed[pol().name] = dict(wall_s=wall, steps=steps, migrations=got.migrations,
                                 carbon_g=got.carbon_g)
    log(f"mixed k_min (3 regions, {len(jobs)} jobs, k_min "
        f"{sorted({j.k_min for j in jobs})}): scan on the card equal to the CPU's vector "
        f"engine in every compared field: {mixed}")

    entry = geo_kernel_phase(record, report)
    entry.update(launches=launches, path="geo-scan", launches_by_route=by_route)
    return entry, dict(cells=len(card.rows()), card=tc, cpu=tcpu, by_kind=by_kind,
                       launches=launches, stats=stats, migrations=migrations,
                       mixed_k=mixed, summary=card.summary(), **geo_split())


def geo_split():
    """Where a geo step's time goes: the host's per-chunk tables of each
    kind (one 168-slot chunk of seed 7, mean of 5 builds), and one traced
    chunk of the geo-flex tile (its 3 cells, no overrun) for the card's busy
    share and the walk kernel's device time in it."""
    from torch.profiler import ProfilerActivity, profile

    scen = [Scenario(regions=GEO_REGIONS, capacity=150, learn_weeks=1, seed=s)
            for s in GEO_SEEDS]
    mats = [sc.materialize() for sc in scen]
    packed = pack(mats[0].eval_jobs)
    ts = np.arange(mats[0].t0, mats[0].t0 + scan_engine.CHUNK)
    tables_ms = {}
    for name in DEFAULT_GEO_POLICIES:
        pol = {"geo-static": GeoStaticPolicy, "geo-greedy": GeoGreedyPolicy,
               "geo-flex": GeoFlexPolicy}[name]()
        prog = scan_engine._build_geo(packed, mats[0].geo, pol, mats[0].mci, mats[0].t0,
                                      WEEK, name)
        t = time.perf_counter()
        for _ in range(5):
            prog.xs_fn(ts)
        tables_ms[name] = 1e3 * (time.perf_counter() - t) / 5
    log(f"geo host tables per {scan_engine.CHUNK}-slot chunk (ms): {tables_ms}")

    def cases():
        return [SimCase(jobs=m.eval_jobs, ci=m.mci, cluster=m.geo, policy=GeoFlexPolicy(),
                        t0=m.t0, horizon=WEEK, max_overrun=0, engine="scan",
                        device="cuda") for m in mats]

    simulate_many(cases())                      # warm
    torch.cuda.synchronize()
    scan_engine.reset_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        simulate_many(cases())
        torch.cuda.synchronize()
    loop_s = scan_engine.stats["loop_s"]
    events = device_events(prof)
    busy = busy_us(events) / 1e3
    walk_ms = sum(e.time_range.elapsed_us() for e in events if "geo_walk" in e.name) / 1e3
    log(f"traced geo-flex chunk ({scan_engine.stats['steps']} batched steps of "
        f"{len(mats)} cells): chunk loop {loop_s:.6f} s, card busy {busy:.6f} ms = "
        f"{100 * busy / 1e3 / loop_s:.6f} % of it; the walk kernel {walk_ms:.6f} ms")
    return dict(tables_ms=tables_ms,
                traced_chunk=dict(loop_s=loop_s, busy_ms=busy,
                                  busy_share=busy / 1e3 / loop_s, walk_ms=walk_ms,
                                  steps=scan_engine.stats["steps"]))


# --- resilience: fault processes and carbon-feed outages ------------------------

CHAOS_OUTAGE = dict(rate=0.04, mean_duration=6.0, seed=1)
CHAOS_POLICIES = ("carbon-agnostic", "wait-awhile", "carbonflex", "carbonflex-mpc",
                  "carbonflex-scale")
CHAOS_SEEDS = (1, 2)
CHAOS_KINDS = {"plain", "thresh", "mpc", "mpc-scale"}


def chaos_faults():
    """The fault axis of ``chaos-full``: none and one process of each kind."""
    return [None, IidFaults(straggler_rate=0.15, failure_rate=0.05, seed=2),
            CorrelatedFaults(n_domains=4, rate=0.05, seed=2),
            PreemptionFaults(rate=0.05, checkpoint_every=4, seed=2)]


def tiled_run(sw, device):
    """Run a sweep; returns the result, its wall time split into learning
    (``prepare_context``) and execution (the one ``simulate_many``
    dispatch), and per slot-loop tile (single-region and geo) its kind,
    cells, steps and seconds."""
    tiles = []
    spent = {"learn_s": 0.0, "execute_s": 0.0}
    run_single, run_geo = scan_engine._run_single_tile, scan_engine._run_geo_tile
    prepare, simulate = sweep_mod.prepare_context, sweep_mod.simulate_many

    def spending(fn, key):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            spent[key] += time.perf_counter() - t
            return out
        return wrapper

    def timed(fn):
        def tile(members, *args):
            steps = scan_engine.stats["steps"]
            t = time.perf_counter()
            fn(members, *args)
            tiles.append(dict(kind=members[0].prog.kind, cells=len(members),
                              steps=scan_engine.stats["steps"] - steps,
                              seconds=time.perf_counter() - t))
        return tile

    scan_engine._run_single_tile = timed(run_single)
    scan_engine._run_geo_tile = timed(run_geo)
    sweep_mod.prepare_context = spending(prepare, "learn_s")
    sweep_mod.simulate_many = spending(simulate, "execute_s")
    try:
        t = time.perf_counter()
        res = sw.run()
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        scan_engine._run_single_tile, scan_engine._run_geo_tile = run_single, run_geo
        sweep_mod.prepare_context, sweep_mod.simulate_many = prepare, simulate
    return res, dict(wall_s=wall, tiles=tiles, **spent)


def outage_tables():
    """What the outage costs the slot loop's host tables: one 168-slot chunk
    of wait-awhile's eligibility and of geo-flex's tables (mean of 5
    builds), on the fresh feed (the whole-trace fast path) and on the
    degraded view (the per-slot calls)."""
    out = {}
    for outage in (None, CarbonDataOutage(**CHAOS_OUTAGE)):
        mat = Scenario(region="south-australia", capacity=150, learn_weeks=1, seed=1,
                       ci_outage=outage).materialize()
        gmat = Scenario(regions=GEO_REGIONS, capacity=150, learn_weeks=1, seed=7,
                        ci_outage=outage).materialize()
        ts = np.arange(mat.t0, mat.t0 + scan_engine.CHUNK)
        elig = scan_engine._single_elig_fn(WaitAwhilePolicy(), mat.ci.degraded(), "thresh")
        prog = scan_engine._build_geo(pack(gmat.eval_jobs), gmat.geo, GeoFlexPolicy(),
                                      gmat.mci.degraded(), gmat.t0, WEEK, "geo-flex")
        label = "outage" if outage else "fresh"
        for name, fn in (("wait-awhile", elig), ("geo-flex", prog.xs_fn)):
            t = time.perf_counter()
            for _ in range(5):
                fn(ts)
            out[f"{name} {label}"] = 1e3 * (time.perf_counter() - t) / 5
    log(f"host tables per {scan_engine.CHUNK}-slot chunk (ms), fresh feed and outage: {out}")
    return out


def chaos_full(device, engine, backend, telemetry=None):
    """``chaos-full``: the 150-server cluster in south-australia under a
    carbon-feed outage, seeds 1 and 2 x the fault axis x five policies (40
    cells); ``telemetry`` rides on the sweep."""
    sw = Sweep(base=Scenario(region="south-australia", capacity=150, learn_weeks=3,
                             eval_weeks=1, seed=1, engine=engine,
                             mpc=MPCConfig(scale_rho=0.3),
                             ci_outage=CarbonDataOutage(**CHAOS_OUTAGE)),
               seeds=CHAOS_SEEDS, policies=CHAOS_POLICIES, faults=chaos_faults(),
               backend=backend, device=device, telemetry=telemetry)
    return tiled_run(sw, device)


def geo_chaos(device, engine):
    """``geo-chaos``: ``geo-full``'s world under the same outage, fault-free
    and with correlated failure domains, the three geo policies (18 cells)."""
    sw = Sweep(base=Scenario(regions=GEO_REGIONS, capacity=150, learn_weeks=1, seed=7,
                             engine=engine, ci_outage=CarbonDataOutage(**CHAOS_OUTAGE)),
               seeds=GEO_SEEDS, policies=list(DEFAULT_GEO_POLICIES),
               faults=[None, CorrelatedFaults(n_domains=4, rate=0.05, seed=2)],
               device=device)
    return tiled_run(sw, device)


def by_kind(tiles):
    out = {}
    for tl in tiles:
        k = out.setdefault(tl["kind"], dict(cells=0, steps=0, seconds=0.0))
        for f in ("cells", "steps", "seconds"):
            k[f] += tl[f]
    for k in out.values():
        k["ms_per_step"] = 1e3 * k["seconds"] / k["steps"]
    return out


def chaos_phase(twins=None):
    """Phase 9: ``chaos-full`` and ``geo-chaos`` on the card against the CPU's
    vector engine, the DAG path under a feed outage (the CPU runs the CPU
    twin's, ``chaos_cpu``), and the golden serving grid."""
    # chaos-full: the outage-only cells of the four native kinds on the card's
    # slot loop, every faulted cell (and carbonflex) on the vector engine
    calls = [0]

    def counted(*args, **kw):
        calls[0] += 1
        return provision(*args, **kw)

    reset_counts()
    policy_mod.provision = counted
    try:
        card, tc = chaos_full("cuda", "scan", "device")
    finally:
        policy_mod.provision = provision
    counts = dict(knn=dict(knn.launches), greedy=dict(oracle_greedy.launches),
                  fill=dict(fill.launches), stats=dict(scan_engine.stats),
                  oracle=dict(oracle_mod.stats), provision_calls=calls[0])
    twin = twin_result(twins, "chaos")
    cpu, tcpu = twin["chaos"], twin["chaos"]["timing"]
    n_faults = len(chaos_faults())
    log(f"chaos-full ({len(card.rows())} cells): card {tc['wall_s']:.3f} s (learning "
        f"{tc['learn_s']:.3f}, execution {tc['execute_s']:.3f}); CPU vector engine, numpy "
        f"pass {tcpu['wall_s']:.3f} s (learning {tcpu['learn_s']:.3f}, execution "
        f"{tcpu['execute_s']:.3f})")
    log(card.table())
    RECORDER_OFF["chaos-full"] = card.to_json()
    if card.to_json() != cpu["json"]:
        diff = [(a["seed"], a["fault"], a["policy"]) for a, b in
                zip(card.rows(), cpu["rows"]) if a != b]
        raise AssertionError(f"chaos-full: the card and the CPU differ in {diff}")
    stats = counts["stats"]
    kinds = by_kind(tc["tiles"])
    native = sum(k["cells"] for k in kinds.values())
    n_seeds = len(CHAOS_SEEDS)
    if set(kinds) != CHAOS_KINDS or native != len(CHAOS_KINDS) * n_seeds:
        raise AssertionError(f"chaos-full: slot-loop tiles {kinds}")
    if (stats["fault_delegated"] != (n_faults - 1) * len(CHAOS_POLICIES) * n_seeds
            or stats["delegated"] != n_seeds):
        raise AssertionError(f"chaos-full: delegated cells {stats}")
    if not (counts["knn"]["knn_topk"] == counts["provision_calls"] > 0):
        raise AssertionError(f"chaos-full: {counts['knn']} knn launches for "
                             f"{counts['provision_calls']} provisioning calls")
    if not (counts["fill"]["capacity_fill"] == stats["fill_steps"] > 0):
        raise AssertionError(f"chaos-full: {counts['fill']} fill launches for {stats}")
    all_compact("chaos-full", counts["fill"], "capacity_fill")
    if not (counts["greedy"]["greedy_pass"] == counts["oracle"]["device_passes"] > 0):
        raise AssertionError(f"chaos-full: {counts['greedy']} greedy launches for "
                             f"{counts['oracle']}")
    for row in card.rows():
        if not (row.get("resilience", {}).get("degraded_slots", 0) > 0
                and math.isfinite(row["carbon_g"]) and row["carbon_g"] > 0):
            raise AssertionError(f"chaos-full: row without degraded slots: {row}")
    for kind, k in sorted(kinds.items()):
        log(f"  slot loop {kind:9s}: {k['cells']} outage cells, {k['steps']} batched steps, "
            f"{k['seconds']:.3f} s: {k['ms_per_step']:.6f} ms per batched step")
    log(f"chaos-full launches: knn_topk {counts['knn']['knn_topk']} (== provisioning calls), "
        f"greedy {counts['greedy']['greedy_pass']} (== device passes "
        f"{counts['oracle']['device_passes']}), capacity_fill "
        f"{counts['fill']['capacity_fill']} (== fill steps); {stats}")

    # geo-chaos: the 9 outage cells on the geo slot loop, the 9 faulted ones
    # on the geo vector engine
    reset_counts()
    gcard, tgc = geo_chaos("cuda", "scan")
    glaunch, gstats = geo_walk.launches["geo_walk"], dict(scan_engine.stats)
    all_compact("geo-chaos", geo_walk.launches, "geo_walk")
    gcpu, tgcpu = twin["geo"], twin["geo"]["timing"]
    log(f"geo-chaos ({len(gcard.rows())} cells): card {tgc['wall_s']:.3f} s (execution "
        f"{tgc['execute_s']:.3f}), CPU vector engine {tgcpu['wall_s']:.3f} s (execution "
        f"{tgcpu['execute_s']:.3f})")
    log(gcard.table())
    if gcard.to_json() != gcpu["json"]:
        diff = [(a["seed"], a["fault"], a["policy"]) for a, b in
                zip(gcard.rows(), gcpu["rows"]) if a != b]
        raise AssertionError(f"geo-chaos: the card and the CPU differ in {diff}")
    gkinds = by_kind(tgc["tiles"])
    n_geo = len(GEO_SEEDS) * len(DEFAULT_GEO_POLICIES)
    if not (glaunch == gstats["geo_steps"] > 0 and gstats["fault_delegated"] == n_geo
            and gstats["delegated"] == 0 and set(gkinds) == set(DEFAULT_GEO_POLICIES)
            and sum(k["cells"] for k in gkinds.values()) == n_geo):
        raise AssertionError(f"geo-chaos: {glaunch} geo_walk launches, tiles {gkinds}, "
                             f"{gstats}")
    if any(r["resilience"]["degraded_slots"] <= 0 for r in gcard.rows()):
        raise AssertionError("geo-chaos: a row without degraded slots")
    for kind, k in sorted(gkinds.items()):
        log(f"  slot loop {kind:10s}: {k['cells']} outage cells, {k['steps']} batched "
            f"steps, {k['seconds']:.3f} s: {k['ms_per_step']:.6f} ms per batched step")
    log(f"geo-chaos launches: geo_walk {glaunch} (== geo steps); {gstats}")

    # the DAG path under a feed outage: dag-carbon and dag-cap's tables from the
    # degraded view, every step's release one launch
    reset_counts()
    outage = CarbonDataOutage(**CHAOS_OUTAGE)
    t = time.perf_counter()
    dres = run(Scenario(dag=DagConfig(), ci_outage=outage, engine="scan", **DAG),
               DEFAULT_DAG_POLICIES)
    torch.cuda.synchronize()
    dwall = time.perf_counter() - t
    dlaunch, dstats = gating.launches["dep_release"], dict(scan_engine.stats)
    dcpu_weekly, dcpu_wall = twin["dag"]["weekly"], twin["dag"]["wall_s"]
    weeks, slots = same_results(dres.weekly, dcpu_weekly, DEFAULT_DAG_POLICIES)
    resil = [(a.resilience, b.resilience) for n in DEFAULT_DAG_POLICIES
             for a, b in zip(dres.weekly[n], dcpu_weekly[n])]
    log(f"dag path under the outage: card {dwall:.3f} s ({dstats['steps']} slot steps, "
        f"{1e3 * dstats['loop_s'] / max(dstats['steps'], 1):.6f} ms per step), CPU vector "
        f"engine {dcpu_wall:.3f} s: {weeks} weekly results and {slots} slots differ; "
        f"release launches {dlaunch}; degraded slots "
        f"{[a.degraded_slots for a, _ in resil]}")
    log(dres.table())
    if weeks or slots or any(a != b or a is None or a.degraded_slots <= 0
                             for a, b in resil):
        raise AssertionError(f"dag outage: {weeks} weeks, {slots} slots differ; {resil}")
    if not (dlaunch == dstats["dag_steps"] == dstats["steps"] > 0
            and dstats["delegated"] == dstats["fault_delegated"] == 0):
        raise AssertionError(f"dag outage: {dlaunch} release launches for {dstats}")

    # the golden serving grid: host numpy, through the card's Sweep
    with open(os.path.join(GOLDEN, "golden_sweep_serving.json")) as f:
        want = f.read()
    t = time.perf_counter()
    got = Sweep(base=Scenario(serving=ServingConfig(requests_per_day=2e5, servers=12),
                              learn_weeks=1, eval_weeks=1, seed=101),
                seeds=[11, 12], policies=list(DEFAULT_SERVE_POLICIES),
                device="cuda").run().to_json() + "\n"
    serve_wall = time.perf_counter() - t
    if got != want:
        raise AssertionError("golden_sweep_serving: differs from the fixture")
    log(f"golden_sweep_serving through the card's Sweep: byte for byte the fixture "
        f"({serve_wall:.3f} s)")
    return dict(
        chaos=dict(cells=len(card.rows()), card=tc, cpu=tcpu, by_kind=kinds,
                   launches=counts, summary=card.summary()),
        geo=dict(cells=len(gcard.rows()), card=tgc, cpu=tgcpu, by_kind=gkinds,
                 launches=glaunch, stats=gstats, summary=gcard.summary()),
        dag=dict(wall_s=dwall, cpu_wall_s=dcpu_wall, launches=dlaunch, stats=dstats,
                 degraded_slots=[a.degraded_slots for a, _ in resil],
                 savings={n: dres.savings(n) for n in DEFAULT_DAG_POLICIES}),
        serving_golden_s=serve_wall, tables_ms=outage_tables())


# --- telemetry: decision traces, attribution and phase profiles -----------------

GAP_BASE = dict(capacity=40, learn_weeks=1, eval_weeks=1, seed=1)


def recording():
    return Telemetry(recorder=MemoryRecorder(), profiler=PhaseProfiler())


def by_run(tel):
    """The recorded events per run label, in emission order.  The scan
    engine runs a grid's delegated cells before its batched tiles, so the
    order across labels is the engine's; within a label it is the run's."""
    out = {}
    for e in tel.recorder.events:
        out.setdefault(e.run, []).append(e)
    return out


def same_streams(what, card, cpu):
    """Gate: the card's and the CPU's events equal, event for event."""
    a, b = by_run(card), by_run(cpu)
    if a != b:
        bad = sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
        first = next((i for i, (x, y) in enumerate(zip(a.get(bad[0], []),
                                                         b.get(bad[0], [])))
                      if x != y), None)
        raise AssertionError(f"{what}: the event streams differ in {len(bad)} runs, "
                             f"first {bad[0]!r} at event {first}")
    if not a:
        raise AssertionError(f"{what}: no event recorded")


def same_attributions(what, card, cpu):
    """Gate: attributions equal field for field (``check()`` runs inside
    ``attributions()`` and here)."""
    for a in card:
        a.check()
    if [a.to_dict() for a in card] != [b.to_dict() for b in cpu] or not card:
        raise AssertionError(f"{what}: attributions differ between the card and the CPU")


def week_attributions(res, baseline):
    """Each evaluated week of each policy against the baseline's week."""
    return [attribute(r, b) for n in res.policies if n != baseline
            for r, b in zip(res.weekly[n], res.weekly[baseline], strict=True)]


class RecordedGap(OracleGap):
    """``OracleGap`` whose sweep carries a recorder (the harness takes no
    telemetry of its own, in either package)."""

    def __init__(self, telemetry, **kw):
        super().__init__(**kw)
        self.telemetry = telemetry

    def sweep(self):
        return dataclasses.replace(super().sweep(), telemetry=self.telemetry)


def recorded_path(what, card_fn, cpu_fn):
    """Run a path on the card and on the CPU, each with a fresh recorder;
    gate the streams and the card's launches; returns both results, the
    card's telemetry and the path's entry (walls, events, launches,
    provisioning calls, phase summaries)."""
    calls = [0]

    def counted(*args, **kw):
        calls[0] += 1
        return provision(*args, **kw)

    reset_counts()
    policy_mod.provision = counted
    tel = recording()
    try:
        t = time.perf_counter()
        card = card_fn(tel)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        policy_mod.provision = provision
    counts = dict(knn=knn.launches["knn_topk"], greedy=oracle_greedy.launches["greedy_pass"],
                  fill=fill.launches["capacity_fill"], release=gating.launches["dep_release"],
                  geo=geo_walk.launches["geo_walk"], stats=dict(scan_engine.stats),
                  passes=oracle_mod.stats["device_passes"], provision_calls=calls[0])
    for mod, total in ((fill, "capacity_fill"), (geo_walk, "geo_walk")):
        if mod.launches[total]:
            all_compact(f"{what} ({total})", mod.launches, total)
    cpu_tel = recording()
    t = time.perf_counter()
    cpu = cpu_fn(cpu_tel)
    cpu_wall = time.perf_counter() - t
    same_streams(what, tel, cpu_tel)
    if counts["knn"] != counts["provision_calls"]:
        raise AssertionError(f"{what}: {counts['knn']} knn launches for "
                             f"{counts['provision_calls']} provisioning calls")
    if counts["greedy"] != counts["passes"]:
        raise AssertionError(f"{what}: {counts['greedy']} greedy launches for "
                             f"{counts['passes']} device passes")
    st = counts["stats"]
    if not (counts["fill"] == st["fill_steps"] and counts["release"] == st["dag_steps"]
            and counts["geo"] == st["geo_steps"]):
        raise AssertionError(f"{what}: launches {counts} against the loop's steps")
    log(f"telemetry {what}: card {wall:.3f} s, CPU {cpu_wall:.3f} s; events "
        f"{tel.recorder.counts()} in {len(by_run(tel))} runs, card == CPU; launches "
        f"knn {counts['knn']} (== provisioning calls), greedy {counts['greedy']} "
        f"(== device passes), fill {counts['fill']} (== fill steps), release "
        f"{counts['release']} (== DAG steps), geo_walk {counts['geo']} (== geo steps); "
        f"delegated {st['delegated']}, fault_delegated {st['fault_delegated']}, "
        f"telemetry_delegated {st['telemetry_delegated']}")
    for line in tel.profiler.table().splitlines():
        log(f"  card {line}")
    for line in cpu_tel.profiler.table().splitlines():
        log(f"  CPU  {line}")
    entry = dict(wall_s=wall, cpu_wall_s=cpu_wall, events=tel.recorder.counts(),
                 runs=len(by_run(tel)), launches=counts,
                 phases=tel.profiler.summary(), cpu_phases=cpu_tel.profiler.summary())
    return card, cpu, tel, entry


def telemetry_phase():
    """Phase 10: every path with a recorder and a phase profiler, on the card's
    scan engine and on the CPU's vector engine: the event streams equal event
    for event, the results equal the recorder-off runs of the earlier phases,
    the attributions equal, the kernels' launches gated against their steps."""
    t_phase = time.perf_counter()
    out = {}

    # chaos-full: forecast reads on the outage tiles, fault events on the
    # delegated cells; the recorded carbonflex-scale cells leave the loop
    card, cpu, tel, out["chaos"] = recorded_path(
        "chaos-full", lambda tel: chaos_full("cuda", "scan", "device", tel)[0],
        lambda tel: chaos_full("cpu", "vector", "numpy", tel)[0])
    st = out["chaos"]["launches"]["stats"]
    if card.to_json() != RECORDER_OFF["chaos-full"] or cpu.to_json() != card.to_json():
        raise AssertionError("chaos-full: the recorded JSON differs from the recorder-off run")
    if not (st["telemetry_delegated"] == len(CHAOS_SEEDS) and st["delegated"] == len(CHAOS_SEEDS)
            and out["chaos"]["launches"]["fill"] == 0 and out["chaos"]["launches"]["greedy"] > 0
            and out["chaos"]["launches"]["knn"] > 0):
        raise AssertionError(f"chaos-full: {out['chaos']['launches']}")
    kinds = tel.recorder.counts()
    if not {"forecast-read", "evict", "preempt", "restore", "checkpoint", "scale",
            "suspend", "resume"} <= set(kinds):
        raise AssertionError(f"chaos-full: event kinds {kinds}")
    same_attributions("chaos-full", card.attributions(), cpu.attributions())

    # geo-full: migrations decoded from the geo loop's region and mig_now grids
    card, cpu, tel, out["geo"] = recorded_path(
        "geo-full", lambda tel: geo_full("cuda", "scan", telemetry=tel)[0],
        lambda tel: geo_full("cpu", "vector", telemetry=tel)[0])
    if card.to_json() != RECORDER_OFF["geo-full"] or cpu.to_json() != card.to_json():
        raise AssertionError("geo-full: the recorded JSON differs from the recorder-off run")
    migrations = sum(r["migrations"] for r in card.rows())
    if not (out["geo"]["launches"]["geo"] > 0
            and tel.recorder.counts().get("migrate") == migrations > 0):
        raise AssertionError(f"geo-full: {tel.recorder.counts()}, {migrations} migrations")
    same_attributions("geo-full", card.attributions(), cpu.attributions())

    # the DAG path's week: admissions on release
    dag_scenario = dict(dag=DagConfig(), **DAG)
    card, cpu, tel, out["dag"] = recorded_path(
        "dag path", lambda tel: run(Scenario(engine="scan", **dag_scenario),
                                    DEFAULT_DAG_POLICIES, telemetry=tel),
        lambda tel: run(Scenario(engine="vector", **dag_scenario), DEFAULT_DAG_POLICIES,
                        device="cpu", telemetry=tel))
    if same_results(card.weekly, RECORDER_OFF["dag"].weekly, DEFAULT_DAG_POLICIES) != (0, 0):
        raise AssertionError("dag path: the recorded run differs from the recorder-off run")
    if not out["dag"]["launches"]["release"] >= 168 * len(DEFAULT_DAG_POLICIES):
        raise AssertionError(f"dag path: {out['dag']['launches']}")
    mat = Scenario(**dag_scenario).materialize()
    # rows sort by (arrival, job_id): the decode's suspend order is the
    # tracker's job-id order whatever this count, which says whether the two
    # orders part on this week
    out["dag"]["ids_out_of_order"] = int((np.diff(pack(mat.eval_jobs).job_ids) < 0).sum())
    arrival = {j.job_id: max(j.arrival, mat.t0) for j in mat.eval_jobs}
    released = sum(e.t > arrival[e.job] for e in tel.recorder.by_kind("admit"))
    if not released:
        raise AssertionError("dag path: no admission on release")
    out["dag"]["admitted_on_release"] = released
    same_attributions("dag path", week_attributions(card, "dag-fcfs"),
                      week_attributions(cpu, "dag-fcfs"))

    # the main path through run(): the policy/week labels and the four phases
    card, cpu, tel, out["main"] = recorded_path(
        "main path", lambda tel: run(Scenario(**MAIN), POLICIES, telemetry=tel),
        lambda tel: run(Scenario(**MAIN), POLICIES, device="cpu", telemetry=tel))
    if same_results(card.weekly, RECORDER_OFF["main"].weekly, POLICIES) != (0, 0):
        raise AssertionError("main path: the recorded run differs from the recorder-off run")
    labels = {f"{n}/w{w}" for n in POLICIES for w in range(MAIN["eval_weeks"])}
    if set(by_run(tel)) != labels or set(tel.profiler.seconds) != {
            "provision", "learn", "decide", "execute"}:
        raise AssertionError(f"main path: labels {sorted(by_run(tel))}, phases "
                             f"{tel.profiler.seconds}")
    if not out["main"]["launches"]["knn"] > 0:
        raise AssertionError("main path: no lookup on the card")
    same_attributions("main path", week_attributions(card, "carbon-agnostic"),
                      week_attributions(cpu, "carbon-agnostic"))

    # the golden serving grid: tier switches
    with open(os.path.join(GOLDEN, "golden_sweep_serving.json")) as f:
        want = f.read()

    def serving(device, tel):
        return Sweep(base=Scenario(serving=ServingConfig(requests_per_day=2e5, servers=12),
                                   learn_weeks=1, eval_weeks=1, seed=101),
                     seeds=[11, 12], policies=list(DEFAULT_SERVE_POLICIES),
                     telemetry=tel, device=device).run()

    card, cpu, tel, out["serving"] = recorded_path(
        "golden serving grid", lambda tel: serving("cuda", tel),
        lambda tel: serving("cpu", tel))
    if card.to_json() + "\n" != want or cpu.to_json() + "\n" != want:
        raise AssertionError("golden_sweep_serving: the recorded JSON differs from the fixture")
    if not tel.recorder.counts().get("tier-switch"):
        raise AssertionError("golden serving grid: no tier switch")
    same_attributions("golden serving grid", card.attributions(), cpu.attributions())

    # the oracle-gap harness: scan on the card against vector on the CPU
    def gap(device, engine, tel):
        return RecordedGap(tel, base=Scenario(**GAP_BASE), seeds=(1,),
                           forecasts=sigma_ladder((0.0, 0.2)), engine=engine,
                           device=device).run()

    card, cpu, tel, out["oracle_gap"] = recorded_path(
        "oracle gap", lambda tel: gap("cuda", "scan", tel),
        lambda tel: gap("cpu", "vector", tel))
    if card.to_json() != cpu.to_json():
        raise AssertionError("oracle gap: the card's JSON differs from the CPU's")
    st = out["oracle_gap"]["launches"]["stats"]
    n_scale = sum(r["policy"] == "carbonflex-scale" for r in card.rows())
    if not (st["telemetry_delegated"] == n_scale > 0 and st["steps"] > 0
            and out["oracle_gap"]["launches"]["fill"] == 0):
        raise AssertionError(f"oracle gap: {out['oracle_gap']['launches']}")
    out["oracle_gap"].update(cells=out["oracle_gap"]["runs"],
                             perfect_gap={p: card.perfect_gap(p) for p in card.policies()})
    log(card.table())
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"telemetry phase: {out['wall_s']:.3f} s")
    return out



# --- the MPC knob tuner ---------------------------------------------------------

# The reference script's full settings: both seeds, capacity 40, 2 learning
# weeks, the 18-cell (carbonflex-mpc) and 54-cell (carbonflex-scale) grids.
TUNE_RUNS = [("carbonflex-mpc", False, 1), ("carbonflex-mpc", False, 3),
             ("carbonflex-scale", True, 1), ("carbonflex-scale", True, 3)]


def tuned(device, engine, policy, scale, seed):
    """``tune_policy.tune`` at the full settings with its cases on ``engine``:
    (gaps, printed lines, provisioning calls of the carbonflex cell, wall
    seconds)."""
    import contextlib
    import io

    simulate, results = tune_policy.simulate_many, []

    def kept(cases):
        cases = [dataclasses.replace(c, engine=engine) for c in cases]
        out = simulate(cases)
        results.extend(zip((c.label for c in cases), out))
        return out

    buf = io.StringIO()
    tune_policy.simulate_many = kept
    try:
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            gaps = tune_policy.tune(policy, seed=seed, scale=scale, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        tune_policy.simulate_many = simulate
    flex = sum(len(r.slots) for label, r in results if label == "carbonflex")
    return gaps, buf.getvalue(), flex, wall


def tune_phase(twins=None):
    """The tuner (``python -m repro_torch.experiment.tune_policy`` and its
    ``--scale``) on the card's scan engine against the port's vector engine
    on the CPU (the CPU twin's runs, ``tune_cpu``): gap dicts float for
    float, printed lines equal; launches read per run."""
    out, t0 = {}, time.perf_counter()
    cpu_runs = twin_result(twins, "tune")
    for policy, scale, seed in TUNE_RUNS:
        reset_counts()
        gaps, lines, flex, wall = tuned("cuda", "scan", policy, scale, seed)
        counts = dict(knn=knn.launches["knn_topk"], fill=fill.launches["capacity_fill"],
                      routes=dict(fill.launches), stats=dict(scan_engine.stats))
        cpu_gaps, cpu_lines, cpu_flex, cpu_wall = cpu_runs[policy, scale, seed]
        stats = counts["stats"]
        name = f"{policy}/seed={seed}"
        log(f"tune {name}: {len(gaps)} rows, card scan engine {wall:.3f} s, CPU vector "
            f"engine {cpu_wall:.3f} s; gaps equal {gaps == cpu_gaps}, printed lines equal "
            f"{lines == cpu_lines}; knn_topk {counts['knn']} (carbonflex provisioning calls "
            f"{flex}), capacity_fill {counts['fill']} (fill steps {stats['fill_steps']}), "
            f"delegated {stats['delegated']}, {stats['steps']} batched steps")
        log(lines.splitlines()[0] + " ... " + lines.splitlines()[-1].strip())
        if gaps != cpu_gaps or list(gaps) != list(cpu_gaps) or lines != cpu_lines:
            diff = [k for k in gaps if gaps[k] != cpu_gaps.get(k)]
            raise AssertionError(f"tune {name}: the card and the CPU differ in {diff}")
        if len(gaps) != len(tune_policy.REFS) + (54 if scale else 18):
            raise AssertionError(f"tune {name}: {len(gaps)} rows")
        if not (counts["knn"] == flex == cpu_flex > 0):
            raise AssertionError(f"tune {name}: {counts['knn']} knn launches for {flex} "
                                 f"carbonflex provisioning calls (CPU {cpu_flex})")
        if counts["fill"] != stats["fill_steps"] or (stats["fill_steps"] > 0) != scale:
            raise AssertionError(f"tune {name}: {counts['fill']} fill launches for "
                                 f"{stats['fill_steps']} fill steps")
        if scale:
            all_compact(f"tune {name}", counts["routes"], "capacity_fill")
        if stats["delegated"] != 2:
            raise AssertionError(f"tune {name}: {stats['delegated']} cells delegated, not "
                                 "the carbonflex and oracle rows")
        best = min((k for k in gaps if k not in tune_policy.REFS), key=gaps.get)
        out[name] = dict(card_s=wall, cpu_s=cpu_wall, rows=len(gaps), knn_launches=counts["knn"],
                         fill_launches=counts["fill"], fill_steps=stats["fill_steps"],
                         delegated=stats["delegated"], steps=stats["steps"],
                         cell_steps=stats["cell_steps"], best=best, best_gap=gaps[best],
                         carbonflex_gap=gaps["carbonflex"])
    return dict(runs=out, wall_s=time.perf_counter() - t0)


# The dry-run's cells counted in this many processes (host CPU only: meta
# tensors), and the cells the "tpu" world reads.
# --- the examples -------------------------------------------------------------

# The eight batch examples at the reference's CI settings, on the card; each
# is held against the same example on the CPU (a CPU twin, run beside the
# earlier phases).
EXAMPLE_ARGS = {"quickstart": ["--tiny"], "cluster_sim_year": ["--weeks", "1", "--capacity", "10"],
                "dag_quickstart": ["--tiny"], "geo_quickstart": ["--tiny"],
                "forecast_quickstart": ["--tiny"], "resilience_quickstart": ["--tiny"],
                "serving_quickstart": ["--tiny"], "telemetry_quickstart": ["--tiny"]}
# telemetry's phase table: a phase, its wall seconds, share and brackets
EXAMPLE_WALL_LINE = re.compile(r"^\s+(learn|provision|decide|execute)\s+[\d.]+\s+[\d.]+%")
# serve_elastic at its defaults; train_carbon_aware's 100m preset on the card
# in this process, and its tiny preset on the two shard ranks with a fault
# (the step after an asynchronous save: the rollback re-takes one step)
EXAMPLE_SERVE_ARGS = []
EXAMPLE_100M_ARGS = ["--preset", "100m", "--max-dp", "1"]
EXAMPLE_TINY_FAULT = 6


def example_module(name):
    from importlib import import_module

    return import_module(f"repro_torch.examples.{name}")


def example_lines(text):
    """An example's printed lines, less the ones that carry wall time."""
    return [ln for ln in text.splitlines() if not EXAMPLE_WALL_LINE.match(ln)]


def example_figures(name, res):
    """What an example's study returned, as plain data to compare: a
    ``run()``'s table and metrics, a sweep's JSON, the dag stretches,
    telemetry's attributions, the oracle gap's JSON and curves."""
    if name in ("quickstart", "cluster_sim_year", "serving_quickstart"):
        return dict(table=res.table(), metrics=res.metrics(), kb_size=res.kb_size)
    if name == "dag_quickstart":
        return dict(sweep=res["sweep"].to_json(), twin=res["twin"].to_json(),
                    stretch=res["stretch"])
    if name == "resilience_quickstart":
        return dict(faults=res["faults"].to_json(), outage=res["outage"].to_json())
    if name == "telemetry_quickstart":
        sw = res["sweep"]
        return dict(sweep=sw.to_json(), attributions=[dataclasses.asdict(a)
                                                      for a in sw.attributions()],
                    events=res["telemetry"].recorder.counts(run=res["label"]))
    if name == "forecast_quickstart":
        return dict(json=res.to_json(), curves={p: res.degradation_curve(p)
                                                for p in ("carbonflex", "carbonflex-robust")})
    return dict(json=res.to_json())


def run_example(name, argv):
    """``repro_torch.examples.<name>.main(argv)`` with its stdout kept:
    (printed text, returned study, wall seconds)."""
    import contextlib
    import io

    text = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(text):
        res = example_module(name).main(argv)
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return text.getvalue(), res, time.perf_counter() - t


def examples_cpu():
    """The CPU twins of the examples phase: each batch example and
    serve_elastic with ``--device cpu``."""
    out = {}
    for name, args in EXAMPLE_ARGS.items():
        text, res, wall = run_example(name, args + ["--device", "cpu"])
        out[name] = dict(lines=example_lines(text), figures=example_figures(name, res),
                         wall_s=wall)
    text, res, wall = run_example("serve_elastic", EXAMPLE_SERVE_ARGS + ["--device", "cpu"])
    out["serve_elastic"] = dict(tokens=res["tokens"], lines=text.splitlines(), wall_s=wall)
    return out


def example_plan(argv):
    """The elastic plan ``train_carbon_aware`` computes for ``argv``, on the
    host: (k per hour, steps the plan implies, rescales it implies)."""
    tca = example_module("train_carbon_aware")
    plan, _ = tca.elastic_plan(tca.parser().parse_args(argv))
    ks = [p.k for p in plan]
    live = [k for k in ks if k]
    return ks, sum(p.steps for p in plan if p.k), sum(a != b for a, b in zip(live, live[1:]))


def train_launch_counts(dtype, d, layers, steps):
    """``gqa_flash``'s launches for ``steps`` train steps of a model of
    ``layers`` layers whose attention runs in ``dtype`` at head dim ``d``:
    two forwards a layer (the sublayer recompute) on its route and one
    backward on the backward route that pairs with it; on the Hopper route
    at a head dim off a multiple of 8, seven staged copies a layer (q, k, v
    in each forward, dO in the backward, which reads the recompute's staged
    q, k, v)."""
    route, bwd = fa.route(dtype, d), fa.BWD_ROUTE_KERNELS[fa.bwd_route(dtype, d)]
    want = dict.fromkeys(fa.launches, 0)
    want.update(gqa_flash=2 * layers * steps, gqa_flash_bwd=layers * steps,
                **{route: 2 * layers * steps}, **{k: layers * steps for k in bwd})
    if route == "wgmma" and fa.tma_width(d) != d:
        want["layout_copy"] = 7 * layers * steps
    return want


def examples_phase(twins=None):
    """The ten examples on the card.  The eight batch examples at their CI
    settings: printed lines (less telemetry's wall seconds) and returned
    studies equal to the same example on the CPU, knn launches ==
    provisioning calls and every other kernel's launches == its loop's steps.
    serve_elastic at its defaults: one fp32 ``gqa_flash`` launch a layer in
    prefill, none in decode, ids in range, finite logits; the greedy tokens
    beside the CPU run's (printed: fp32 near-ties may flip).
    train_carbon_aware --preset 100m --max-dp 1: the plan the host computes,
    its steps and rescales, no recovery, finite losses, the wgmma forward
    and backward launches its steps imply.  (Its tiny preset runs on the
    shard ranks: ``shard_tiny``.)"""
    import tempfile

    t_phase = time.perf_counter()
    cpu = twin_result(twins, "examples")
    out = {}
    calls = [0]

    def counted(*args, **kw):
        calls[0] += 1
        return provision(*args, **kw)

    for name, args in EXAMPLE_ARGS.items():
        reset_counts()
        calls[0] = 0
        policy_mod.provision = counted
        try:
            text, res, wall = run_example(name, args + ["--device", "cuda"])
        finally:
            policy_mod.provision = provision
        st = dict(scan_engine.stats)
        counts = dict(knn=knn.launches["knn_topk"], provisions=calls[0],
                      greedy=oracle_greedy.launches["greedy_pass"],
                      passes=oracle_mod.stats["device_passes"],
                      fill=fill.launches["capacity_fill"], fill_steps=st["fill_steps"],
                      release=gating.launches["dep_release"], dag_steps=st["dag_steps"],
                      geo=geo_walk.launches["geo_walk"], geo_steps=st["geo_steps"],
                      steps=st["steps"])
        lines, want = example_lines(text), cpu[name]
        same_lines = lines == want["lines"]
        same_figures = example_figures(name, res) == want["figures"]
        log(f"example {name} {' '.join(args)}: card {wall:.3f} s, CPU {want['wall_s']:.3f} s; "
            f"printed lines equal {same_lines} ({len(lines)}), studies equal {same_figures}; "
            f"launches {counts}")
        if not (same_lines and same_figures):
            diff = [(a, b) for a, b in zip(lines, want["lines"]) if a != b][:5]
            raise AssertionError(f"example {name}: the card's study differs from the CPU's: "
                                 f"{diff or (len(lines), len(want['lines']))}")
        if not (counts["knn"] == counts["provisions"] and counts["greedy"] == counts["passes"]
                and counts["fill"] == counts["fill_steps"]
                and counts["release"] == counts["dag_steps"]
                and counts["geo"] == counts["geo_steps"]):
            raise AssertionError(f"example {name}: launches {counts}")
        for mod, total in ((fill, "capacity_fill"), (geo_walk, "geo_walk")):
            if mod.launches[total]:
                all_compact(f"example {name} ({total})", mod.launches, total)
        out[name] = dict(wall_s=wall, cpu_wall_s=want["wall_s"], launches=counts)
    if not out["forecast_quickstart"]["launches"]["steps"] > 0:
        raise AssertionError("forecast_quickstart ran no step of the card's slot loop")

    # serve_elastic: reduced llama3-8b (fp32, D 32) on the (1, 1) mesh
    fa.reset_launches()
    text, res, wall = run_example("serve_elastic", EXAMPLE_SERVE_ARGS + ["--device", "cuda"])
    launches = dict(fa.launches)
    cfg = res["cfg"]
    want = dict.fromkeys(fa.launches, 0)
    want.update(gqa_flash=cfg.num_layers, fp32=cfg.num_layers)
    toks, cpu_toks = res["tokens"], cpu["serve_elastic"]["tokens"]
    differ = int((toks != cpu_toks).sum())
    finite = bool(torch.isfinite(res["prefill_logits"]).all()
                  and torch.isfinite(res["last_logits"]).all())
    log(f"example serve_elastic: card {wall:.3f} s; {text.strip()}; launches "
        f"{ {k: v for k, v in launches.items() if v} }, in prefill "
        f"{res['prefill_flash_launches']}, in decode {res['decode_flash_launches']}; greedy "
        f"tokens against the CPU run's: "
        f"{differ} of {toks.size} positions differ (information: fp32 near-ties may flip); "
        f"CPU run: {cpu['serve_elastic']['lines']}")
    if launches != want or res["prefill_flash_launches"] != cfg.num_layers \
            or res["decode_flash_launches"] or not finite or toks.shape != cpu_toks.shape \
            or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"serve_elastic: launches {launches} (expected {want}), in "
                             f"prefill {res['prefill_flash_launches']}, in decode "
                             f"{res['decode_flash_launches']}, finite {finite}, tokens "
                             f"{toks.shape}")
    out["serve_elastic"] = dict(wall_s=wall, prefill_s=res["prefill_s"],
                                decode_s=res["decode_s"], launches=launches,
                                tokens_differ=differ, tokens=int(toks.size))

    # train_carbon_aware --preset 100m --max-dp 1 in this process
    with tempfile.TemporaryDirectory(prefix="example_100m_") as tmp:
        argv = EXAMPLE_100M_ARGS + ["--device", "cuda", "--ckpt", tmp]
        fa.reset_launches()
        text, res, wall = run_example("train_carbon_aware", argv)
        launches = dict(fa.launches)
    ks, steps, rescales = example_plan(argv)
    tca = example_module("train_carbon_aware")
    cfg = tca.PRESETS[argv[argv.index("--preset") + 1]]
    route = fa.route(cfg.compute_dtype, cfg.resolved_head_dim)
    want = train_launch_counts(cfg.compute_dtype, cfg.resolved_head_dim, cfg.num_layers,
                               len(res["losses"]))
    log(f"example train_carbon_aware {' '.join(EXAMPLE_100M_ARGS)}: {wall:.3f} s; "
        f"{text.strip()}; launches {launches}; losses {res['losses']}")
    if not (res["plan"] == ks and res["final_step"] == steps == len(res["losses"])
            and res["rescales"] == rescales and res["recoveries"] == 0
            and all(map(math.isfinite, res["losses"])) and launches == want
            and launches[route] > 0):
        raise AssertionError(f"train_carbon_aware 100m: plan {res['plan']} (host {ks}), "
                             f"{res['final_step']} steps ({steps}), {res['rescales']} "
                             f"rescales ({rescales}), {res['recoveries']} recoveries, "
                             f"launches {launches} (expected {want})")
    out["train_100m"] = dict(wall_s=wall, plan=res["plan"], final_step=res["final_step"],
                             losses=res["losses"], launches=launches, params=res["params"])
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"examples phase: {out['wall_s']:.3f} s")
    return out


DRYRUN_WORKERS = min(8, os.cpu_count() or 1)
DRYRUN_REQUIRED = [(arch, "train_4k") for arch in workloads.TPU_ARCHS] + [
    ("llama3-8b", "prefill_32k"), ("llama3-8b", "decode_32k"), ("zamba2-7b", "long_500k")]


def dryrun_phase(train):
    """Phase 12 in a temporary working directory, removed after it (see
    ``dryrun_in``)."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="dryrun_phase_") as tmp:
        return dryrun_in(train, tmp)


def dryrun_in(train, tmp):
    """Phase 13: the dry-run (``repro_torch.launch.dryrun``) counts every
    live (arch x shape) cell's step on the ``meta`` device in
    ``DRYRUN_WORKERS`` processes into a temporary ``results/dryrun_opt``, each
    cell's roofline terms and profile printed; the count of internvl2-2b at
    ``train_phase``'s shape (one device) against the step ``train_phase``
    measured; then ``Scenario(**MAIN, elasticity="tpu")`` run from that
    directory on the card and on the CPU: the LM-training jobs' profiles from
    the counted cells, equal results, knn launches == provisioning calls,
    every job one of the ten architectures."""
    import collections

    from repro_torch.core.profiles import elasticity_of, profile_from_dryrun
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    from repro_torch.models import SHAPES, ShapeConfig

    t0 = time.perf_counter()
    cells = [(a, s) for a in ARCHS for s in SHAPES if dryrun.runnable(a, SHAPES[s])]
    if not set(DRYRUN_REQUIRED) <= set(cells) or len(cells) != 32:
        raise AssertionError(f"dry-run: {len(cells)} live cells")
    out = {}
    cell_dir = os.path.join(tmp, "results", "dryrun_opt")
    os.makedirs(cell_dir)
    t = time.perf_counter()
    mesh = make_production_mesh()
    counted = dryrun.count_cells([(ARCHS[a], SHAPES[s]) for a, s in cells],
                                 workers=DRYRUN_WORKERS, mesh=mesh)
    count_wall = time.perf_counter() - t
    for (arch, shape), (stats, secs) in zip(cells, counted):
        rec = dryrun.cell_record(arch, ARCHS[arch], SHAPES[shape], mesh, stats, secs)
        with open(dryrun.cell_path(cell_dir, arch, shape, rec["mesh"]), "w") as f:
            json.dump(rec, f, indent=1)
        r = rec["roofline"]
        prof = profile_from_dryrun(arch, dryrun_dir=cell_dir, shape=shape)
        per_dev, coll = rec["hlo_stats"], rec["collectives"]
        if not (per_dev["flops"] > 0 and per_dev["hbm_bytes"] > 0
                and coll["payload_bytes"] > 0 and coll["count"] > 0
                and all(math.isfinite(r[k]) for k in ("compute_s", "memory_s", "collective_s"))):
            raise AssertionError(f"dry-run {arch} x {shape}: counts {per_dev}, collectives "
                                 f"{coll}, terms {r}")
        # the analytic data-parallel term the cells carried before the
        # sharded count: bf16 gradients, each device's 1/16, ring factor 2
        analytic_s = 2.0 * (2.0 * ARCHS[arch].param_count() / 16) / dryrun.LINK_BW
        out[f"{arch}__{shape}"] = dict(
            flops_per_dev=per_dev["flops"], bytes_per_dev=per_dev["hbm_bytes"],
            compute_s=r["compute_s"], memory_s=r["memory_s"], collective_s=r["collective_s"],
            dominant=r["dominant"], useful_flops_ratio=r["useful_flops_ratio"],
            payload_bytes=coll["payload_bytes"], wire_bytes=coll["wire_bytes"],
            collectives=coll["count"], by_type=coll["by_type"],
            analytic_dp_s=analytic_s if shape == "train_4k" else None,
            elasticity=elasticity_of(prof), ops=stats.ops, count_s=secs)
        log(f"dry-run {arch} x {shape}: {per_dev['flops']:.6e} FLOPs and "
            f"{per_dev['hbm_bytes']:.6e} bytes per device (rank 0 of 256), "
            f"{coll['count']} collectives, {coll['payload_bytes']:.6e} bytes of payload "
            f"{coll['by_type']}; compute {r['compute_s']:.6e} s, memory {r['memory_s']:.6e} "
            f"s, collective {r['collective_s']:.6e} s -> {r['dominant']}"
            + (f" (the analytic DP all-reduce's term {analytic_s:.6e} s)"
               if shape == "train_4k" else "")
            + f"; elasticity {elasticity_of(prof):.6f}; {stats.ops} ops counted in "
            f"{secs:.3f} s")
    log(f"dry-run: {len(cells)} cells counted in {count_wall:.3f} s wall on "
        f"{DRYRUN_WORKERS} processes ({sum(s for _, s in counted):.3f} s of counting)")

    # The count against the card: internvl2-2b at train_phase's shape on one
    # device, as the card ran it (flash kernels) and as the cells count it
    # (the chunked attention), against the step train_phase measured.
    cfg = ARCHS[TRAIN_ARCH]
    shape = ShapeConfig("train_step", TRAIN_SEQ + cfg.prefix_len, TRAIN_BATCH, "train")
    one = make_mesh((1,), ("data",))
    model = train_model_flops(cfg, TRAIN_BATCH, shape.seq_len)
    anchor = {}
    for attention in ("flash", "chunked"):
        t = time.perf_counter()
        stats = dryrun.count_cell(cfg, shape, attention=attention)
        rec = dryrun.cell_record(TRAIN_ARCH, cfg, shape, one, stats, time.perf_counter() - t)
        r = rec["roofline"]
        roof = max(r["compute_s"], r["memory_s"])
        anchor[attention] = dict(flops=stats.flops, bytes=stats.bytes,
                                 compute_s=r["compute_s"], memory_s=r["memory_s"],
                                 roofline_s=roof, measured_over_roofline=train["step_s"] / roof,
                                 count_s=rec["count_s"])
        log(f"dry-run anchor ({attention} attention): {TRAIN_ARCH} at {TRAIN_BATCH} x "
            f"{shape.seq_len}, one device: {stats.flops:.6e} FLOPs (model FLOPs "
            f"{model:.6e}), {stats.bytes:.6e} bytes; compute {r['compute_s']:.6f} s, memory "
            f"{r['memory_s']:.6f} s; the measured step {train['step_s']:.6f} s is "
            f"{train['step_s'] / roof:.6f} x the roofline")
        if stats.flops < model:
            raise AssertionError(f"dry-run anchor ({attention}): {stats.flops} counted FLOPs "
                                 f"below the step's {model} model FLOPs")
    if not anchor["flash"]["roofline_s"] <= train["step_s"]:
        raise AssertionError(f"dry-run anchor: the count says the card beat its peaks "
                             f"({anchor['flash']['roofline_s']} s of roofline against a "
                             f"measured {train['step_s']} s step)")

    # The "tpu" world from the counted cells, on the card and on the CPU.
    workloads._TPU_PROFILE_CACHE.clear()
    calls = [0]

    def counted_provision(*args, **kw):
        calls[0] += 1
        return provision(*args, **kw)

    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        sc = Scenario(**MAIN, elasticity="tpu")
        mat = sc.materialize()
        drawn = collections.Counter(j.arch for j in mat.jobs)
        if not set(drawn) <= set(workloads.TPU_ARCHS):
            raise AssertionError(f"tpu world: jobs fell back to the mix: {drawn}")
        policy_mod.provision = counted_provision
        knn.reset_launches()
        t = time.perf_counter()
        res = run(sc, POLICIES)
        torch.cuda.synchronize()
        card_wall = time.perf_counter() - t
        launches = knn.launches["knn_topk"]
        policy_mod.provision = provision
        t = time.perf_counter()
        cpu_res = run(sc, POLICIES, device="cpu")
        cpu_wall = time.perf_counter() - t
    finally:
        policy_mod.provision = provision
        os.chdir(cwd)
    weeks_differ, slots_differ = same_results(res.weekly, cpu_res.weekly, POLICIES)
    elasticity = {a: elasticity_of(p) for a, p in sorted(workloads._TPU_PROFILE_CACHE.items())}
    savings = {n: res.savings(n) for n in POLICIES}
    log(f"tpu world: {len(mat.jobs)} jobs, archs drawn {dict(sorted(drawn.items()))}; each "
        f"arch's elasticity {elasticity}; card {card_wall:.3f} s, CPU {cpu_wall:.3f} s; "
        f"{weeks_differ} weekly results and {slots_differ} slots differ; knn_topk launches "
        f"{launches}, provisioning calls {calls[0]}; savings {savings}")
    log(res.table())
    if weeks_differ or slots_differ:
        raise AssertionError(f"tpu world: {weeks_differ} weeks and {slots_differ} slots "
                             "differ from the CPU run")
    if not launches == calls[0] > 0:
        raise AssertionError(f"tpu world: {launches} knn launches for {calls[0]} "
                             "provisioning calls")
    return dict(cells=out, count_wall_s=count_wall, workers=DRYRUN_WORKERS, anchor=anchor,
                train_step_s=train["step_s"], model_flops=model,
                world=dict(jobs=len(mat.jobs), drawn=dict(drawn), elasticity=elasticity,
                           card_s=card_wall, cpu_s=cpu_wall, knn_launches=launches,
                           provisions=calls[0], savings=savings,
                           cpu_savings={n: cpu_res.savings(n) for n in POLICIES}),
                wall_s=time.perf_counter() - t0)


# --- the CPU twins --------------------------------------------------------------

# Host-only runs that gated comparisons need, computed in a spawned process
# beside the card's phases, in the order the phases read them: the DAG tile
# on the CPU's vector engine, sweep-full on it with the numpy pass,
# geo-full, the resilience phase's three CPU runs, the tuner's four, the
# examples with --device cpu.  (On an H100 host the first two take ~20 s and
# ~30 s, and geo-full, the resilience runs and the tuner's ~4, ~21 and ~9 s,
# which this process no longer waits for.)  TWIN_WAIT
# bounds a wait for one result.
TWIN_WAIT = 900


def sweep_full_cpu():
    res, timing = sweep_full("cpu", "vector", "numpy")
    return dict(json=res.to_json(), rows=res.rows(), timing=timing)


def geo_full_cpu():
    res, timing = geo_full("cpu", "vector")
    return dict(json=res.to_json(), rows=res.rows(), timing=timing)


def chaos_cpu():
    """The resilience phase's CPU runs: ``chaos-full`` (numpy pass) and
    ``geo-chaos`` on the vector engine, and the DAG week under the outage."""
    chaos, tchaos = chaos_full("cpu", "vector", "numpy")
    geo, tgeo = geo_chaos("cpu", "vector")
    t = time.perf_counter()
    dag = run(Scenario(dag=DagConfig(), ci_outage=CarbonDataOutage(**CHAOS_OUTAGE),
                       engine="vector", **DAG), DEFAULT_DAG_POLICIES, device="cpu")
    return dict(chaos=dict(json=chaos.to_json(), rows=chaos.rows(), timing=tchaos),
                geo=dict(json=geo.to_json(), rows=geo.rows(), timing=tgeo),
                dag=dict(weekly=dag.weekly, wall_s=time.perf_counter() - t))


def tune_cpu():
    """The tuner's runs on the CPU's vector engine, by (policy, scale, seed)."""
    return {(policy, scale, seed): tuned("cpu", "vector", policy, scale, seed)
            for policy, scale, seed in TUNE_RUNS}


TWIN_JOBS = {"tile": tile_cpu, "sweep_full": sweep_full_cpu, "geo_full": geo_full_cpu,
             "chaos": chaos_cpu, "tune": tune_cpu, "examples": examples_cpu}


def cpu_twin(_, root, parent):
    """The twin process: each of TWIN_JOBS in turn, its result pickled to
    ``root/<name>.pkl`` (or its traceback to ``root/<name>.err``)."""
    import pickle
    import traceback

    torch.set_num_threads(2)
    for name, job in TWIN_JOBS.items():
        if os.getppid() != parent:
            return
        try:
            data, suffix = pickle.dumps(job()), ".pkl"
        except Exception:
            data, suffix = traceback.format_exc().encode(), ".err"
        tmp = os.path.join(root, name + ".tmp")
        with open(tmp, "wb") as f:
            f.write(data)
        os.rename(tmp, os.path.join(root, name + suffix))


def start_cpu_twin():
    """Spawn the twin process (``cpu_twin``); returns the handle that
    ``twin_result`` and ``stop_cpu_twin`` take."""
    import tempfile

    import torch.multiprocessing as mp

    root = tempfile.mkdtemp(prefix="cpu_twin_")
    ctx = mp.start_processes(cpu_twin, args=(root, os.getpid()), nprocs=1, join=False,
                             start_method="spawn")
    return dict(ctx=ctx, root=root)


def twin_result(twins, name):
    """The twin's result ``name``, waited for; with no twin process (a phase
    run alone) the job runs here."""
    import pickle

    if twins is None:
        return TWIN_JOBS[name]()
    base = os.path.join(twins["root"], name)
    deadline = time.perf_counter() + TWIN_WAIT
    t = time.perf_counter()
    while not (os.path.exists(base + ".pkl") or os.path.exists(base + ".err")):
        if not twins["ctx"].processes[0].is_alive() or time.perf_counter() > deadline:
            raise AssertionError(f"the CPU twin gave no {name!r} (alive "
                                 f"{twins['ctx'].processes[0].is_alive()})")
        time.sleep(0.05)
    if os.path.exists(base + ".err"):
        with open(base + ".err") as f:
            raise AssertionError(f"the CPU twin's {name!r} failed:\n{f.read()}")
    with open(base + ".pkl", "rb") as f:
        out = pickle.load(f)
    log(f"CPU twin {name!r}: waited {time.perf_counter() - t:.3f} s for it")
    return out


def stop_cpu_twin(twins):
    import shutil

    for proc in twins["ctx"].processes:
        if proc.is_alive():
            proc.kill()
        proc.join()
    shutil.rmtree(twins["root"], ignore_errors=True)


def warm_checkpoint() -> float:
    """Call ``torch.utils.checkpoint`` once on the host and return the
    seconds it took: its first call imports ``torch._dynamo`` (8.5-9.4 s a
    process on the H100 hosts, which keep no bytecode cache), which a
    process's first train step would otherwise pay."""
    t = time.perf_counter()
    torch.utils.checkpoint.checkpoint(torch.neg, torch.ones(1, requires_grad=True),
                                      use_reentrant=False)
    return time.perf_counter() - t


class BuildReports(dict):
    """The compiler's report of each kernel source; a source still building
    is waited for (and its build time and report printed) when its report
    is first read."""

    def __init__(self, pending):
        super().__init__()
        self.pending = pending

    def __missing__(self, src):
        if src not in self.pending:
            raise KeyError(src)
        seconds, report = self.pending.pop(src).result()
        log(f"built {src} in {seconds:.3f} s")
        if report:
            log(report.strip())
        self[src] = report
        return report


# The flash sources build longest (the backward's ~89 s and the forward's
# ~48 s against ~20 s for knn.cu, on H100 hosts): build_kernels waits for
# neither, so the knn phase runs while both build (waiting for the forward's
# held every phase back by its lead over knn.cu's, ~25 s), and the forward
# flash phases while the backward builds.
DEFERRED_BUILDS = ("src/repro_torch/csrc/flash_attention_bwd.cu",
                   "src/repro_torch/csrc/flash_attention.cu")


def build_kernels():
    """Build every kernel source at once (one nvcc each), print each
    build's time and the compiler's report, and return the reports.  The
    host's first call of ``torch.utils.checkpoint`` is made meanwhile
    (``warm_checkpoint``), while this thread only waits.  DEFERRED_BUILDS
    are not waited for here: reading a report waits for it."""
    def timed(build):
        t = time.perf_counter()
        report = build()
        return time.perf_counter() - t, report

    sources = (("src/repro_torch/csrc/knn.cu", knn.build),
               ("src/repro_torch/csrc/flash_attention.cu", fa.build),
               ("src/repro_torch/csrc/flash_attention_bwd.cu", fa.build_bwd),
               ("src/repro_torch/csrc/gating.cu", gating.build),
               ("src/repro_torch/csrc/score.cu", score.build),
               ("src/repro_torch/csrc/oracle_greedy.cu", oracle_greedy.build),
               ("src/repro_torch/csrc/fill.cu", fill.build),
               ("src/repro_torch/csrc/geo_walk.cu", geo_walk.build))
    ex = ThreadPoolExecutor(len(sources) + 1)
    warm = ex.submit(warm_checkpoint)
    reports = BuildReports({src: ex.submit(timed, build) for src, build in sources})
    ex.shutdown(wait=False)
    log(f"warmed torch.utils.checkpoint in {warm.result():.3f} s")
    for src, _ in sources:
        if src not in DEFERRED_BUILDS:
            reports[src]
    return reports


T_START = time.perf_counter()


def main():
    card = card_line()
    log(f"card: {card}")
    reports = build_kernels()
    ranks = start_shard_ranks()
    twins = start_cpu_twin()
    try:
        phases(card, reports, ranks, twins)
    finally:
        stop_cpu_twin(twins)
        stop_shard_ranks(ranks)


def phases(card, reports, shard_ranks, twins):
    """Every phase after the build, in order; the last lines printed."""
    # the card's line, the builds waited for and the spawns, before the
    # first phase (the imports come before T_START)
    walls = {"start": time.perf_counter() - T_START}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t
        return out

    kernels = timed("kernel (knn)", kernel_phase, reports["src/repro_torch/csrc/knn.cu"])
    flash_entry, d112_entry, (d16_entry, d16_yardstick) = timed(
        "kernel (gqa_flash)", flash_kernel_phase,
        reports["src/repro_torch/csrc/flash_attention.cu"])
    kernels.append(flash_entry)
    bwd_entries, (bwd_d16_entries, bwd_mma_entries) = timed(
        "kernel (gqa_flash backward)", flash_bwd_kernel_phase,
        reports["src/repro_torch/csrc/flash_attention_bwd.cu"])
    dims, dims_fwd, dims_bwd = timed("kernel (gqa_flash head dims and dtypes)",
                                     flash_dims_phase, reports)
    kernels.append(timed("kernel (gating)", gating_kernel_phase,
                         reports["src/repro_torch/csrc/gating.cu"]))
    path = timed("main path", main_path_phase)
    kernels[0].update(launches=path["main"]["knn_topk"], path="main")
    kernels[1].update(launches=path["batch"]["knn_topk_batch"], path="batch-replay",
                      launches_by_route={r: path["batch"][r] for r in knn.BATCH_ROUTES})
    serve = timed("serving", serve_phase)
    kernels[2].update(launches=serve["launches"]["wgmma"], path="serve-prefill")
    dims_path = timed("head-dim path", dims_path_phase)
    by_tag = {e["name"]: e for e in dims_fwd + dims_bwd}
    # fp32's tiled backward kernels, each timed at the fp32 D-100 shape
    tiled_entries = by_tag["gqa_flash_bwd_fp32_d100"].pop("kernel_entries")
    # the narrow tiles' yardsticks at D 32 (mma.sync, the mma pair)
    narrow_yardsticks = [by_tag[n].pop("yardstick")
                         for n in ("gqa_flash_bf16_d32", "gqa_flash_bwd_bf16_d32")]
    fp32_path = dims_path["D=100 float32"]["launches"]
    by_tag["gqa_flash_fp16_d128"].update(
        launches=serve["fp16_prefill"]["launches"]["wgmma"], path="serve-prefill fp16")
    for d, dtype in ((96, torch.bfloat16), (256, torch.bfloat16), (250, torch.bfloat16),
                     (32, torch.bfloat16), (100, torch.float32)):
        counts = dims_path[f"D={d} {str(dtype)[6:]}"]["launches"]
        name = f"{'bf16' if dtype == torch.bfloat16 else 'fp32'}_d{d}"
        if f"gqa_flash_{name}" in by_tag:
            by_tag[f"gqa_flash_{name}"].update(launches=counts[fa.route(dtype, d)],
                                               path="head-dim path train step")
        if f"gqa_flash_bwd_{name}" in by_tag:
            first = BWD_ROUTE_KERNELS[fa.bwd_route(dtype, d)][0]
            by_tag[f"gqa_flash_bwd_{name}"].update(launches=counts[first],
                                                   path="head-dim path train step")
    moe = timed("moe serving", moe_serve_phase)
    moe["wall_s"] = walls["moe serving"]
    kernels[2].update(moe_launches=moe["launches"]["wgmma"], moe_flash_d64=moe["flash_d64"])
    ssm_path = timed("rwkv6 / zamba2", ssm_serve_phase)
    ssm_path["wall_s"] = walls["rwkv6 / zamba2"]
    d112_entry.update(launches=ssm_path["zamba2-7b"]["forward_flash"]["wgmma"],
                      path="zamba2-forward")
    # the serving paths launch no backward
    for what, counts in (("serve", serve["launches"]), ("moe serve", moe["launches"])):
        if any(counts[n] for n in ("gqa_flash_bwd",) + fa.BWD_KERNELS
               + fa.BWD_WGMMA_KERNELS + fa.BWD_MMA_KERNELS + fa.BWD_TILED_KERNELS):
            raise AssertionError(f"the {what} path launched the backward: {counts}")
    train = timed("training", train_phase)
    train["wall_s"] = walls["training"]
    # the wgmma kernels run on the train step; the tiled kernels on the
    # elastic path (fp32, D 32) and the head-dim path's fp32 step; the fma
    # kernels, the yardsticks, on no default path: their entries leave the
    # kernel line for a line of their own
    for entry in bwd_entries:
        name = entry["name"][len("gqa_flash_"):]
        wgmma = entry["bwd_route"] == "wgmma"
        entry.update(launches=(train if wgmma else train["elastic"])["launches"][name],
                     path="train-step" if wgmma else "elastic",
                     train_launches=train["launches"][name],
                     elastic_launches=train["elastic"]["launches"][name])
    yardsticks = [e for e in bwd_entries if e["bwd_route"] == "fma"]
    bwd_entries = [e for e in bwd_entries if e["bwd_route"] != "fma"]
    for entry in tiled_entries:
        name = entry["name"][len("gqa_flash_"):]
        entry.update(launches=train["elastic"]["launches"][name], path="elastic",
                     train_launches=train["launches"][name], dims_path_launches=fp32_path[name],
                     elastic_launches=train["elastic"]["launches"][name])
    kernels[2].update(train_launches=train["launches"]["wgmma"])
    shard = timed("shard", shard_phase, shard_ranks)
    prefill0 = shard["prefill"][0]
    kernels[2].update(shard_tp_prefill_launches=[r["launches"]["wgmma"]
                                                 for r in shard["prefill"]],
                      shard_tp_prefill_heads=prefill0["heads"])
    zamba0 = shard["ssm"][0]["zamba2-7b"]
    d112_entry.update(shard_tp_launches=[r["zamba2-7b"]["launches"]["wgmma"]
                                         for r in shard["ssm"]],
                      shard_tp_heads=zamba0["heads"], shard_tp_timing=zamba0["flash_timing"])
    # the D-16 route (the narrow wgmma tiles) runs on train_carbon_aware's
    # tiny preset (shard cell (g)); its yardsticks, mma.sync and the mma
    # pair, on no default path
    tiny = [r["launches"] for r in shard["tiny"]]
    d16_entry.update(launches=tiny[0]["wgmma"], path="train_carbon_aware --preset tiny",
                     rank_launches=[r["wgmma"] for r in tiny])
    for entry in bwd_d16_entries:
        name = "bwd_wgmma_dq" if entry["name"] == "gqa_flash_bwd_d16" \
            else entry["name"][len("gqa_flash_"):-len("_d16")]
        entry.update(launches=tiny[0][name], path="train_carbon_aware --preset tiny",
                     rank_launches=[r[name] for r in tiny])
    for entry in tiled_entries + yardsticks:
        name = entry["name"][len("gqa_flash_"):]
        entry["shard_elastic_launches"] = [r["card"]["launches"][name]
                                           for r in shard["elastic"]]
    yardsticks += [d16_yardstick, *bwd_mma_entries, *narrow_yardsticks]
    default_paths = {"tiny rank": tiny, "head-dim path": [v["launches"]
                                                           for v in dims_path.values()]}
    for what, counts in default_paths.items():
        stray = [{n: c[n] for n in ("mma_sync",) + fa.BWD_MMA_KERNELS if c[n]} for c in counts]
        if any(stray):
            raise AssertionError(f"the {what} launched a yardstick: {stray}")
    dag = timed("dag", dag_path_phase, twins)
    kernels[3].update(launches=dag["launches"], path="dag-scan")
    windows = oracle_windows()
    score_path = timed("score (ops)", score_ops_phase, windows)
    kernels.append(timed("kernel (score)", score_kernel_phase, windows, score_path,
                         reports["src/repro_torch/csrc/score.cu"]))
    device_path = timed("oracle path", oracle_path_phase, path["result"])
    kernels.append(timed("kernel (greedy)", greedy_kernel_phase, device_path,
                         reports["src/repro_torch/csrc/oracle_greedy.cu"]))
    fill_entry, sweep = timed("sweep", sweep_phase, reports["src/repro_torch/csrc/fill.cu"], twins)
    kernels.append(fill_entry)
    geo_entry, geo = timed("geo", geo_phase, reports["src/repro_torch/csrc/geo_walk.cu"], twins)
    kernels.append(geo_entry)
    kernels.append(d112_entry)
    kernels.extend(bwd_entries)
    kernels.extend([d16_entry, *bwd_d16_entries])
    kernels.extend(tiled_entries)
    kernels.extend(dims_fwd + dims_bwd)
    chaos = timed("resilience", chaos_phase, twins)
    # launches on the resilience paths, beside each kernel's own path
    by_name = {kern["name"]: kern for kern in kernels}
    by_name["knn_topk"]["chaos_launches"] = chaos["chaos"]["launches"]["knn"]["knn_topk"]
    by_name["greedy_pass"]["chaos_launches"] = \
        chaos["chaos"]["launches"]["greedy"]["greedy_pass"]
    by_name["capacity_fill"]["chaos_launches"] = \
        chaos["chaos"]["launches"]["fill"]["capacity_fill"]
    by_name["geo_walk"]["chaos_launches"] = chaos["geo"]["launches"]
    by_name["dep_release_csr"]["chaos_launches"] = chaos["dag"]["launches"]
    tele = timed("telemetry", telemetry_phase)
    tune = timed("tuner", tune_phase, twins)
    by_name["knn_topk"]["tune_launches"] = sum(
        v["knn_launches"] for v in tune["runs"].values())
    examples = timed("examples", examples_phase, twins)
    kernels[2].update(launches_by_route={
        "wgmma": serve["launches"]["wgmma"], "wgmma (16-wide tiles)": d16_entry["launches"],
        "fp32": examples["serve_elastic"]["launches"]["fp32"]},
        launches_by_route_paths={"wgmma": "serve-prefill",
                                 "wgmma (16-wide tiles)": "train_carbon_aware --preset tiny "
                                                          "(D 16)",
                                 "fp32": "serve_elastic prefill (D 32)"},
        example_100m_launches=examples["train_100m"]["launches"])
    dry = timed("dry-run", dryrun_phase, train)
    by_name["knn_topk"]["tpu_world_launches"] = dry["world"]["knn_launches"]
    by_name["capacity_fill"]["tune_launches"] = sum(
        v["fill_launches"] for v in tune["runs"].values())
    # launches on the telemetry paths (0 for the kernels no such path runs)
    counter = dict(knn_topk="knn", greedy_pass="greedy", capacity_fill="fill",
                   geo_walk="geo", dep_release_csr="release")
    paths = [v for k, v in tele.items() if isinstance(v, dict) and "launches" in v]
    for kern in kernels:
        key = counter.get(kern["name"])
        kern["telemetry_launches"] = (sum(p["launches"][key] for p in paths)
                                      if key else 0)
    log(f"wall / learning / execution (s): main path {path['wall_s']:.3f} / "
        f"{path['learn_s']:.3f} / {path['execute_s']:.3f}; oracle path (backend=\"device\") "
        f"{device_path['wall_s']:.3f} / {device_path['learn_s']:.3f} / "
        f"{device_path['execute_s']:.3f}; sweep-full on the card {sweep['card']['wall_s']:.3f}"
        f" / {sweep['card']['learn_s']:.3f} / {sweep['card']['execute_s']:.3f}, on the CPU "
        f"{sweep['cpu']['wall_s']:.3f} / {sweep['cpu']['learn_s']:.3f} / "
        f"{sweep['cpu']['execute_s']:.3f}; geo-full on the card {geo['card']['wall_s']:.3f}, "
        f"on the CPU {geo['cpu']['wall_s']:.3f}; chaos-full on the card "
        f"{chaos['chaos']['card']['wall_s']:.3f}, on the CPU "
        f"{chaos['chaos']['cpu']['wall_s']:.3f}; geo-chaos on the card "
        f"{chaos['geo']['card']['wall_s']:.3f}, on the CPU {chaos['geo']['cpu']['wall_s']:.3f}"
        f"; the DAG path under the outage on the card {chaos['dag']['wall_s']:.3f}, on the "
        f"CPU {chaos['dag']['cpu_wall_s']:.3f}; the telemetry phase {tele['wall_s']:.3f}; "
        f"MoE serving: warm prefill {moe['warm_run']['prefill_s']:.3f}, decode "
        f"{moe['warm_run']['decode_s']:.3f}, the phase {moe['wall_s']:.3f}; rwkv6 / zamba2 "
        f"{ssm_path['rwkv6-7b']['wall_s']:.3f} / {ssm_path['zamba2-7b']['wall_s']:.3f}, the "
        f"phase {ssm_path['wall_s']:.3f}; training {train['wall_s']:.3f} (a step "
        f"{train['step_s']:.3f}); the shard phase {shard['wall_s']:.3f}; the tuner on "
        f"the card {sum(v['card_s'] for v in tune['runs'].values()):.3f}, on the CPU "
        f"{sum(v['cpu_s'] for v in tune['runs'].values()):.3f}, the phase "
        f"{tune['wall_s']:.3f}; the dry-run {dry['wall_s']:.3f} (counting "
        f"{dry['count_wall_s']:.3f}, the tpu world on the card {dry['world']['card_s']:.3f}, on "
        f"the CPU {dry['world']['cpu_s']:.3f})")
    if any(kern["launches"] < 1 for kern in kernels):
        raise AssertionError("a kernel of a path was never launched")
    log(json.dumps({"main_path": {k: v for k, v in path.items()
                                  if k not in ("result", "main", "batch")}}))
    log(json.dumps({"serve_path": {k: v for k, v in serve.items()
                                   if k != "launches"}}))
    log(json.dumps({"moe_serve_path": {k: v for k, v in moe.items()
                                       if k != "launches"}}))
    log(json.dumps({"ssm_serve_path": ssm_path}))
    log(json.dumps({"train_path": train}, default=str))
    log(json.dumps({"shard_path": shard}, default=str))
    log(json.dumps({"tune_path": tune}))
    log(json.dumps({"dryrun_path": dry}))
    log(json.dumps({"dag_path": dag}))
    log(json.dumps({"oracle_path": {k: v for k, v in device_path.items()
                                    if k != "attempts"}}))
    log(json.dumps({"sweep_path": sweep}))
    log(json.dumps({"geo_path": geo}))
    log(json.dumps({"chaos_path": chaos}))
    log(json.dumps({"telemetry_path": tele}))
    log(json.dumps({"examples_path": examples}, default=str))
    log(json.dumps({"flash_dims": dims, "dims_path": dims_path}, default=str))
    log(json.dumps({"yardsticks": yardsticks}, default=str))
    log("phase walls (s): " + ", ".join(f"{k} {v:.3f}" for k, v in walls.items())
        + f"; the whole script so far {time.perf_counter() - T_START:.3f}")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
