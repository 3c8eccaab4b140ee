"""The device slot loop (``engine="scan"``): the per-slot simulation loop
of the threshold-fill, MPC and geo policies as tensor ops on the device.

The counterpart of the JAX package's ``core/scan_engine.py``, with
PyTorch's idiom inside the reference's names:

- the *decision* of every native policy is packed tensor ops inside the
  slot step: FCFS threshold-fill at ``k_min`` under an eligibility mask, or
  the MPC rule over the policy's precomputed tables (``rank``/``clean`` per
  slot, the ``need`` LUT per row), forced rows first;
- the capacity fill is a cumsum prefix where every request of a cell is one
  ``k``; where requests differ (job lists whose ``k_min`` is not uniform,
  and ``carbonflex-scale``'s clean-slot scale-up) it is one launch of the
  hand-written CUDA kernel of ``kernels/fill.py::capacity_fill`` per slot
  step (its plain version on the CPU);
- admission, dependency gating, release and deadline-from-release live in
  the carried state; the release of DAG workloads (the in-degree decrement
  and the rows it frees) goes through one launch of the hand-written CUDA
  kernel of ``kernels/gating.py::dep_release_csr`` per slot step (its
  plain version on the CPU), over a predecessor CSR built once per
  program;
- the geo program (``geo-static``, ``geo-greedy``, ``geo-flex`` on a
  ``GeoCluster``) keeps each row's region, placement and migration state in
  the carry; each slot step's placement, migration and per-region capacity
  walk is one launch of the hand-written CUDA kernel of
  ``kernels/geo_walk.py::geo_resolve`` (its plain version on the CPU), for
  uniform and mixed ``k_min`` alike; the CI, forecast-mean and threshold
  tables it reads are computed per chunk on the host with the policies'
  own numpy expressions;
- structurally identical cases run as one batched program: a leading
  batch dimension of up to ``BATCH_TILE`` cells takes the place of the
  reference's ``vmap``, and the reference's ``lax.scan`` becomes a Python
  loop of eager slot steps, chunked so termination is read on the host
  once per chunk.

Bit-parity contract: ``engine="scan"`` is bit-identical to the vector and
scalar engines.  The device updates ``remaining`` in float64 with one
subtraction per taken slot (``rem - thr``, the vector engine's IEEE op;
``thr_up`` on the rows ``carbonflex-scale`` scaled) and emits per-slot
boolean grids (which rows ran, were scaled, finished, violated) into
preallocated (B, chunk, n_pad) tensors, copied to the host once per chunk.
The host replays fractional progress, energy and carbon from the ``take``
grid with the vector engine's exact numpy expressions, in its order
(``_active_energy``, ``_account_single``, ``_account_geo``: per-region
energy in row order, migration carbon at the destination's CI in row order),
and the eligibility, MPC and geo tables are computed on the host with the
policies' own numpy expressions.

Native policies (exact types, no fault process): ``carbon-agnostic`` and
``dag-fcfs`` (plain), ``wait-awhile``, ``wait-awhile-robust`` and
``dag-carbon`` (thresh), ``dag-cap`` (cap), ``carbonflex-mpc`` (mpc),
``carbonflex-scale`` (mpc-scale); on a ``GeoCluster`` ``geo-static``,
``geo-greedy`` and ``geo-flex``.  Every other policy runs on the vector
engine (the geo vector engine on a geo cluster) instead, which is
bit-identical; ``stats["delegated"]`` counts those cases.  So does every
case with a fault process, whatever its policy (``core/faults.py``: the
processes draw host RNG mid-slot); ``stats["fault_delegated"]`` counts
those apart.  A carbon-feed outage (``CarbonService(outage=...)``) is a
pure per-slot function of the trace and runs natively: the eligibility,
MPC and geo tables are built from the degraded view the policies read
(``ci.degraded()``), the host accounting reads the true trace, and the
result carries ``resilience`` with the degraded slots, as on the vector
engine.

Telemetry (``SimCase.telemetry``): the decision events are decoded on the
host from the grids the loop already copies per chunk (``take``, ``fin``,
and on the geo loop ``region`` and ``mig_now``), in the vector engine's
order; each cell's profiler gets ``decide`` += its tile's loop seconds
over its cells and ``execute`` its accounting.  The decode assumes every
taken row runs at ``k_min``, so a ``carbonflex-scale`` cell with a recorder
runs on the vector engine, whose tracker sees its scale-ups;
``stats["telemetry_delegated"]`` counts those cells.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import fill, gating, geo_walk

from . import emissions
from .baselines import (CarbonAgnosticPolicy, RobustWaitAwhilePolicy,
                        WaitAwhilePolicy)
from .carbon import CarbonService, MultiRegionCarbonService
from .dag import DagCapPolicy, DagCarbonPolicy, DagFcfsPolicy
from .forecast import PerfectForecast, QuantileCIView
from .geo import GeoFlexPolicy, GeoGreedyPolicy, GeoStaticPolicy
from .mpc import CarbonFlexMPCPolicy, CarbonFlexScalePolicy
from .simulator import (PackedJobs, SimCase, _accumulate_regions,
                        _run_resilience, _simulate_geo_vector,
                        _simulate_vector, _telemetry_hooks, packed_for)
from .types import GeoCluster, SimResult, SlotLog
from ..telemetry import Telemetry

_EPS = 1e-9
_log = logging.getLogger(__name__)
_BIG_T = np.int64(2 ** 62)     # arrival sentinel for padding rows
ROW_PAD = 256                  # row-count bucket
CHUNK = 168                    # slots per chunk (horizon region)
OVERRUN_CHUNK = 24             # slots per chunk past the horizon
BATCH_TILE = 64                # cells per batched program

_MPC_KINDS = ("mpc", "mpc-scale")

#: Since the last ``reset_stats()``: slot steps (one per batched step
#: call), cell steps (steps times the cells of the batch), steps with DAG
#: gating, steps through the variable-k fill, geo steps (each one launch of
#: the geo walk), cases delegated to the vector engine for their policy,
#: for their fault process and for a recorder on a ``carbonflex-scale``
#: cell, and host seconds in the chunk loops (device steps, the per-chunk
#: tables and copies) and in the host accounting.
stats = {"steps": 0, "cell_steps": 0, "dag_steps": 0, "fill_steps": 0,
         "geo_steps": 0, "delegated": 0, "fault_delegated": 0,
         "telemetry_delegated": 0, "loop_s": 0.0, "account_s": 0.0}


def reset_stats() -> None:
    for name in stats:
        stats[name] = 0.0 if name.endswith("_s") else 0


_GEO_KINDS = {GeoStaticPolicy: "geo-static", GeoGreedyPolicy: "geo-greedy",
              GeoFlexPolicy: "geo-flex"}


def native_kind(policy, geo: bool = False, faults=None) -> str | None:
    """The scan-native program family of ``policy`` (on a ``GeoCluster``
    when ``geo``), or None to delegate.

    Exact ``type()`` checks: a subclass may override ``decide`` in ways the
    packed decision tables cannot see (``carbonflex-scale`` is checked
    before its base MPC class for the same reason).  Any fault process
    delegates (host RNG mid-slot)."""
    if faults is not None:
        return None
    if geo:
        return _GEO_KINDS.get(type(policy))
    tp = type(policy)
    if tp in (CarbonAgnosticPolicy, DagFcfsPolicy):
        return "plain"
    if tp in (WaitAwhilePolicy, RobustWaitAwhilePolicy, DagCarbonPolicy):
        return "thresh"
    if tp is DagCapPolicy:
        return "cap"
    if tp is CarbonFlexScalePolicy:
        return "mpc-scale"
    if tp is CarbonFlexMPCPolicy:
        return "mpc"
    return None


def _pad_rows(n: int) -> int:
    """Smallest ROW_PAD multiple strictly greater than n (the last row is
    always padding)."""
    return (n // ROW_PAD + 1) * ROW_PAD


# --- host tables -------------------------------------------------------------
# The per-slot CI/forecast APIs (``ci_vec``/``forecast_matrix``/``ci``)
# are Python calls; building a week of decision tables through them costs
# more than the device program itself.  When the view is a plain
# perfect-forecast service the same tables fall out of whole-trace
# indexing — the gathered elements are the identical float64 values the
# per-slot calls return, so the fast path is bitwise equal; any other
# view (forecast models, outage-degraded, subclasses) keeps the per-slot
# loop.


def _perfect_traces(ci_pol) -> np.ndarray | None:
    """(R, T) trace stack when every regional feed is a plain
    perfect-forecast ``CarbonService`` with no outage; None otherwise."""
    if type(ci_pol) is not MultiRegionCarbonService:
        return None
    svs = ci_pol.services
    if any(type(s) is not CarbonService or type(s.model) is not PerfectForecast
           or s.outage is not None or np.asarray(s.trace).dtype != np.float64
           for s in svs):
        return None
    if len({len(s.trace) for s in svs}) != 1:
        return None
    return np.stack([np.asarray(s.trace) for s in svs])


def _ci_vec_block(ci_pol, ts: np.ndarray) -> np.ndarray:
    """(S, R) stack of ``ci_vec`` over the slots ``ts``."""
    tr = _perfect_traces(ci_pol)
    if tr is not None and ts[0] >= 0:
        return tr[:, np.minimum(ts, tr.shape[1] - 1)].T.copy()
    return np.stack([ci_pol.ci_vec(int(t)) for t in ts])


def _forecast_block(ci_pol, ts: np.ndarray, h: int) -> np.ndarray:
    """(S, R, H) stack of ``forecast_matrix`` over the slots ``ts``.

    The fast path mirrors ``forecast._truth_slice`` exactly: windows past
    the trace end repeat the last known value (the padded-trace gather
    reads that same element)."""
    tr = _perfect_traces(ci_pol)
    if tr is not None and ts[0] >= 0 and ts[-1] < tr.shape[1]:
        pad = np.concatenate([tr, np.repeat(tr[:, -1:], h - 1, axis=1)],
                             axis=1)
        idx = ts[:, None] + np.arange(h)[None, :]
        return pad[:, idx].transpose(1, 0, 2)
    return np.stack([ci_pol.forecast_matrix(int(t), h) for t in ts])


def _ci_vec_acct_block(mci, t0: int, n_valid: int) -> np.ndarray:
    """(S, R) accounting CI vectors (the true multi-region service; outages
    never apply here)."""
    ts = np.arange(t0, t0 + n_valid)
    if type(mci) is MultiRegionCarbonService:
        return np.stack(
            [np.asarray(s.trace, dtype=np.float64)[
                np.minimum(ts, len(s.trace) - 1)] for s in mci.services],
            axis=1)
    return np.stack([mci.ci_vec(int(t)) for t in ts]) if n_valid \
        else np.zeros((0, mci.n_regions))


def _ci_block(ci, t0: int, n_valid: int) -> np.ndarray:
    """Accounting CI per slot (the true service; outages never apply
    here)."""
    if type(ci) is CarbonService:
        # float64 widening is exact, matching the per-slot float() calls
        tr = np.asarray(ci.trace, dtype=np.float64)
        return tr[np.minimum(np.arange(t0, t0 + n_valid), len(tr) - 1)]
    return np.array([ci.ci(t0 + i) for i in range(n_valid)])


def _single_elig_fn(policy, ci_pol, kind: str) -> Callable:
    """Per-slot low-carbon eligibility flags, computed with the policy's
    own expressions (bit-parity by construction)."""
    if kind == "plain":
        return lambda ts: np.ones(len(ts), dtype=bool)
    view = ci_pol
    if type(policy) is RobustWaitAwhilePolicy:
        view = QuantileCIView(ci_pol, policy.quantile)
    pct = policy.percentile

    tr = pad_tr = None
    if (type(view) is CarbonService and type(view.model) is PerfectForecast
            and view.outage is None
            and np.asarray(view.trace).dtype == np.float64):
        # perfect-forecast fast path: whole-trace windows are the same
        # float64 elements the per-slot forecast() calls slice, so the
        # batched percentile is bitwise equal; any other forecast model,
        # and a degraded feed, keeps the per-slot calls
        tr = np.asarray(view.trace)
        hor = int(view.horizon)
        pad_tr = np.concatenate([tr, np.full(hor - 1, tr[-1])])

    def elig(ts: np.ndarray) -> np.ndarray:
        if tr is not None and ts[0] >= 0 and ts[-1] < len(tr):
            civ = tr[np.minimum(ts, len(tr) - 1)]
            fcm = pad_tr[ts[:, None] + np.arange(hor)[None, :]]
            return civ <= np.percentile(fcm, pct, axis=1) + 1e-12
        # one percentile call over the stacked windows: np.percentile with
        # axis= interpolates each row with the same arithmetic as the
        # per-row call, so this is bitwise identical to the policies'
        # per-slot ``percentile_threshold(t, pct)``; rows of unequal length
        # (trace tail) fall back to the per-row call.
        tl = ts.tolist()
        civ = np.array([view.ci(t) for t in tl])
        fcs = [view.forecast(t) for t in tl]
        if fcs and all(len(f) == len(fcs[0]) for f in fcs):
            thresh = np.percentile(np.stack(fcs), pct, axis=1)
        else:
            thresh = np.array([float(np.percentile(f, pct)) for f in fcs])
        return civ <= thresh + 1e-12

    return elig


# --- single-region program ---------------------------------------------------


@dataclasses.dataclass
class _SingleProgram:
    """Host constants and initial carry of one native case (stacked across
    a tile and moved to the device there), with its accounting mirrors."""

    consts: dict                   # numpy arrays / 0-d scalars
    carry0: dict
    n_pad: int
    kind: str                      # plain | thresh | cap | mpc | mpc-scale
    uniform: bool                  # one k per cell -> cumsum fill
    xs_fn: Callable                # (ts: np.ndarray) -> per-slot host tables
    xs_dims: tuple                 # their shapes (part of the tile key)
    power: np.ndarray
    m_t: int
    k_up: np.ndarray | None = None     # mpc-scale: per-row clean-slot k


def _build_single(packed, cluster, policy, ci_pol, kind: str,
                  t0: int, horizon: int) -> _SingleProgram:
    n = packed.n
    n_pad = _pad_rows(n)
    power = np.where(packed.power > 0, packed.power, cluster.power_per_server)
    kmin = packed.k_min
    thr = packed.thr_tab[np.arange(n), kmin]
    i64, f64 = np.int64, np.float64

    def padded(src, fill, dtype):
        out = np.full(n_pad, fill, dtype=dtype)
        out[:n] = src
        return out

    elig_row = np.zeros(n_pad, dtype=bool)
    if kind == "plain":
        elig_row[:n] = True
    elif kind == "cap":
        # criticality is static per window (DagCapPolicy.on_window_start);
        # a job missing from the map is critical (crit.get(..., True))
        crit = policy._critical
        elig_row[:n] = [bool(crit.get(int(j), True))
                        for j in packed.job_ids.tolist()]
    k_up = None
    mpc_consts: dict = {}
    if kind in _MPC_KINDS:
        # the MPC rule's row constants: static job length (``remaining``
        # in the carry decays, done-work needs the original), queue ids
        # for the need-LUT gather, and the learned need LUT itself
        mpc_consts["length_c"] = padded(packed.length, 0.0, f64)
        mpc_consts["queue"] = padded(packed.queue, 0, i64)
        mpc_consts["need_lut"] = np.asarray(policy.scan_tables()["need_lut"],
                                            dtype=i64)
        if kind == "mpc-scale":
            k_up = np.asarray(policy._k_up, dtype=i64)
            mpc_consts["k_scale"] = padded(k_up, 1, i64)
            mpc_consts["thr_up"] = padded(
                packed.thr_tab[np.arange(n), k_up], 1.0, f64)
    consts = dict(
        arrival=padded(packed.arrival, _BIG_T, i64),
        kmin=padded(kmin, 1, i64),
        k0=np.array([kmin[0] if n else 1], dtype=i64),
        thr=padded(thr, 1.0, f64),
        dl_span=padded(packed.dl_span, 0, i64),
        elig_row=elig_row,
        m_cap=np.array([cluster.capacity], dtype=i64),
        n_real=i64(n),
        t_end=i64(t0 + horizon),
        **mpc_consts,
    )
    carry0 = dict(
        remaining=padded(packed.length, 0.0, f64),
        slack=padded([j.delay for j in packed.jobs], 0, i64),
        waited=np.zeros(n_pad, dtype=i64),
        deadline_eff=padded(packed.deadline, 0, i64),
        pred_left=padded(packed.pred0, 0, np.int32),
        in_sys=np.zeros(n_pad, dtype=bool),
        finished=np.zeros(n_pad, dtype=bool),
        pending=np.zeros(n_pad, dtype=bool),
        ended=np.asarray(False),
    )
    if kind in _MPC_KINDS:
        # per-slot tables of the MPC rule, straight from the policy's own
        # host-precomputed arrays (bit-parity by construction)
        def xs_fn(ts: np.ndarray) -> dict:
            xs = {"t": ts[:, None], "rank_t": policy.rank_rows(ts).astype(i64)}
            if kind == "mpc-scale":
                xs["clean_t"] = np.asarray(policy.clean_rows(ts), dtype=bool)[:, None]
            return xs

        xs_dims = (int(policy.cfg.horizon), mpc_consts["need_lut"].shape)
    else:
        elig = _single_elig_fn(policy, ci_pol, kind)

        def xs_fn(ts: np.ndarray) -> dict:
            return {"t": ts[:, None], "elig_t": elig(ts)[:, None]}

        xs_dims = ()
    # per-slot scale-up makes the requested k slot-varying -> the cumsum
    # fill's uniform-k premise no longer holds
    uniform = bool(n > 0 and (kmin == kmin[0]).all() and kind != "mpc-scale")
    return _SingleProgram(
        consts=consts, carry0=carry0, n_pad=n_pad, kind=kind, uniform=uniform,
        xs_fn=xs_fn, xs_dims=xs_dims, power=power, m_t=int(cluster.capacity),
        k_up=k_up)


def _dep_graph(packed: PackedJobs, n_pad: int,
               device: torch.device) -> gating.DepGraph:
    """The predecessor CSR of the packed rows, padded to ``n_pad`` rows."""
    n = packed.n
    deg = np.diff(packed.succ_ptr[:n + 1])
    parents = np.repeat(np.arange(n, dtype=np.int64), deg)
    children = packed.succ_rows[packed.succ_ptr[0]:packed.succ_ptr[n]]
    return gating.dep_graph(parents, children, n_pad, device=device)


def _single_step(c: dict, s: dict, x: dict, graph: gating.DepGraph | None,
                 kind: str, uniform: bool):
    """One engine slot for a batch of B cells (mirrors the vector engine's
    loop body).  ``c`` and ``s`` hold (B, n_pad) rows, (B, 1) or (B,)
    scalars; ``x`` the slot's tables: ``t`` (B, 1), and ``elig_t`` (B, 1),
    or for the MPC kinds ``rank_t`` (B, H) and ``clean_t`` (B, 1)."""
    t = x["t"]
    rem = s["remaining"]
    slack = s["slack"]
    waited = s["waited"]
    dle = s["deadline_eff"]
    pred = s["pred_left"]
    in_sys = s["in_sys"]
    fin_all = s["finished"]
    pending = s["pending"]

    # release (DAG): tasks whose last predecessor finished last slot —
    # slack/deadline count from the release slot
    if graph is not None:
        in_sys = in_sys | pending
        dle = torch.where(pending, t + c["dl_span"], dle)
    # admission: arrival passed, not finished, not gated
    arrived = c["arrival"] <= t
    in_sys = in_sys | (arrived & ~fin_all & (pred == 0))

    n_in = in_sys.sum(1)
    n_arr = arrived.sum(1)
    blocked = n_arr - n_in - fin_all.sum(1)
    ended = s["ended"] | ((n_in == 0) & (n_arr == c["n_real"])
                          & (blocked == 0) & (t[:, 0] >= c["t_end"]))
    act = in_sys & ~ended[:, None]

    # decision: FCFS threshold-fill at k_min (rows are (arrival, job_id)-
    # sorted, so forced-then-unforced in row order IS the FCFS key)
    forced = slack <= 0
    live = rem > _EPS
    kmin, m_cap = c["kmin"], c["m_cap"]
    if kind in _MPC_KINDS:
        # MPC eligibility: current slot among the job's estimated-need
        # cheapest within its feasible window (CarbonFlexMPCPolicy.decide
        # — same tables, same integer logic)
        lut = c["need_lut"]
        dmax = lut.shape[2]
        didx = torch.floor(c["length_c"] - rem).to(torch.int64).clamp(0, dmax - 1)
        need = lut.reshape(lut.shape[0], -1).gather(1, c["queue"] * dmax + didx)
        rank_t = x["rank_t"]
        w = (slack + need).clamp(1, rank_t.shape[1])
        cand = act & live & (forced | (rank_t.gather(1, w - 1) < need))
    else:
        cand = act & live & (forced | x["elig_t"] | c["elig_row"])
    if kind == "mpc-scale":
        # clean-window scale-up: unforced rows request the learned k_up
        kreq = torch.where(forced | ~x["clean_t"], kmin, c["k_scale"])
    else:
        kreq = kmin
    if uniform:
        # one k per cell: the "continue" fill is a rank-prefix per group
        k0 = c["k0"]
        cf = cand & forced
        cr = cand & ~forced
        tf = cf & (torch.cumsum(cf, 1) * k0 <= m_cap)
        used_f = k0 * tf.sum(1, keepdim=True)
        tr = cr & (used_f + torch.cumsum(cr, 1) * k0 <= m_cap)
        take = tf | tr
    else:
        take = fill.capacity_fill(cand, forced, kreq, m_cap.view(-1))

    # progress in float64, the vector engine's op (energy and frac are
    # replayed on the host from ``take``)
    if kind == "mpc-scale":
        scaled = take & (kreq > kmin)
        rem2 = torch.where(take, rem - torch.where(scaled, c["thr_up"], c["thr"]),
                           rem)
    else:
        rem2 = torch.where(take, rem - c["thr"], rem)
    wmask = (act & live & ~take).to(torch.int64)
    fin = act & (rem2 <= _EPS)
    waited2 = waited + wmask
    carry = dict(remaining=rem2, slack=slack - wmask, waited=waited2,
                 deadline_eff=dle, pred_left=pred, in_sys=in_sys & ~fin,
                 finished=fin_all | fin, pending=pending, ended=ended)
    if graph is not None:
        carry["pred_left"], carry["pending"] = gating.dep_release_csr(
            fin, arrived, pred, graph)
    ys = dict(take=take, fin=fin, viol=fin & (t > dle),
              waited_fin=torch.where(fin, waited2, 0), n_rows=n_in,
              ended=ended)
    if kind == "mpc-scale":
        ys["scaled"] = scaled
    return carry, ys


_YS_TYPES = dict(take=torch.bool, fin=torch.bool, viol=torch.bool,
                 waited_fin=torch.int32, n_rows=torch.int32, ended=torch.bool)


def _collect_chunks(c, carry, step, t0s: np.ndarray, xs_fns, n_pad: int,
                    horizon: int, span: int, device, ys_types: dict,
                    counters: tuple = ()) -> dict:
    """Run the batch chunk by chunk until every cell has ended or ``span``
    slots are done; returns the per-slot outputs on the host, (B, S, ...).

    ``step(c, carry, x)`` is one batched slot step, returning the new carry
    and the slot's outputs named in ``ys_types``; ``x`` holds the slot's
    tables, (B, ...) each: every ``xs_fns`` entry returns a cell's tables
    over the chunk's slots, (S, ...), stacked slot-major so that each
    slot's slice is contiguous.  Each step adds to ``stats["steps"]`` and
    to the entries named in ``counters``.

    Inside the horizon no cell can end (the ended-check needs ``t >=
    t0 + horizon``), so full CHUNK chunks waste nothing; past it any slot
    may end a cell, so OVERRUN_CHUNK chunks bound the slots computed past
    the last end.  Each chunk builds its slot tables on the host, writes its
    steps into preallocated device tensors, copies them to the host once
    and reads ``ended`` there."""
    b = len(t0s)
    parts = []
    off = 0
    while off < span:
        size = min(CHUNK if off < horizon else OVERRUN_CHUNK, span - off)
        ts = t0s[:, None] + off + np.arange(size)[None, :]
        xs_host = [fn(row) for fn, row in zip(xs_fns, ts)]
        xs = {k: torch.from_numpy(np.stack([d[k] for d in xs_host], axis=1)).to(device)
              for k in xs_host[0]}
        out = {k: torch.empty((b, size) if k in ("n_rows", "ended")
                              else (b, size, n_pad), dtype=dtype, device=device)
               for k, dtype in ys_types.items()}
        for i in range(size):
            carry, ys = step(c, carry, {k: v[i] for k, v in xs.items()})
            for k, v in ys.items():
                out[k][:, i] = v
        stats["steps"] += size
        stats["cell_steps"] += size * b
        for name in counters:
            stats[name] += size
        parts.append({k: v.cpu().numpy() for k, v in out.items()})
        off += size
        if parts[-1]["ended"][:, -1].all():
            break
    return {k: np.concatenate([p[k] for p in parts], axis=1) for k in parts[0]}


# --- geo program -------------------------------------------------------------


@dataclasses.dataclass
class _GeoProgram:
    """Host constants and initial carry of one native geo case (stacked
    across a tile and moved to the device there), with its accounting
    mirrors."""

    consts: dict
    carry0: dict
    n_pad: int
    kind: str                      # geo-static | geo-greedy | geo-flex
    lookahead: int
    xs_fn: Callable                # (ts) -> per-slot host tables
    power: np.ndarray
    mig_e: np.ndarray              # host transfer energy per row
    caps: np.ndarray
    mig_vals: list


def _build_geo(packed, geo: GeoCluster, policy, ci_pol,
               t0: int, horizon: int, kind: str) -> _GeoProgram:
    n = packed.n
    n_pad = _pad_rows(n)
    n_regions = geo.n_regions
    caps = geo.capacity_vec()
    power = np.where(packed.power > 0, packed.power, geo.power_per_server)
    kmin = packed.k_min
    thr = packed.thr_tab[np.arange(n), kmin]
    i64, f64 = np.int64, np.float64

    def padded(src, fill, dtype):
        out = np.full(n_pad, fill, dtype=dtype)
        out[:n] = src
        return out

    mig_slots = np.array([geo.migration.slots(j) for j in packed.jobs],
                         dtype=i64)
    mig_e = np.array([geo.migration.energy_kwh(j) for j in packed.jobs],
                     dtype=f64)
    mig_vals = sorted(set(mig_slots.tolist())) or [0]
    val2idx = {v: i for i, v in enumerate(mig_vals)}
    mig_idx = np.array([val2idx[int(v)] for v in mig_slots], dtype=i64)
    home = np.array([geo.home_region(i) for i in range(n)], dtype=i64)
    # e_run coefficient: ((k_min * power) * slot_hours), the first three
    # factors of both the energy expression and the policies' e_run
    ec = (kmin * power) * geo.slot_hours

    lookahead = int(getattr(policy, "lookahead", 24))
    percentile = getattr(policy, "percentile", 40.0)
    margin_c = 1.0 - getattr(policy, "saving_margin", 0.0)
    max_moves = int(getattr(policy, "max_migrations_per_job", 0))

    consts = dict(
        arrival=padded(packed.arrival, _BIG_T, i64),
        kmin=padded(kmin, 1, i64),
        thr=padded(thr, 1.0, f64),
        deadline=padded(packed.deadline, 0, i64),
        ec=padded(ec, 0.0, f64),
        mig_e=padded(mig_e, 0.0, f64),
        mig_slots=padded(mig_slots, 0, i64),
        mig_idx=padded(mig_idx, 0, i64),
        caps=caps.astype(i64),
        margin_c=f64(margin_c),
        max_moves=i64(max_moves),
        n_real=i64(n),
        t_end=i64(t0 + horizon),
    )
    carry0 = dict(
        remaining=padded(packed.length, 0.0, f64),
        slack=padded([j.delay for j in packed.jobs], 0, i64),
        waited=np.zeros(n_pad, dtype=i64),
        in_sys=np.zeros(n_pad, dtype=bool),
        finished=np.zeros(n_pad, dtype=bool),
        started=np.zeros(n_pad, dtype=bool),
        placed=np.zeros(n_pad, dtype=bool),
        pol_region=padded(home, 0, i64),
        eng_region=padded(home, 0, i64),
        mig_left=np.zeros(n_pad, dtype=i64),
        moves=np.zeros(n_pad, dtype=i64),
        ended=np.asarray(False),
    )

    # Per-chunk decision tables with the policies' own numpy expressions.
    # The CI/forecast blocks go through the batched whole-trace fast paths
    # above; the batched slice means are bitwise equal to the per-slot
    # `fc[:, :h].mean(axis=1)` the policy computes (the same reduction over
    # the same values).  They stay on the host: a sum in another order is
    # not bitwise equal.
    def xs_fn(ts: np.ndarray) -> dict:
        s = len(ts)
        xs = {"t": ts[:, None].astype(i64)}
        if kind == "geo-static":
            return xs
        civ = _ci_vec_block(ci_pol, ts)                           # (S, R)
        xs["ci_now"] = civ
        if kind == "geo-greedy":
            xs["clean_order"] = np.argsort(civ, axis=1,
                                           kind="stable").astype(i64)
            return xs
        fc = np.ascontiguousarray(
            _forecast_block(ci_pol, ts, lookahead))               # (S, R, H)
        xs["thresh_eps"] = np.percentile(fc, percentile, axis=2) + _EPS
        means = np.zeros((s, n_regions, lookahead))
        for h in range(1, lookahead + 1):
            means[:, :, h - 1] = fc[:, :, :h].mean(axis=2)
        xs["means"] = means
        movem = np.zeros((s, len(mig_vals), n_regions, lookahead))
        for mi, ms in enumerate(mig_vals):
            for h in range(1, lookahead - ms + 1):
                movem[:, mi, :, h - 1] = fc[:, :, ms:ms + h].mean(axis=2)
        xs["movemeans"] = movem
        return xs

    return _GeoProgram(consts=consts, carry0=carry0, n_pad=n_pad, kind=kind,
                       lookahead=lookahead, xs_fn=xs_fn, power=power,
                       mig_e=mig_e, caps=caps, mig_vals=mig_vals)


def _geo_step(c: dict, s: dict, x: dict, kind: str):
    """One geo engine slot for a batch of B cells (mirrors
    ``_simulate_geo_vector`` + the geo policies' ``decide_geo`` +
    ``_resolve_geo``): admission and the end test as tensor ops, then the
    placement, migration and capacity walk in one launch of
    ``geo_walk.geo_resolve``, then progress, waiting budgets and the
    migration countdown.  ``x`` holds ``t`` (B, 1) and the kind's tables."""
    t = x["t"]
    rem = s["remaining"]
    arrived = c["arrival"] <= t
    in_sys = s["in_sys"] | (arrived & ~s["finished"])
    n_in = in_sys.sum(1)
    ended = s["ended"] | ((n_in == 0) & (arrived.sum(1) == c["n_real"])
                          & (t[:, 0] >= c["t_end"]))
    act = in_sys & ~ended[:, None]
    forced = s["slack"] <= 0
    live = rem > _EPS
    cand = act & live & (s["mig_left"] == 0)
    take, placed, polr, engr, migl, moves, mig_now = geo_walk.geo_resolve(
        kind, cand, forced, s, c, x)

    rem2 = torch.where(take, rem - c["thr"], rem)
    wmask = act & live & ~take
    wm = wmask.to(torch.int64)
    waited2 = s["waited"] + wm
    fin = act & (rem2 <= _EPS)
    carry = dict(remaining=rem2, slack=s["slack"] - wm, waited=waited2,
                 in_sys=in_sys & ~fin, finished=s["finished"] | fin,
                 started=s["started"] | take, placed=placed, pol_region=polr,
                 eng_region=engr,
                 mig_left=migl - (wmask & (migl > 0)).to(torch.int64),
                 moves=moves, ended=ended)
    ys = dict(take=take, region=engr, mig_now=mig_now, fin=fin,
              viol=fin & (t > c["deadline"]),
              waited_fin=torch.where(fin, waited2, 0), n_rows=n_in,
              ended=ended)
    return carry, ys


_GEO_YS_TYPES = dict(take=torch.bool, region=torch.int8, mig_now=torch.bool,
                     fin=torch.bool, viol=torch.bool, waited_fin=torch.int32,
                     n_rows=torch.int32, ended=torch.bool)


# --- host accounting ---------------------------------------------------------


def _active_energy(packed, power, slot_h, eta, take_a, k_rows):
    """Replay fractional progress and the vector engine's exact energy
    expressions over the active (slot, row) cells of the take grid.

    ``k_rows`` is the (S, n) grid of the allocation each take cell ran at
    (``k_min``, or ``k_up`` where carbonflex-scale scaled); throughput is
    gathered per cell (``thr_tab[row, k]``).  The device updates
    ``remaining`` with one subtraction per take slot (``rem - thr``) and
    ``frac = min(1, rem / thr_guard)`` comes from the pre-update value;
    replaying those row-wise here performs the identical scalar arithmetic
    in the identical order — bitwise equal.  The nonzero cells (row-major:
    each slot's segment in row order) are the per-slot active sets; every
    energy operation is elementwise, so each cell sees the arithmetic of a
    per-slot replay.  Returns per-slot segment bounds plus row ids,
    allocations and energies of the active cells."""
    s_idx, r_idx = np.nonzero(take_a)
    bounds = np.searchsorted(s_idx, np.arange(take_a.shape[0] + 1))
    k = k_rows[s_idx, r_idx]
    thr = packed.thr_tab[r_idx, k]
    thr_guard = np.maximum(thr, 1e-9)
    rem = packed.length.astype(np.float64, copy=True)
    frac = np.empty(len(r_idx))
    for i in range(take_a.shape[0]):
        lo, hi = bounds[i], bounds[i + 1]
        rows = r_idx[lo:hi]
        frac[lo:hi] = np.minimum(1.0, rem[rows] / thr_guard[lo:hi])
        rem[rows] -= thr[lo:hi]
    e_comp = k * power[r_idx] * slot_h * frac
    ring = np.where(k <= 1, 0.0, 2.0 * (k - 1) / np.maximum(k, 1))
    gbits = packed.comm[r_idx] * 8.0 * ring * k * frac
    e = e_comp + eta * gbits / 3600.0 / 1000.0 * slot_h
    return bounds, r_idx, k, e


def _scan_admit_slots(packed, t0, n_valid, fs, fr) -> np.ndarray:
    """Reconstruct each row's admission slot from the finish grid.

    Mirrors the vector engine exactly: a row enters the system at
    ``max(arrival, t0)``, except DAG rows wait for every predecessor and
    release the slot *after* the last one finishes.  Rows whose
    predecessors never finish (or that admit past the run) return -1."""
    admit = np.maximum(packed.arrival, t0).astype(np.int64, copy=True)
    if packed.has_deps:
        comp = np.full(packed.n, -1, dtype=np.int64)
        comp[fr] = t0 + fs
        id2row = packed.id2row
        for r, job in enumerate(packed.jobs):
            for dep in job.deps:
                c = comp[id2row[dep]]
                if c < 0:
                    admit[r] = -1
                    break
                admit[r] = max(admit[r], c + 1)
    admit[admit - t0 >= n_valid] = -1
    return admit


def _scan_slot_events(take, fs, fr, n_valid, job_ids):
    """Resume/suspend derivation from the dense take grid, in whole-run
    numpy passes.

    The same events as feeding ``SlotEventTracker.step`` the per-slot
    allocation stream (a taken row always runs at ``k_min``, so no scale
    event can fire).  Returns ``(resume_rows, resume_bounds, suspend_rows,
    suspend_bounds)``: each slot's resumes in row order (the tracker's feed
    order) and its suspends in job-id order (the tracker's order; rows are
    sorted by (arrival, job_id), which is not job-id order where ids do not
    rise with arrival)."""
    m = np.asarray(take, dtype=bool)
    n = m.shape[1]
    # on/off transitions between consecutive slots (transition index i is
    # slot i+1); slot 0 has no transitions — first activations there are
    # starts, and nothing can switch off into it.
    cs, cr = np.nonzero(m[1:] & ~m[:-1])
    # a row's first switch-on is its start (admit covers it), unless the
    # row was already running at slot 0 — then every switch-on resumes.
    uniq, first = np.unique(cr, return_index=True)
    keep = np.ones(len(cr), dtype=bool)
    keep[first[~m[0][uniq]]] = False
    rs, rr = cs[keep] + 1, cr[keep]
    # a switch-off is a suspend unless the row finished at the prior slot
    # (each row finishes at most once, so a per-row slot table suffices)
    os_, orow = np.nonzero(m[:-1] & ~m[1:])
    finslot = np.full(n, -2, dtype=np.int64)
    if len(fs):
        finslot[np.asarray(fr)] = fs
    keep = os_ != finslot[orow]
    ss, sr = os_[keep] + 1, orow[keep]
    order = np.lexsort((job_ids[sr], ss))
    ss, sr = ss[order], sr[order]
    return (rr.tolist(), np.searchsorted(rs, np.arange(n_valid + 1)),
            sr.tolist(), np.searchsorted(ss, np.arange(n_valid + 1)))


def _account_single(packed, ci, cluster, policy, t0, ys, n_valid,
                    prog, telemetry: Telemetry | None = None) -> SimResult:
    tele, prof, _, _ = _telemetry_hooks(telemetry, None)
    ci_pol = ci.degraded()
    n = packed.n
    slot_h = cluster.slot_hours
    eta = cluster.eta_net
    wait = np.zeros(n)
    violations = np.zeros(n, dtype=bool)
    completion = np.full(n, -1, dtype=np.int64)
    logs: list[SlotLog] = []
    total_energy = 0.0
    total_carbon = 0.0
    take_a = ys["take"][:n_valid, :n]
    if prog.kind == "mpc-scale":
        k_rows = np.where(ys["scaled"][:n_valid, :n], prog.k_up[None, :],
                          packed.k_min[None, :])
    else:
        k_rows = np.broadcast_to(packed.k_min, take_a.shape)
    bounds, r_idx, k_act, e_act = _active_energy(packed, prog.power, slot_h,
                                                 eta, take_a, k_rows)
    fs, fr = np.nonzero(ys["fin"][:n_valid, :n])
    fbounds = np.searchsorted(fs, np.arange(n_valid + 1))
    wfin_f = ys["waited_fin"][:n_valid, :n][fs, fr]
    viol_f = ys["viol"][:n_valid, :n][fs, fr]
    n_rows_a = ys["n_rows"][:n_valid]
    civ_a = _ci_block(ci, t0, n_valid)
    if tele is not None:
        admits_by, jids, kv, (rr, rb, sr, sb) = _event_tables(
            packed, t0, n_valid, take_a, fs, fr)
        emit = tele.emit
    if prof is not None:
        _pt = time.perf_counter()
    for i in range(n_valid):
        t = t0 + i
        civ = float(civ_a[i])
        lo, hi = bounds[i], bounds[i + 1]
        if tele is not None:
            for r in admits_by.get(t, ()):
                emit(t, "admit", job=jids[r])
            if ci_pol is not ci:
                emit(t, "forecast-read", value=float(ci_pol.staleness(t)))
            for r in rr[rb[i]:rb[i + 1]]:
                emit(t, "resume", job=jids[r], value=kv[r])
            for r in sr[sb[i]:sb[i + 1]]:
                emit(t, "suspend", job=jids[r])
        energy = 0.0
        for v in e_act[lo:hi].tolist():        # sequential sum, scalar order
            energy += v
        carbon = emissions.slot_carbon_g(energy, civ)
        total_energy += energy
        total_carbon += carbon
        flo, fhi = fbounds[i], fbounds[i + 1]
        frows = fr[flo:fhi]
        if len(frows):
            completion[frows] = t
            wait[frows] = wfin_f[flo:fhi]
            violations[frows] = viol_f[flo:fhi]
        used = int(k_act[lo:hi].sum())
        running = int(hi - lo)
        logs.append(SlotLog(slot=t, ci=civ, provisioned=prog.m_t, used=used,
                            energy_kwh=energy, carbon_g=carbon,
                            running=running,
                            queued=int(n_rows_a[i]) - len(frows) - running))
    if prof is not None:
        prof.add("execute", time.perf_counter() - _pt)
    return SimResult(
        policy=policy.name, carbon_g=total_carbon, energy_kwh=total_energy,
        slots=logs, wait_slots=wait, violations=violations,
        completion=completion, num_jobs=n,
        resilience=_run_resilience(None, ci_pol, ci, t0, t0 + n_valid))


def _event_tables(packed, t0, n_valid, take_a, fs, fr):
    """What the event decode reads per slot: the rows admitted at each slot
    (row order, as the vector engine's sorted admissions), the job ids, the
    rows' ``k_min`` as the resume value, and ``_scan_slot_events``."""
    admits_by: dict[int, list[int]] = {}
    for r, s in enumerate(_scan_admit_slots(packed, t0, n_valid, fs,
                                            fr).tolist()):
        if s >= 0:
            admits_by.setdefault(s, []).append(r)
    kv = [float(k) for k in packed.k_min.tolist()]
    return (admits_by, packed.job_ids.tolist(), kv,
            _scan_slot_events(take_a, fs, fr, n_valid, packed.job_ids))


def _account_geo(packed, mci, geo: GeoCluster, policy, t0, ys, n_valid,
                 prog: _GeoProgram,
                 telemetry: Telemetry | None = None) -> SimResult:
    """The geo engines' accounting over the emitted grids, in their float
    order: per-region energy in row order, each migration's transfer
    energy to its destination and its carbon at the destination's CI in
    row (= decision) order, then ``_accumulate_regions``.  Events in the
    geo vector engine's order: admit, forecast-read, migrate (row order,
    the decision order), resume, suspend."""
    tele, prof, _, _ = _telemetry_hooks(telemetry, None)
    ci_pol = mci.degraded()
    n = packed.n
    n_regions = geo.n_regions
    wait = np.zeros(n)
    violations = np.zeros(n, dtype=bool)
    completion = np.full(n, -1, dtype=np.int64)
    final_region = np.full(n, -1, dtype=np.int64)
    region_energy = np.zeros(n_regions)
    region_carbon = np.zeros(n_regions)
    migrations = 0
    mig_carbon_total = 0.0
    logs: list[SlotLog] = []
    total_energy = 0.0
    total_carbon = 0.0
    provisioned = int(prog.caps.sum())
    take_a = ys["take"][:n_valid, :n]
    reg_a = ys["region"][:n_valid, :n]
    bounds, r_act, k_act, e_act = _active_energy(
        packed, prog.power, geo.slot_hours, geo.eta_net, take_a,
        np.broadcast_to(packed.k_min, take_a.shape))
    areg_act = reg_a[np.repeat(np.arange(n_valid), np.diff(bounds)), r_act]
    fs, fr = np.nonzero(ys["fin"][:n_valid, :n])
    fbounds = np.searchsorted(fs, np.arange(n_valid + 1))
    wfin_f = ys["waited_fin"][:n_valid, :n][fs, fr]
    viol_f = ys["viol"][:n_valid, :n][fs, fr]
    ms_idx, mr_idx = np.nonzero(ys["mig_now"][:n_valid, :n])
    mbounds = np.searchsorted(ms_idx, np.arange(n_valid + 1))
    n_rows_a = ys["n_rows"][:n_valid]
    civ_a = _ci_vec_acct_block(mci, t0, n_valid)
    if tele is not None:
        admits_by, jids, kv, (rr, rb, sr, sb) = _event_tables(
            packed, t0, n_valid, take_a, fs, fr)
        emit = tele.emit
    if prof is not None:
        _pt = time.perf_counter()
    for i in range(n_valid):
        t = t0 + i
        ci_vec = civ_a[i]
        lo, hi = bounds[i], bounds[i + 1]
        mrows = mr_idx[mbounds[i]:mbounds[i + 1]]
        if tele is not None:
            for r in admits_by.get(t, ()):
                emit(t, "admit", job=jids[r])
            if ci_pol is not mci:
                emit(t, "forecast-read", value=float(ci_pol.staleness(t)))
            for row in mrows.tolist():             # decision order
                src = (int(reg_a[i - 1, row]) if i > 0
                       else geo.home_region(row))
                emit(t, "migrate", job=jids[row],
                     value=float(reg_a[i, row]), detail=f"from={src}")
            for r in rr[rb[i]:rb[i + 1]]:
                emit(t, "resume", job=jids[r], value=kv[r])
            for r in sr[sb[i]:sb[i + 1]]:
                emit(t, "suspend", job=jids[r])
        e_vec = e_act[lo:hi]
        a_regions = areg_act[lo:hi]
        energy_r = np.zeros(n_regions)
        for r in range(n_regions):
            for v in e_vec[a_regions == r].tolist():   # sequential, row order
                energy_r[r] += v
        mc = 0.0
        for row in mrows.tolist():             # row order == decision order
            e = prog.mig_e[row]
            dest = int(reg_a[i, row])
            energy_r[dest] += e
            mc += e * ci_vec[dest]
        mig_carbon_total += mc
        migrations += len(mrows)
        energy, carbon = _accumulate_regions(energy_r, ci_vec,
                                             region_energy, region_carbon)
        total_energy += energy
        total_carbon += carbon
        flo, fhi = fbounds[i], fbounds[i + 1]
        frows = fr[flo:fhi]
        if len(frows):
            completion[frows] = t
            wait[frows] = wfin_f[flo:fhi]
            violations[frows] = viol_f[flo:fhi]
            final_region[frows] = reg_a[i, frows]
        used = int(k_act[lo:hi].sum())
        running = int(hi - lo)
        logs.append(SlotLog(slot=t, ci=float(np.mean(ci_vec)),
                            provisioned=provisioned, used=used,
                            energy_kwh=energy, carbon_g=carbon,
                            running=running,
                            queued=int(n_rows_a[i]) - len(frows) - running))
    if prof is not None:
        prof.add("execute", time.perf_counter() - _pt)
    return SimResult(
        policy=policy.name, carbon_g=total_carbon, energy_kwh=total_energy,
        slots=logs, wait_slots=wait, violations=violations,
        completion=completion, num_jobs=n, regions=geo.regions,
        region_carbon_g=region_carbon, region_energy_kwh=region_energy,
        final_region=final_region, migrations=migrations,
        migration_carbon_g=mig_carbon_total,
        resilience=_run_resilience(None, ci_pol, mci, t0, t0 + n_valid))


# --- public API --------------------------------------------------------------


def simulate_scan(jobs, ci, cluster, policy, t0: int = 0,
                  horizon: int | None = None, max_overrun: int = 24 * 21,
                  faults=None, telemetry: Telemetry | None = None,
                  device: str | torch.device = "cuda") -> SimResult:
    """``simulate(..., engine="scan")``: the device slot loop for native
    policies, the vector engine otherwise (and for any fault process)."""
    return simulate_many_scan([SimCase(
        jobs=jobs, ci=ci, cluster=cluster, policy=policy, t0=t0,
        horizon=horizon, max_overrun=max_overrun, faults=faults,
        engine="scan", telemetry=telemetry, device=device)])[0]


@dataclasses.dataclass
class _Member:
    index: int
    case: SimCase
    packed: PackedJobs
    prog: _SingleProgram | _GeoProgram


def simulate_many_scan(cases: Sequence[SimCase],
                       packs: dict | None = None) -> list[SimResult]:
    """Batch path: group native cases by structure and run each group as
    batched device programs of up to BATCH_TILE cells; everything else runs
    on the vector engine.  ``packs`` shares packed job lists with the
    caller (keyed by the list's identity)."""
    packs = {} if packs is None else packs
    results: list[SimResult | None] = [None] * len(cases)
    groups: dict[tuple, list[_Member]] = {}
    geo_groups: dict[tuple, list[_Member]] = {}
    delegated: dict[str, int] = {}
    for i, case in enumerate(cases):
        device = resolve_device(case.device)
        packed = packed_for(case.jobs, packs)
        is_geo = isinstance(case.cluster, GeoCluster)
        kind = native_kind(case.policy, is_geo, case.faults)
        # the event decode assumes k == k_min: a recorded scale-up cell runs
        # on the vector engine, whose tracker sees its scale events
        scale_recorded = (kind == "mpc-scale" and case.telemetry is not None
                          and case.telemetry.recorder is not None)
        if (kind is None or scale_recorded or packed.n == 0
                or (is_geo and packed.has_deps)):
            if packed.n > 0:
                if case.faults is not None:
                    stats["fault_delegated"] += 1
                elif scale_recorded:
                    stats["telemetry_delegated"] += 1
                else:
                    who = type(case.policy).__name__
                    delegated[who] = delegated.get(who, 0) + 1
            # geo + deps runs the geo vector engine, which refuses DAG jobs
            fn = _simulate_geo_vector if is_geo else _simulate_vector
            results[i] = fn(case.jobs, case.ci, case.cluster, case.policy,
                            case.t0, case.horizon, case.max_overrun,
                            case.faults, packed=packed,
                            telemetry=case.telemetry)
            continue
        horizon = int(case.horizon if case.horizon is not None
                      else len(case.ci) - case.t0)
        ci_pol = case.ci.degraded()
        case.policy.on_window_start(ci_pol, case.t0, horizon, packed.jobs,
                                    case.cluster)
        if is_geo:
            prog = _build_geo(packed, case.cluster, case.policy, ci_pol,
                              case.t0, horizon, kind)
            key = (str(device), kind, prog.n_pad, case.cluster.n_regions,
                   prog.lookahead, len(prog.mig_vals), horizon,
                   horizon + case.max_overrun)
            geo_groups.setdefault(key, []).append(_Member(i, case, packed, prog))
            continue
        prog = _build_single(packed, case.cluster, case.policy, ci_pol, kind,
                             case.t0, horizon)
        # cells of one tile share the predecessor graph, so DAG cells group
        # by job list; the MPC tables' shapes and the fill join the key
        key = (str(device), prog.n_pad, kind, prog.xs_dims, prog.uniform,
               horizon, horizon + case.max_overrun,
               id(packed) if packed.has_deps else None)
        groups.setdefault(key, []).append(_Member(i, case, packed, prog))
    for key, members in groups.items():
        device = torch.device(key[0])
        graph = None
        if members[0].packed.has_deps:
            graph = _dep_graph(members[0].packed, members[0].prog.n_pad, device)
        for lo in range(0, len(members), BATCH_TILE):
            _run_single_tile(members[lo:lo + BATCH_TILE], graph, device,
                             results)
    for key, members in geo_groups.items():
        for lo in range(0, len(members), BATCH_TILE):
            _run_geo_tile(members[lo:lo + BATCH_TILE], torch.device(key[0]),
                          results)
    if delegated:
        stats["delegated"] += sum(delegated.values())
        _log.info("scan batch: %d case(s) delegated to the vector engine "
                  "(%s)", sum(delegated.values()),
                  ", ".join(f"{k} x{v}" for k, v in sorted(delegated.items())))
    return results  # type: ignore[return-value]


def _run_single_tile(members: list[_Member], graph, device, results) -> None:
    """One batched program over structurally identical cells."""
    progs = [m.prog for m in members]
    c = _stacked(progs, "consts", device)
    carry = _stacked(progs, "carry0", device)
    case0 = members[0].case
    horizon = int(case0.horizon if case0.horizon is not None
                  else len(case0.ci) - case0.t0)
    kind, uniform = progs[0].kind, progs[0].uniform
    ys_types = dict(_YS_TYPES, **({"scaled": torch.bool}
                                  if kind == "mpc-scale" else {}))
    counters = (("dag_steps",) if graph is not None else ()) + (
        ("fill_steps",) if not uniform else ())

    def step(c, carry, x):
        return _single_step(c, carry, x, graph, kind, uniform)

    t_loop = time.perf_counter()
    ys_all = _collect_chunks(
        c, carry, step, np.array([m.case.t0 for m in members], dtype=np.int64),
        [p.xs_fn for p in progs], progs[0].n_pad, horizon,
        horizon + case0.max_overrun, device, ys_types, counters)
    t_acct = time.perf_counter()
    stats["loop_s"] += t_acct - t_loop
    _profile_loop(members, t_acct - t_loop)
    for j, m in enumerate(members):
        ys = {k: v[j] for k, v in ys_all.items()}
        ended = ys["ended"]
        n_valid = int(np.argmax(ended)) if ended.any() else len(ended)
        results[m.index] = _account_single(
            m.packed, m.case.ci, m.case.cluster, m.case.policy, m.case.t0, ys,
            n_valid, m.prog, telemetry=m.case.telemetry)
    stats["account_s"] += time.perf_counter() - t_acct


def _profile_loop(members: list[_Member], seconds: float) -> None:
    """The tile's chunk loop is shared (its per-chunk copies wait for the
    device): split its seconds evenly over the cells' ``decide`` phase, so
    per-cell phase totals still sum to real time."""
    for m in members:
        tel = m.case.telemetry
        if tel is not None and tel.profiler is not None:
            tel.profiler.add("decide", seconds / len(members))


def _stacked(progs, part: str, device) -> dict:
    """A tile's constants or initial carry: each cell's arrays stacked
    along a leading B axis, on ``device``."""
    first = getattr(progs[0], part)
    return {k: torch.from_numpy(np.stack([getattr(p, part)[k] for p in progs]))
            .to(device) for k in first}


def _run_geo_tile(members: list[_Member], device, results) -> None:
    """One batched geo program over structurally identical cells."""
    progs = [m.prog for m in members]
    kind = progs[0].kind
    case0 = members[0].case
    horizon = int(case0.horizon if case0.horizon is not None
                  else len(case0.ci) - case0.t0)

    def step(c, carry, x):
        return _geo_step(c, carry, x, kind)

    t_loop = time.perf_counter()
    ys_all = _collect_chunks(
        _stacked(progs, "consts", device), _stacked(progs, "carry0", device),
        step, np.array([m.case.t0 for m in members], dtype=np.int64),
        [p.xs_fn for p in progs], progs[0].n_pad, horizon,
        horizon + case0.max_overrun, device, _GEO_YS_TYPES, ("geo_steps",))
    t_acct = time.perf_counter()
    stats["loop_s"] += t_acct - t_loop
    _profile_loop(members, t_acct - t_loop)
    for j, m in enumerate(members):
        ys = {k: v[j] for k, v in ys_all.items()}
        ended = ys["ended"]
        n_valid = int(np.argmax(ended)) if ended.any() else len(ended)
        results[m.index] = _account_geo(
            m.packed, m.case.ci, m.case.cluster, m.case.policy, m.case.t0, ys,
            n_valid, m.prog, telemetry=m.case.telemetry)
    stats["account_s"] += time.perf_counter() - t_acct
