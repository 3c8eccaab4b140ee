"""The placement and capacity walk of the geo slot loop: the hand-written
CUDA kernel and its plain PyTorch version.

Each slot the geo program of the device slot loop (``core/scan_engine.py``)
resolves, for every cell of its batch, what the cell's geo policy decides
for its candidate rows (active, unfinished, not migrating), walking them in
FCFS order: the forced candidates by row, then the unforced candidates by
row.  A started row migrates when moving beats staying by the policy's
margin (geo-greedy prices the current CI, geo-flex the forecast window
means past the migration window); a row that has never run and has no
region yet is placed in the first region of its preference order with room;
a row runs at ``k_min`` in its region when the region still has room (and,
for geo-flex, the slot is eligible or the row is forced).  This is
``_geo_resolve_walk`` of the JAX scan engine
(``src/repro/core/scan_engine.py:891-1002``), which no Pallas kernel
computes.  The reference's other form, ``_geo_resolve_uniform``
(``:751-888``), reaches the same result by a fill-key fixpoint whose round
count depends on the data; it is the TPU's way around a serial scan and has
no counterpart here: on the card one warp walks, whether ``k_min`` is
uniform or not.

``geo_resolve(kind, cand, forced, state, consts, tables)`` takes ``kind``
(``"geo-static"``, ``"geo-greedy"`` or ``"geo-flex"``), (B, n) bool
``cand`` and ``forced``, and three dicts of tensors:

- ``state`` — the carry of the geo program, (B, n): ``remaining``
  (float64), ``slack`` (int64), ``started`` and ``placed`` (bool),
  ``pol_region``, ``eng_region``, ``mig_left`` and ``moves`` (int64);
- ``consts`` — the row constants (B, n): ``kmin`` (int64), ``ec`` and
  ``mig_e`` (float64), ``mig_slots`` and ``mig_idx`` (int64); per cell
  ``caps`` (B, R) int64, ``margin_c`` (B,) float64 and ``max_moves`` (B,)
  int64;
- ``tables`` — the slot's tables: ``ci_now`` (B, R) float64 (geo-greedy and
  geo-flex), ``clean_order`` (B, R) int64 (geo-greedy), ``thresh_eps`` (B,
  R), ``means`` (B, R, H) and ``movemeans`` (B, M, R, H) float64 (geo-flex).

It returns ``(take, placed, pol_region, eng_region, mig_left, moves,
mig_now)``, (B, n) each, new tensors.  On CPU tensors it runs
``geo_resolve_plain``; on CUDA tensors it launches the kernel of
``csrc/geo_walk.cu`` (one block per cell, ``plan``) or raises.  Each launch
adds one to ``launches["geo_walk"]``.  The float64 products and sums of the
migration rule are single IEEE operations on both sides (the kernel writes
them with ``__dmul_rn``/``__dadd_rn``), so the two agree exactly.

The kernel is compiled at first use with ``nvcc`` for ``sm_90a`` into
``build/`` at the root of the checkout and loaded through ``ctypes``; a
failed build raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ._build import build_library

# The kernel's constants (csrc/geo_walk.cu): threads a block, the rows of a
# chunk (one warp's ballot), the most regions its shared tables hold, and
# the shared memory a block may use without opting in.
THREADS = 256
CHUNK = 32
MAX_REGIONS = 16
SMEM_LIMIT = 48 * 1024
KINDS = ("geo-static", "geo-greedy", "geo-flex")

#: Kernel launches since the last ``reset_launches()``.
launches = {"geo_walk": 0}

_lib: ctypes.CDLL | None = None
_stream = None                  # device index -> the current stream's handle

_STATE = dict(remaining=torch.float64, slack=torch.int64, started=torch.bool,
              placed=torch.bool, pol_region=torch.int64, eng_region=torch.int64,
              mig_left=torch.int64, moves=torch.int64)
_ROW_CONSTS = dict(kmin=torch.int64, ec=torch.float64, mig_e=torch.float64,
                   mig_slots=torch.int64, mig_idx=torch.int64)
_CELL_CONSTS = dict(caps=torch.int64, margin_c=torch.float64, max_moves=torch.int64)
_TABLES = {"geo-static": {},
           "geo-greedy": dict(ci_now=torch.float64, clean_order=torch.int64),
           "geo-flex": dict(ci_now=torch.float64, thresh_eps=torch.float64,
                            means=torch.float64, movemeans=torch.float64)}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def plan(cells: int, n: int, regions: int) -> dict:
    """The launch for ``cells`` cells of ``n`` rows over ``regions``
    regions: one block of THREADS per cell (block ``b`` walks cell ``b``);
    ``chunks`` chunks of CHUNK rows, whose two ballot masks (forced and
    unforced candidates left to walk) take ``smem_bytes`` of dynamic shared
    memory, beside the static per-region tables (used, capacity, CI,
    threshold, CI order) of MAX_REGIONS entries.  Warp ``w`` copies and
    settles chunks ``w, w + THREADS / 32, ...``; warp 0 walks them."""
    if cells < 0 or n < 0:
        raise ValueError(f"no launch for {cells} cells of {n} rows")
    if not 1 <= regions <= MAX_REGIONS:
        raise ValueError(f"{regions} regions: the kernel holds 1 to {MAX_REGIONS}")
    if cells >= 2 ** 31:
        raise ValueError(f"{cells} cells exceed the grid")
    chunks = -(-n // CHUNK)
    smem = 2 * 4 * chunks
    if smem > SMEM_LIMIT:
        raise ValueError(f"{n} rows need {smem} bytes of chunk masks, more than "
                         f"{SMEM_LIMIT}")
    return dict(blocks=cells, threads=THREADS, chunks=chunks, smem_bytes=smem)


def geo_resolve_plain(kind: str, cand: torch.Tensor, forced: torch.Tensor,
                      state: dict, consts: dict, tables: dict) -> tuple:
    """The literal row walk of the reference, on Python scalars: per cell,
    the candidates in key order, each decided against the regions' ``used``
    before it."""
    if kind not in KINDS:
        raise ValueError(f"unknown geo kind {kind!r}; use one of {KINDS}")
    b, n = cand.shape
    rows = {k: state[k].tolist() for k in _STATE}
    rc = {k: consts[k].tolist() for k in (*_ROW_CONSTS, *_CELL_CONSTS)}
    tab = {k: tables[k].tolist() for k in _TABLES[kind]}
    cand_l, forced_l = cand.tolist(), forced.tolist()
    take = [[False] * n for _ in range(b)]
    mig_now = [[False] * n for _ in range(b)]
    placed_o = [list(x) for x in rows["placed"]]
    polr_o = [list(x) for x in rows["pol_region"]]
    engr_o = [list(x) for x in rows["eng_region"]]
    migl_o = [list(x) for x in rows["mig_left"]]
    moves_o = [list(x) for x in rows["moves"]]
    for c in range(b):
        caps = rc["caps"][c]
        n_r = len(caps)
        used = [0] * n_r
        ci = tab["ci_now"][c] if "ci_now" in tab else None
        order = ([i for i in range(n) if cand_l[c][i] and forced_l[c][i]]
                 + [i for i in range(n) if cand_l[c][i] and not forced_l[c][i]])
        for row in order:
            k = rc["kmin"][c][row]
            rv = rows["remaining"][c][row]
            strt = rows["started"][c][row]
            placed = rows["placed"][c][row]
            polr = rows["pol_region"][c][row]
            engr = rows["eng_region"][c][row]
            newly = False
            if kind == "geo-static":
                r = r_new = engr
            else:
                if kind == "geo-greedy":
                    adopt = strt and not placed
                    polr0 = engr if adopt else polr
                    placed0 = placed or adopt
                    pref = tab["clean_order"][c]
                else:
                    polr0, placed0 = polr, placed
                    h_lut = len(tab["means"][c][0])
                    hp = int(min(float(h_lut), max(1.0, float(math.ceil(rv)))))
                    col = min(max(hp - 1, 0), h_lut - 1)
                    means_h = [tab["means"][c][i][col] for i in range(n_r)]
                    pref = sorted(range(n_r), key=means_h.__getitem__)   # stable
                r_place = next((int(q) for q in pref if used[q] + k <= caps[q]), None)
                newly = not strt and not placed0 and r_place is not None
                placed1 = placed0 or newly
                r_new = r_place if newly else polr0
                r = engr if kind == "geo-flex" and strt else r_new
            do_mig, best, ms = False, r, 0
            if kind != "geo-static":
                ms = rc["mig_slots"][c][row]
                can = (strt and rows["moves"][c][row] < rc["max_moves"][c]
                       and rows["slack"][c][row] > ms + 1 and rv > float(ms))
                ec, mig_e = rc["ec"][c][row], rc["mig_e"][c][row]
                if kind == "geo-greedy":
                    e_run = ec * max(1.0, float(math.ceil(rv)))
                    stay = ci[r] * e_run
                    move = [ci[i] * e_run + mig_e * ci[i] for i in range(n_r)]
                else:
                    h_lut = len(tab["means"][c][0])
                    hm = min(float(h_lut - ms), max(1.0, float(math.ceil(rv))))
                    can = can and hm >= 1.0
                    hi = min(max(int(hm) - 1, 0), h_lut - 1)
                    e_run = ec * hm
                    stay = tab["means"][c][r][hi] * e_run
                    mm = tab["movemeans"][c][rc["mig_idx"][c][row]]
                    move = [mm[i][hi] * e_run + mig_e * ci[i] for i in range(n_r)]
                move[r] = math.inf
                best = min(range(n_r), key=move.__getitem__)        # first smallest
                do_mig = bool(can and move[best] < stay * rc["margin_c"][c])
            elig = (kind != "geo-flex" or forced_l[c][row]
                    or ci[r] <= tab["thresh_eps"][c][r])
            placeable = kind == "geo-static" or strt or placed or newly
            run = (not do_mig) and placeable and elig and used[r] + k <= caps[r]
            if run:
                used[r] += k
            take[c][row] = bool(run)
            mig_now[c][row] = do_mig
            if kind != "geo-static":
                placed_o[c][row] = bool(placed1 or do_mig)
                polr_o[c][row] = best if do_mig else r_new
                engr_o[c][row] = best if do_mig else (r if run and not strt else engr)
            if do_mig:
                migl_o[c][row] = ms
                moves_o[c][row] += 1

    def tensor(x, dtype):
        return torch.tensor(x, dtype=dtype, device=cand.device).reshape(b, n)

    return (tensor(take, torch.bool), tensor(placed_o, torch.bool),
            tensor(polr_o, torch.int64), tensor(engr_o, torch.int64),
            tensor(migl_o, torch.int64), tensor(moves_o, torch.int64),
            tensor(mig_now, torch.bool))


class _Args(ctypes.Structure):
    """``GeoArgs`` of ``csrc/geo_walk.cu``, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "cand", "forced", "rem", "slack", "started", "placed", "pol_region",
        "eng_region", "mig_left", "moves", "kmin", "ec", "mig_e", "mig_slots",
        "mig_idx", "caps", "margin_c", "max_moves", "ci_now", "clean_order",
        "thresh_eps", "means", "movemeans", "take", "placed_out", "pol_out",
        "eng_out", "mig_left_out", "moves_out", "mig_now")]
        + [("cells", ctypes.c_longlong)]
        + [(name, ctypes.c_int) for name in (
            "n", "regions", "lookahead", "mig_vals", "kind")])


def build() -> str:
    """Compile ``csrc/geo_walk.cu`` (once per source version) and load it.
    Returns the compiler's report when this call compiled."""
    global _lib, _stream
    if _lib is not None:
        return ""
    lib, log = build_library("geo_walk")
    lib.geo_walk.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    lib.geo_walk_floor.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p]
    for fn in (lib.geo_walk, lib.geo_walk_floor):
        fn.restype = ctypes.c_int
    _stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
        lambda dev: torch.cuda.current_stream(dev).cuda_stream)
    _lib = lib
    return log


def _check(name: str, x: torch.Tensor, dtype, shape, dev: int) -> None:
    if x.get_device() != dev:
        raise ValueError(f"{name} lies on {x.device}, not on cuda:{dev}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def geo_resolve(kind: str, cand: torch.Tensor, forced: torch.Tensor,
                state: dict, consts: dict, tables: dict) -> tuple:
    """See the module docstring; on CUDA tensors one launch of the kernel."""
    if kind not in KINDS:
        raise ValueError(f"unknown geo kind {kind!r}; use one of {KINDS}")
    need = {**{k: state[k] for k in _STATE},
            **{k: consts[k] for k in (*_ROW_CONSTS, *_CELL_CONSTS)},
            **{k: tables[k] for k in _TABLES[kind]}}
    if cand.get_device() < 0 and all(x.get_device() < 0 for x in need.values()):
        return geo_resolve_plain(kind, cand, forced, state, consts, tables)
    dev = cand.get_device()
    if dev < 0:
        raise ValueError("cand lies on the CPU while other inputs lie on the card")
    b, n = cand.shape if cand.dim() == 2 else (-1, -1)
    n_r = consts["caps"].shape[-1]
    means = tables.get("means")
    h = means.shape[-1] if means is not None else 1
    m = tables["movemeans"].shape[1] if "movemeans" in tables else 1
    _check("cand", cand, torch.bool, (b, n), dev)
    _check("forced", forced, torch.bool, (b, n), dev)
    for name, dtype in {**_STATE, **_ROW_CONSTS}.items():
        _check(name, need[name], dtype, (b, n), dev)
    _check("caps", need["caps"], torch.int64, (b, n_r), dev)
    _check("margin_c", need["margin_c"], torch.float64, (b,), dev)
    _check("max_moves", need["max_moves"], torch.int64, (b,), dev)
    shapes = dict(ci_now=(b, n_r), clean_order=(b, n_r), thresh_eps=(b, n_r),
                  means=(b, n_r, h), movemeans=(b, m, n_r, h))
    for name, dtype in _TABLES[kind].items():
        _check(name, need[name], dtype, shapes[name], dev)
    plan(b, n, n_r)
    outs = [torch.empty((b, n), dtype=dt, device=cand.device) for dt in (
        torch.bool, torch.bool, torch.int64, torch.int64, torch.int64, torch.int64,
        torch.bool)]
    if b * n == 0:
        return tuple(outs)
    build()

    def ptr(name):
        x = need.get(name)
        return x.data_ptr() if x is not None else None

    args = _Args(cand.data_ptr(), forced.data_ptr(), ptr("remaining"), ptr("slack"),
                 ptr("started"), ptr("placed"), ptr("pol_region"), ptr("eng_region"),
                 ptr("mig_left"), ptr("moves"), ptr("kmin"), ptr("ec"), ptr("mig_e"),
                 ptr("mig_slots"), ptr("mig_idx"), ptr("caps"), ptr("margin_c"),
                 ptr("max_moves"), ptr("ci_now"), ptr("clean_order"), ptr("thresh_eps"),
                 ptr("means"), ptr("movemeans"), *(o.data_ptr() for o in outs),
                 b, n, n_r, h, m, KINDS.index(kind))
    err = _lib.geo_walk(ctypes.byref(args), _stream(dev))
    if err != 0:
        raise RuntimeError(f"geo_walk failed with cudaError_t {err}")
    launches["geo_walk"] += 1
    take, placed, pol_region, eng_region, mig_left, moves, mig_now = outs
    return take, placed, pol_region, eng_region, mig_left, moves, mig_now
