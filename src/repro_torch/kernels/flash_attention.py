"""Causal GQA flash attention: the hand-written CUDA kernels and their plain
PyTorch version (the counterpart of ``src/repro/kernels/flash_attention.py``
``gqa_flash``).

``gqa_flash(q, k, v, causal_offset=0)`` takes q (B, Sq, Hq, D) and k/v
(B, Sk, Hkv, D), Hq a multiple of Hkv, query head h reading KV head
h // (Hq // Hkv), and returns (B, Sq, Hq, D) in q's dtype: softmax of
q.k / sqrt(D), masked to ``causal_offset + q_row >= k_row``, times v, in
fp32.  On CPU tensors it runs ``gqa_flash_plain``; on CUDA tensors it
launches a kernel of ``csrc/flash_attention.cu`` (float32 or bfloat16,
D in {16, 32, 64, 112, 128}, unit stride along D) or raises.  ``route`` picks
the kernel from the dtype and D alone (``ROUTES``): bf16 at D in {64, 112,
128} goes to the Hopper kernel (wgmma fed by TMA; llama3-8b and the MoE
configs take 64 or 128, zamba2-7b's shared attention 112, which runs on
the D = 128 instantiation over tiles whose columns 112..127 TMA fills with
zeros, storing 112 columns), bf16 at D in {16, 32} to the ``mma.sync``
kernel (the example trainers' heads: ``repro_torch.examples.
train_carbon_aware``'s tiny preset has D 16), fp32 to the fp32 kernel.
``plan`` does the shape and stride arithmetic of a launch (the route, the
grid, and the Hopper kernel's tensor maps and shared memory) and runs on any
tensors.  Each launch adds one to ``launches["gqa_flash"]`` and one to the
count of its route.

The gradient: when grad mode is on and q, k or v requires grad,
``gqa_flash`` runs through ``FlashAttention`` (a ``torch.autograd.Function``)
and saves q, k, v, the output and, on the Hopper route, each row's
log-sum-exp that the forward kernel wrote beside it.  Its backward is
``gqa_flash_bwd``: on CPU tensors ``gqa_flash_bwd_plain``, the explicit
fp32 gradient of ``gqa_flash_plain``; on CUDA tensors the kernels of
``csrc/flash_attention_bwd.cu`` on the route ``bwd_route`` picks from the
dtype and D alone (``BWD_ROUTES``): "wgmma" for bf16 at D in {64, 112, 128}
(two Hopper kernels, dQ then dK/dV, reading the forward's LSE; their plain
version is ``gqa_flash_bwd_lse_plain``), "fma" for fp32 and bf16 D in {16,
32} (three fp32 FMA kernels: row statistics, dK/dV, dQ), planned by
``plan_bwd``.  Each backward adds one to ``launches["gqa_flash_bwd"]`` and
one to each of its kernels' counts.  Under ``no_grad``, or on tensors that
need no grad, ``gqa_flash`` is the serving path above, unchanged: it asks
for no LSE, and the output's bits do not depend on it.

On ``meta`` tensors (the dry-run's op counting, ``launch/dryrun.py``) the
forward and the backward return their outputs' shapes and dtypes, launch
nothing, and report the work of the kernels their route would launch to
``launch/op_analysis.py::record_kernel`` (``kernel_work``).
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from ._build import build_library

#: Kernel launches since the last ``reset_launches()``: all of them under
#: "gqa_flash", and each under its route.
launches = {"gqa_flash": 0, "wgmma": 0, "mma_sync": 0, "fp32": 0,
            "gqa_flash_bwd": 0, "bwd_stats": 0, "bwd_dkdv": 0, "bwd_dq": 0,
            "bwd_wgmma_dq": 0, "bwd_wgmma_dkdv": 0}

HEAD_DIMS = (16, 32, 64, 112, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The kernel of each (dtype, D).
ROUTES = {(torch.bfloat16, 64): "wgmma", (torch.bfloat16, 112): "wgmma",
          (torch.bfloat16, 128): "wgmma", (torch.bfloat16, 16): "mma_sync",
          (torch.bfloat16, 32): "mma_sync", (torch.float32, 16): "fp32",
          (torch.float32, 32): "fp32", (torch.float32, 64): "fp32",
          (torch.float32, 112): "fp32", (torch.float32, 128): "fp32"}
#: Head dims of the Hopper kernel, and the width of the tiles each runs on.
WGMMA_TILE_DIM = {64: 64, 112: 128, 128: 128}

# The Hopper kernel's tiling (csrc/flash_attention.cu, namespace hopper).
WGMMA_ROWS = 128        # query rows per block
WGMMA_KEYS = 128        # keys per tile; the K/V boxes' rows
TMA_BOX_COLS = 64       # bf16 per 128-byte swizzled row: a box's inner extent
# The mma.sync and fp32 kernels' tiling: query rows per block (grid
# (ceil(Sq / 64), Hq, B)).
FWD_ROWS = 64

#: The backward's route of each (dtype, D): the Hopper kernels where the
#: forward's route writes the LSE, the fp32 FMA kernels elsewhere.
BWD_ROUTES = {(dtype, d): "wgmma" if ROUTES[(dtype, d)] == "wgmma" else "fma"
              for dtype, d in ROUTES}

# The fma route's tiling (csrc/flash_attention_bwd.cu).
BWD_ROWS = 64           # query rows per tile
BWD_KEYS = 64           # keys per tile
BWD_THREADS = 256
#: The fma route's kernels in launch order, by their ``which`` in the C entry.
BWD_KERNELS = ("bwd_stats", "bwd_dkdv", "bwd_dq")

# The wgmma route's tiling (csrc/flash_attention_bwd.cu, namespace wg).
BWD_WGMMA_BOX_ROWS = 64     # rows of a TMA box, and of each consumer's share
BWD_WGMMA_DQ_ROWS = 128     # dQ: query rows per block
BWD_WGMMA_DQ_KEYS = 64      # dQ: keys per tile
BWD_WGMMA_KV_KEYS = 64      # dK/dV: keys per block
BWD_WGMMA_KV_ROWS = 64      # dK/dV: query rows per tile
BWD_WGMMA_STAGES = 4        # ring depth of either kernel
#: The wgmma route's kernels in launch order, by their ``which`` in the C entry.
BWD_WGMMA_KERNELS = ("bwd_wgmma_dq", "bwd_wgmma_dkdv")

_lib: ctypes.CDLL | None = None
_bwd_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def gqa_flash_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal_offset: int = 0) -> torch.Tensor:
    """The reference's ``flash_attention_ref``: fp32 scores, -1e30 mask,
    softmax, fp32 product with v, cast to q's dtype."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(d)
    qpos = causal_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    s = torch.where(qpos[:, None] >= kpos[None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


def _masked_scores(q: torch.Tensor, k: torch.Tensor, causal_offset: int):
    """fp32 q.k / sqrt(D) of each (KV head, group member, row, key), -1e30
    where the key is masked, and the grouped fp32 q."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (1.0 / math.sqrt(d))
    qpos = causal_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    return torch.where(qpos[:, None] >= kpos[None, :], s, -1e30), qg


def _bwd_from_p(p, qg, q, k, v, o, do, round_bf16: bool = False):
    """(dq, dk, dv) from the probabilities p (B, Hkv, G, Sq, Sk), in fp32:
    D_i = dO_i . O_i, dS = P (dO V^T - D), dq = dS K / sqrt(D),
    dk = dS^T Q / sqrt(D), dv = P^T dO; with ``round_bf16`` P and dS are
    rounded to bf16 before the products that read them."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    dog = do.reshape(b, sq, hkv, g, d).float()
    kf, vf = k.float(), v.float()
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vf)
    dvec = (dog * o.reshape(b, sq, hkv, g, d).float()).sum(-1).permute(0, 2, 3, 1)
    ds = p * (dp - dvec[..., None])
    if round_bf16:
        p, ds = p.bfloat16().float(), ds.bfloat16().float()
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    return (dq.reshape(b, sq, hq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def gqa_flash_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, causal_offset: int = 0):
    """The explicit fp32 gradient of ``gqa_flash_plain``: (dq, dk, dv) in the
    dtypes of q, k and v.  P is the forward's softmax; with D_i = dO_i . O_i
    (o, the forward's output, as the kernels read it), dS = P (dO V^T - D),
    dq = dS K / sqrt(D), dk = dS^T Q / sqrt(D) and dv = P^T dO, dk and dv
    summed over each KV head's query heads."""
    s, qg = _masked_scores(q, k, causal_offset)
    return _bwd_from_p(torch.softmax(s, dim=-1), qg, q, k, v, o, do)


def gqa_flash_lse_plain(q: torch.Tensor, k: torch.Tensor,
                        causal_offset: int = 0) -> torch.Tensor:
    """Each row's log-sum-exp of its masked scores q.k / sqrt(D) in fp32,
    (B, Hq, Sq): what the Hopper forward kernel writes for the backward."""
    b, sq, hq, _ = q.shape
    s, _ = _masked_scores(q, k, causal_offset)
    return torch.logsumexp(s, dim=-1).reshape(b, hq, sq)


def gqa_flash_bwd_lse_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                            causal_offset: int = 0, round_bf16: bool = False):
    """The plain version of the wgmma route's two kernels: P = exp(S / sqrt(D)
    - LSE) from the given LSE (B, Hq, Sq), 0 where masked, then the gradient
    as ``gqa_flash_bwd_plain``; with ``round_bf16`` P and dS are rounded to
    bf16 where the kernels round them (P for dv, dS for dq and dk)."""
    b, sq, hq, _ = q.shape
    hkv = k.shape[2]
    s, qg = _masked_scores(q, k, causal_offset)
    lse = lse.float().reshape(b, hkv, hq // hkv, sq, 1)
    p = torch.where(s > -1e30, torch.exp(s - lse), 0.0)
    return _bwd_from_p(p, qg, q, k, v, o, do, round_bf16)


def build() -> str:
    """Compile ``csrc/flash_attention.cu`` (once per source version) and
    load it.  Returns the compiler's report when this call compiled."""
    global _lib
    if _lib is not None:
        return ""
    lib, log = build_library("flash_attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gqa_flash_fwd.argtypes = [i, p, p, p, p] + [i] * 7 + [ll] * 9 + [i] * 3 + [p]
    lib.gqa_flash_fwd.restype = i
    lib.gqa_flash_wgmma.argtypes = [p] * 5 + [i] * 7 + [p] + [i] * 3 + [ll, p]
    lib.gqa_flash_wgmma.restype = i
    _lib = lib
    return log


def build_bwd() -> str:
    """Compile ``csrc/flash_attention_bwd.cu`` (once per source version) and
    load it.  Returns the compiler's report when this call compiled."""
    global _bwd_lib
    if _bwd_lib is not None:
        return ""
    lib, log = build_library("flash_attention_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gqa_flash_bwd.argtypes = [i, i] + [p] * 10 + [i] * 10 + [ctypes.c_longlong, p]
    lib.gqa_flash_bwd.restype = i
    lib.gqa_flash_bwd_wgmma.argtypes = [i] + [p] * 10 + [i] * 7 + [p] + [i] * 3 + \
        [ctypes.c_longlong, p]
    lib.gqa_flash_bwd_wgmma.restype = i
    _bwd_lib = lib
    return log


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel that ``gqa_flash`` launches for this dtype and head dim."""
    try:
        return ROUTES[(dtype, d)]
    except KeyError:
        raise ValueError(f"no kernel takes {dtype} at head dim {d}: dtypes "
                         f"{list(_DTYPES)}, head dims {HEAD_DIMS}") from None


def bwd_route(dtype: torch.dtype, d: int) -> str:
    """The backward's route for this dtype and head dim: "wgmma" or "fma"."""
    try:
        return BWD_ROUTES[(dtype, d)]
    except KeyError:
        raise ValueError(f"no backward kernel takes {dtype} at head dim {d}: dtypes "
                         f"{list(_DTYPES)}, head dims {HEAD_DIMS}") from None


def wgmma_stages(d: int) -> int:
    """Depth of the Hopper kernel's K/V ring at head dim d: what fits 227 KB."""
    return 2 if WGMMA_TILE_DIM[d] == 128 else 3


def wgmma_smem_bytes(d: int) -> int:
    """The Hopper kernel's dynamic shared memory at head dim d: 1024 bytes
    of alignment slack, the Q tile, a ring of K and V tiles (each
    ``WGMMA_TILE_DIM[d]`` columns wide), 8 bytes per mbarrier."""
    tile = (WGMMA_TILE_DIM[d] // TMA_BOX_COLS) * WGMMA_KEYS * TMA_BOX_COLS * 2
    stages = wgmma_stages(d)
    return 1024 + tile * (1 + 2 * stages) + 8 * (1 + 3 * stages)


def tensor_map(t: torch.Tensor, rows: int = WGMMA_ROWS) -> tuple[int, ...]:
    """The 4-D TMA map over t (B, S, H, D), innermost first: dims
    (D, H, S, B), byte strides along H, S and B, box (64, 1, rows, 1).  At
    D = 112 the second box of a row reaches past D: TMA fills its columns
    112..127 with zeros."""
    b, s, h, d = t.shape
    e = t.element_size()
    return (d, h, s, b, t.stride(2) * e, t.stride(1) * e, t.stride(0) * e,
            TMA_BOX_COLS, 1, rows, 1)


@dataclass(frozen=True)
class Plan:
    """A launch: its route, its grid ((Hq, B, query tiles of 128) for the
    Hopper kernel, (query tiles of 64, Hq, B) for the others) and, for the
    Hopper kernel, the tensor maps of q, k and v (eleven numbers each,
    ``tensor_map``) and the dynamic shared memory."""
    route: str
    maps: tuple[int, ...] | None = None
    grid: tuple[int, int, int] | None = None
    smem: int | None = None


def _check_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal_offset: int) -> None:
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype} / {k.dtype} / {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)} are not (B, Sq, Hq, D), (B, Sk, Hkv, D) x2")
    b, sq, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[2] != 0 or 0 in q.shape \
            or 0 in k.shape:
        raise ValueError(f"shapes {tuple(q.shape)} and {tuple(k.shape)} do not "
                         "match: same B and D, Hq a multiple of Hkv, no empty dim")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if b > 65535 or hq > 65535:
        raise ValueError(f"B={b} and Hq={hq} must be at most 65535")
    if causal_offset < 0 or causal_offset >= 2**31 - sq:
        raise ValueError(f"causal_offset {causal_offset} outside [0, 2^31 - Sq)")
    # 16-byte vectors (cp.async) and TMA's 16-byte strides and base.
    align = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % align for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} needs unit stride along D, the other strides "
                             f"multiples of {align} elements and a 16-byte aligned "
                             f"start; got strides {t.stride()}")


def plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal_offset: int = 0,
         kernel: str | None = None) -> Plan:
    """Check q/k/v's layout and plan the launch of ``kernel`` (default: the
    route of q's dtype and D)."""
    _check_layout(q, k, v, causal_offset)
    d = q.shape[3]
    name = route(q.dtype, d) if kernel is None else kernel
    ok = {"wgmma": q.dtype == torch.bfloat16 and d in WGMMA_TILE_DIM,
          "mma_sync": q.dtype == torch.bfloat16, "fp32": q.dtype == torch.float32}
    if not ok.get(name, False):
        raise ValueError(f"kernel {name!r} does not take {q.dtype} at head dim {d}")
    b, sq, hq, _ = q.shape
    if name != "wgmma":
        return Plan(name, grid=(-(-sq // FWD_ROWS), hq, b))
    return Plan(name, maps=tensor_map(q) + tensor_map(k) + tensor_map(v),
                grid=(hq, b, -(-sq // WGMMA_ROWS)), smem=wgmma_smem_bytes(d))


@dataclass(frozen=True)
class BwdPlan:
    """The backward's launches on its route: grid (x, y, z) and dynamic
    shared memory of each kernel of ``BWD_KERNELS`` ("fma") or
    ``BWD_WGMMA_KERNELS`` ("wgmma"), in that order, and for "wgmma" the
    tensor maps of q, k, v and do (eleven numbers each, boxes of 64 rows)."""
    route: str
    grids: tuple[tuple[int, int, int], ...]
    smem: tuple[int, ...]
    maps: tuple[int, ...] | None = None


def bwd_smem_bytes(d: int) -> tuple[int, int, int]:
    """Dynamic shared memory of the stats, dK/dV and dQ kernels at head dim
    d: fp32 tiles of 64 rows with row stride d + 1, score tiles 64 x 65."""
    tile = 64 * (d + 1)
    ps = BWD_KEYS + 1
    return (4 * 2 * tile, 4 * (4 * tile + 2 * BWD_KEYS * ps + 2 * BWD_ROWS),
            4 * (4 * tile + BWD_ROWS * ps))


def bwd_wgmma_smem_bytes(d: int) -> tuple[int, int]:
    """Dynamic shared memory of the wgmma route's dQ and dK/dV kernels at
    head dim d: 1024 bytes of alignment slack; dQ: Q and dO (128 rows) and a
    ring of K and V tiles (64 keys); dK/dV: K and V (64 keys), a ring of Q
    and dO tiles (64 rows) with each stage's 64 LSEs and D_i in fp32, and two
    64 x 64 fp32 buffers of P^T; tiles ``WGMMA_TILE_DIM[d]`` columns wide, 8
    bytes per mbarrier."""
    cols = WGMMA_TILE_DIM[d] * 2
    stages = BWD_WGMMA_STAGES
    bars = 8 * (1 + 2 * stages)
    dq = 2 * BWD_WGMMA_DQ_ROWS * cols + 2 * stages * BWD_WGMMA_DQ_KEYS * cols
    dkdv = 2 * BWD_WGMMA_KV_KEYS * cols + stages * (2 * BWD_WGMMA_KV_ROWS * cols
                                                    + 2 * BWD_WGMMA_KV_ROWS * 4) \
        + 2 * BWD_WGMMA_KV_KEYS * BWD_WGMMA_KV_ROWS * 4
    return 1024 + dq + bars, 1024 + dkdv + bars


def plan_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
             do: torch.Tensor, causal_offset: int = 0, route: str | None = None) -> BwdPlan:
    """Check the backward's inputs (the forward's dtypes and head dims; o and
    do shaped as q, in its dtype) and plan the launches of ``route``
    (default: ``bwd_route`` of q's dtype and D).  "fma": stats and dQ over
    (query tiles of 64, Hq, B), dK/dV over (key tiles of 64, Hkv, B);
    "wgmma" (bf16 at D 64, 112, 128): dQ over (Hq, B, query tiles of 128),
    dK/dV over (Hkv, B, key tiles of 64)."""
    _check_layout(q, k, v, causal_offset)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} must be shaped as q "
                             f"{tuple(q.shape)} in {q.dtype}")
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    name = bwd_route(q.dtype, d) if route is None else route
    if name == "fma":
        q_tiles = -(-sq // BWD_ROWS)
        k_tiles = -(-sk // BWD_KEYS)
        return BwdPlan("fma", grids=((q_tiles, hq, b), (k_tiles, hkv, b), (q_tiles, hq, b)),
                       smem=bwd_smem_bytes(d))
    if name != "wgmma" or q.dtype != torch.bfloat16 or d not in WGMMA_TILE_DIM:
        raise ValueError(f"backward route {name!r} does not take {q.dtype} at head dim {d}")
    if do.stride(3) != 1 or any(st % 8 for st in do.stride()[:3]) or do.data_ptr() % 16:
        raise ValueError(f"do needs q's layout rules for its tensor map; got strides "
                         f"{do.stride()}")
    rows = BWD_WGMMA_BOX_ROWS
    return BwdPlan("wgmma", grids=((hq, b, -(-sq // BWD_WGMMA_DQ_ROWS)),
                                   (hkv, b, -(-sk // BWD_WGMMA_KV_KEYS))),
                   smem=bwd_wgmma_smem_bytes(d),
                   maps=tensor_map(q, rows) + tensor_map(k, rows) + tensor_map(v, rows)
                   + tensor_map(do, rows))


class FlashAttention(torch.autograd.Function):
    """``gqa_flash`` with its gradient: the forward saves q, k, v, the output
    and, on the Hopper route, its rows' LSE; the backward is
    ``gqa_flash_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal_offset: int):
        o, lse = _forward(q, k, v, causal_offset, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal_offset = causal_offset
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = gqa_flash_bwd(q, k, v, o, do, ctx.causal_offset, lse=lse)
        return dq, dk, dv, None


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _on_meta(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "meta" for t in ts)


def kernel_work(q: torch.Tensor, k: torch.Tensor, causal_offset: int, backward: bool,
                lse: bool = False) -> tuple[int, int]:
    """(FLOPs, bytes) of the kernels of one forward (``backward`` False) or
    backward on these shapes: 2·D FLOPs per unmasked (row, key) pair per
    query head for each product (the forward's 2; the backward's 7 on the
    "wgmma" route, S and dP twice beside dV, dK and dQ, and 8 on "fma",
    whose stats pass adds one S); each input read once and each output
    written once: q, k, v in and o (and the LSE, with ``lse``) out; q, k, v,
    o, dO and the LSE in, dq, dk, dv and D_i out."""
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    pairs = sum(min(max(i + causal_offset + 1, 0), sk) for i in range(sq))
    products = 2 if not backward else (7 if bwd_route(q.dtype, d) == "wgmma" else 8)
    flops = products * 2 * d * hq * b * pairs
    qkv = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size()
    rows = 4 * b * hq * sq                          # one fp32 per query row and head
    nbytes = qkv + (rows if lse else 0) if not backward else \
        2 * qkv + 2 * k.numel() * k.element_size() + 2 * rows
    return flops, nbytes


def _meta_forward(q, k, v, causal_offset: int, with_lse: bool):
    from repro_torch.launch.op_analysis import record_kernel

    b, sq, hq, d = q.shape
    lse = with_lse and ROUTES.get((q.dtype, d)) == "wgmma"
    record_kernel("gqa_flash", *kernel_work(q, k, causal_offset, False, lse))
    return (torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device),
            torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if lse else None)


def _forward(q, k, v, causal_offset: int, with_lse: bool = False):
    """(output, LSE): the LSE (B, Hq, Sq) fp32 when ``with_lse`` asks for it
    and the Hopper kernel runs (the wgmma backward reads it), else None."""
    if _on_cpu(q, k, v):
        return gqa_flash_plain(q, k, v, causal_offset), None
    if _on_meta(q, k, v):
        return _meta_forward(q, k, v, causal_offset, with_lse)
    if with_lse and ROUTES.get((q.dtype, q.shape[-1])) == "wgmma":
        return launch(q, k, v, causal_offset, with_lse=True)
    return launch(q, k, v, causal_offset), None


def gqa_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal_offset: int = 0) -> torch.Tensor:
    """Causal GQA attention, (B, Sq, Hq, D) in q's dtype; differentiable
    through ``FlashAttention`` when grad mode is on and an input needs it."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal_offset)
    return _forward(q, k, v, causal_offset)[0]


def gqa_flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                  do: torch.Tensor, causal_offset: int = 0, lse: torch.Tensor | None = None):
    """(dq, dk, dv) of ``gqa_flash``: the plain version on CPU tensors, the
    kernels of ``csrc/flash_attention_bwd.cu`` on CUDA tensors (the wgmma
    route reads ``lse``, the forward's)."""
    if _on_cpu(q, k, v, o, do):
        return gqa_flash_bwd_plain(q, k, v, o, do, causal_offset)
    if _on_meta(q, k, v, o, do):
        from repro_torch.launch.op_analysis import record_kernel

        record_kernel("gqa_flash_bwd", *kernel_work(q, k, causal_offset, True))
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    return launch_bwd(q, k, v, o, do, causal_offset, lse=lse)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal_offset: int = 0,
           kernel: str | None = None, with_lse: bool = False):
    """``gqa_flash`` on CUDA tensors through ``kernel`` ("wgmma",
    "mma_sync" or "fp32"; default: its route), to hold one kernel against
    another at one shape.  With ``with_lse`` (the Hopper kernel only)
    returns (output, LSE (B, Hq, Sq) fp32)."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"q ({q.device}), k ({k.device}) and v ({v.device}) "
                         "must lie on the same CUDA device")
    pl = plan(q, k, v, causal_offset, kernel)
    if with_lse and pl.route != "wgmma":
        raise ValueError(f"only the wgmma kernel writes the LSE, not {pl.route}")
    build()
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if with_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if pl.route == "wgmma":
        maps = (ctypes.c_ulonglong * len(pl.maps))(*pl.maps)
        err = _lib.gqa_flash_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, sq, sk, hq, hkv, d,
            int(causal_offset), maps, *pl.grid, pl.smem, stream)
    else:
        err = _lib.gqa_flash_fwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, sk, hq, hkv, d, int(causal_offset),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *pl.grid, stream)
    if err != 0:
        raise RuntimeError(f"the {pl.route} kernel of gqa_flash failed: "
                           + (f"cudaError_t {err}" if err > 0
                              else f"CUresult {-err} encoding a tensor map"))
    launches["gqa_flash"] += 1
    launches[pl.route] += 1
    return (out, lse) if with_lse else out


def launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
               do: torch.Tensor, causal_offset: int = 0, lse: torch.Tensor | None = None,
               route: str | None = None):
    """``gqa_flash_bwd`` on CUDA tensors on ``route`` (default: ``bwd_route``):
    "wgmma" launches dQ (which writes D_i) then dK/dV and needs ``lse``, the
    forward's (B, Hq, Sq) fp32; "fma" launches the stats kernel (LSE and D_i
    into fp32 scratch), then dK/dV and dQ, and ignores ``lse``.  The inputs
    are made contiguous."""
    ts = [t.contiguous() for t in (q, k, v, o, do)]
    if any(t.device.type != "cuda" or t.device != q.device for t in ts):
        raise ValueError("q, k, v, o and do must lie on the same CUDA device")
    pl = plan_bwd(*ts, causal_offset, route)
    if pl.route == "wgmma":
        b, sq, hq, _ = q.shape
        if lse is None or lse.shape != (b, hq, sq) or lse.dtype != torch.float32 \
                or lse.device != q.device:
            raise ValueError(f"the wgmma backward reads the forward's LSE, a ({b}, {hq}, "
                             f"{sq}) float32 tensor on {q.device}; got "
                             + ("None" if lse is None else
                                f"{tuple(lse.shape)} {lse.dtype} on {lse.device}"))
        lse = lse.contiguous()
    bufs = bwd_buffers(ts[0], ts[1], lse if pl.route == "wgmma" else None)
    for which in range(len(pl.grids)):
        launch_bwd_kernel(which, *ts, bufs, causal_offset, pl)
    launches["gqa_flash_bwd"] += 1
    return bufs[2:]


def bwd_buffers(q: torch.Tensor, k: torch.Tensor,
                lse: torch.Tensor | None = None) -> tuple[torch.Tensor, ...]:
    """The backward's scratch and outputs: LSE (``lse``, else new) and D_i
    (B, Hq, Sq) fp32, then dq, dk, dv shaped and typed as q, k, k."""
    b, sq, hq, _ = q.shape
    if lse is None:
        lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    return lse, torch.empty((b, hq, sq), dtype=torch.float32, device=q.device), \
        torch.empty_like(q), torch.empty_like(k), torch.empty_like(k)


def launch_bwd_kernel(which: int, q, k, v, o, do, bufs, causal_offset: int,
                      pl: BwdPlan) -> None:
    """One launch of the kernel ``which`` of ``pl``'s route (``BWD_KERNELS``
    or ``BWD_WGMMA_KERNELS``) on contiguous CUDA inputs, into ``bufs``
    (``bwd_buffers``), as ``pl`` plans it; adds one to that kernel's count."""
    build_bwd()
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = [t.data_ptr() for t in (q, k, v, o, do, *bufs)]
    if pl.route == "wgmma":
        name = BWD_WGMMA_KERNELS[which]
        maps = (ctypes.c_ulonglong * len(pl.maps))(*pl.maps)
        err = _bwd_lib.gqa_flash_bwd_wgmma(which, *ptrs, b, sq, sk, hq, hkv, d,
                                           int(causal_offset), maps, *pl.grids[which],
                                           pl.smem[which], stream)
    else:
        name = BWD_KERNELS[which]
        err = _bwd_lib.gqa_flash_bwd(which, _DTYPES[q.dtype], *ptrs, b, sq, sk, hq, hkv, d,
                                     int(causal_offset), *pl.grids[which], pl.smem[which],
                                     stream)
    if err != 0:
        raise RuntimeError(f"the {name} kernel of gqa_flash's backward failed: "
                           + (f"cudaError_t {err}" if err > 0
                              else f"CUresult {-err} encoding a tensor map"))
    launches[name] += 1
