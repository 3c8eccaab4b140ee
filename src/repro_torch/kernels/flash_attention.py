"""Causal GQA flash attention: the hand-written CUDA kernels and their plain
PyTorch version (the counterpart of ``src/repro/kernels/flash_attention.py``
``gqa_flash``).

``gqa_flash(q, k, v, causal_offset=0)`` takes q (B, Sq, Hq, D) and k/v
(B, Sk, Hkv, D), Hq a multiple of Hkv, query head h reading KV head
h // (Hq // Hkv), and returns (B, Sq, Hq, D) in q's dtype: softmax of
q.k / sqrt(D), masked to ``causal_offset + q_row >= k_row``, times v, in
fp32.  On CPU tensors it runs ``gqa_flash_plain``; on CUDA tensors it
launches a kernel of ``csrc/flash_attention.cu`` (float32 or bfloat16,
D in {32, 64, 112, 128}, unit stride along D) or raises.  ``route`` picks
the kernel from the dtype and D alone (``ROUTES``): bf16 at D in {64, 112,
128} goes to the Hopper kernel (wgmma fed by TMA; llama3-8b and the MoE
configs take 64 or 128, zamba2-7b's shared attention 112, which runs on
the D = 128 instantiation over tiles whose columns 112..127 TMA fills with
zeros, storing 112 columns), bf16 at D = 32 to the ``mma.sync`` kernel,
fp32 to the fp32 kernel.
``plan`` does the shape and stride arithmetic of a launch (the route, the
Hopper kernel's tensor maps, grid and shared memory) and runs on any
tensors.  Each launch adds one to ``launches["gqa_flash"]`` and one to the
count of its route.

The gradient: when grad mode is on and q, k or v requires grad,
``gqa_flash`` runs through ``FlashAttention`` (a ``torch.autograd.Function``)
and saves q, k, v and the output.  Its backward is ``gqa_flash_bwd``: on
CPU tensors ``gqa_flash_bwd_plain``, the explicit fp32 gradient of
``gqa_flash_plain``; on CUDA tensors the three kernels of
``csrc/flash_attention_bwd.cu`` (the row statistics, dK/dV, dQ; the same
dtypes and head dims as the forward), planned by ``plan_bwd``.  Each
backward adds one to ``launches["gqa_flash_bwd"]`` and one to each
kernel's count.  Under ``no_grad``, or on tensors that need no grad,
``gqa_flash`` is the serving path above, unchanged.
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
            "gqa_flash_bwd": 0, "bwd_stats": 0, "bwd_dkdv": 0, "bwd_dq": 0}

HEAD_DIMS = (32, 64, 112, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The kernel of each (dtype, D).
ROUTES = {(torch.bfloat16, 64): "wgmma", (torch.bfloat16, 112): "wgmma",
          (torch.bfloat16, 128): "wgmma", (torch.bfloat16, 32): "mma_sync",
          (torch.float32, 32): "fp32", (torch.float32, 64): "fp32",
          (torch.float32, 112): "fp32", (torch.float32, 128): "fp32"}
#: Head dims of the Hopper kernel, and the width of the tiles each runs on.
WGMMA_TILE_DIM = {64: 64, 112: 128, 128: 128}

# The Hopper kernel's tiling (csrc/flash_attention.cu, namespace hopper).
WGMMA_ROWS = 128        # query rows per block
WGMMA_KEYS = 128        # keys per tile; the K/V boxes' rows
TMA_BOX_COLS = 64       # bf16 per 128-byte swizzled row: a box's inner extent

# The backward kernels' tiling (csrc/flash_attention_bwd.cu).
BWD_ROWS = 64           # query rows per tile
BWD_KEYS = 64           # keys per tile
BWD_THREADS = 256
#: The backward's kernels in launch order, by their ``which`` in the C entry.
BWD_KERNELS = ("bwd_stats", "bwd_dkdv", "bwd_dq")

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


def gqa_flash_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, causal_offset: int = 0):
    """The explicit fp32 gradient of ``gqa_flash_plain``: (dq, dk, dv) in the
    dtypes of q, k and v.  P is the forward's softmax; with D_i = dO_i . O_i
    (o, the forward's output, as the kernels read it), dS = P (dO V^T - D),
    dq = dS K / sqrt(D), dk = dS^T Q / sqrt(D) and dv = P^T dO, dk and dv
    summed over each KV head's query heads."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, sq, hkv, g, d).float()
    dog = do.reshape(b, sq, hkv, g, d).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
    qpos = causal_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    s = torch.where(qpos[:, None] >= kpos[None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vf)
    dvec = (dog * o.reshape(b, sq, hkv, g, d).float()).sum(-1).permute(0, 2, 3, 1)
    ds = p * (dp - dvec[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    return (dq.reshape(b, sq, hq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def build() -> str:
    """Compile ``csrc/flash_attention.cu`` (once per source version) and
    load it.  Returns the compiler's report when this call compiled."""
    global _lib
    if _lib is not None:
        return ""
    lib, log = build_library("flash_attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gqa_flash_fwd.argtypes = [i, p, p, p, p] + [i] * 7 + [ll] * 9 + [p]
    lib.gqa_flash_fwd.restype = i
    lib.gqa_flash_wgmma.argtypes = [p] * 4 + [i] * 7 + [p] + [i] * 3 + [ll, p]
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
    _bwd_lib = lib
    return log


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel that ``gqa_flash`` launches for this dtype and head dim."""
    try:
        return ROUTES[(dtype, d)]
    except KeyError:
        raise ValueError(f"no kernel takes {dtype} at head dim {d}: dtypes "
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


def tensor_map(t: torch.Tensor) -> tuple[int, ...]:
    """The 4-D TMA map over t (B, S, H, D), innermost first: dims
    (D, H, S, B), byte strides along H, S and B, box (64, 1, 128, 1).  At
    D = 112 the second box of a row reaches past D: TMA fills its columns
    112..127 with zeros."""
    b, s, h, d = t.shape
    e = t.element_size()
    return (d, h, s, b, t.stride(2) * e, t.stride(1) * e, t.stride(0) * e,
            TMA_BOX_COLS, 1, WGMMA_ROWS, 1)


@dataclass(frozen=True)
class Plan:
    """A launch: its route and, for the Hopper kernel, the tensor maps of
    q, k and v (eleven numbers each, ``tensor_map``), the grid
    (Hq, B, query tiles) and the dynamic shared memory."""
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
    if name != "wgmma":
        return Plan(name)
    b, sq, hq, _ = q.shape
    return Plan(name, maps=tensor_map(q) + tensor_map(k) + tensor_map(v),
                grid=(hq, b, -(-sq // WGMMA_ROWS)), smem=wgmma_smem_bytes(d))


@dataclass(frozen=True)
class BwdPlan:
    """The backward's three launches: grid (x, y, z) and dynamic shared
    memory of each kernel of ``BWD_KERNELS``, in that order."""
    grids: tuple[tuple[int, int, int], ...]
    smem: tuple[int, ...]


def bwd_smem_bytes(d: int) -> tuple[int, int, int]:
    """Dynamic shared memory of the stats, dK/dV and dQ kernels at head dim
    d: fp32 tiles of 64 rows with row stride d + 1, score tiles 64 x 65."""
    tile = 64 * (d + 1)
    ps = BWD_KEYS + 1
    return (4 * 2 * tile, 4 * (4 * tile + 2 * BWD_KEYS * ps + 2 * BWD_ROWS),
            4 * (4 * tile + BWD_ROWS * ps))


def plan_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
             do: torch.Tensor, causal_offset: int = 0) -> BwdPlan:
    """Check the backward's inputs (the forward's dtypes and head dims; o and
    do shaped as q, in its dtype) and plan its three launches: stats and dQ
    over (query tiles, Hq, B), dK/dV over (key tiles, Hkv, B)."""
    _check_layout(q, k, v, causal_offset)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} must be shaped as q "
                             f"{tuple(q.shape)} in {q.dtype}")
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    q_tiles = -(-sq // BWD_ROWS)
    k_tiles = -(-sk // BWD_KEYS)
    return BwdPlan(grids=((q_tiles, hq, b), (k_tiles, hkv, b), (q_tiles, hq, b)),
                   smem=bwd_smem_bytes(d))


class FlashAttention(torch.autograd.Function):
    """``gqa_flash`` with its gradient: the forward saves q, k, v and the
    output; the backward is ``gqa_flash_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal_offset: int):
        o = _forward(q, k, v, causal_offset)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal_offset = causal_offset
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = gqa_flash_bwd(q, k, v, o, do, ctx.causal_offset)
        return dq, dk, dv, None


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _forward(q, k, v, causal_offset: int) -> torch.Tensor:
    if _on_cpu(q, k, v):
        return gqa_flash_plain(q, k, v, causal_offset)
    return launch(q, k, v, causal_offset)


def gqa_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal_offset: int = 0) -> torch.Tensor:
    """Causal GQA attention, (B, Sq, Hq, D) in q's dtype; differentiable
    through ``FlashAttention`` when grad mode is on and an input needs it."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal_offset)
    return _forward(q, k, v, causal_offset)


def gqa_flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                  do: torch.Tensor, causal_offset: int = 0):
    """(dq, dk, dv) of ``gqa_flash``: the plain version on CPU tensors, the
    kernels of ``csrc/flash_attention_bwd.cu`` on CUDA tensors."""
    if _on_cpu(q, k, v, o, do):
        return gqa_flash_bwd_plain(q, k, v, o, do, causal_offset)
    return launch_bwd(q, k, v, o, do, causal_offset)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal_offset: int = 0,
           kernel: str | None = None) -> torch.Tensor:
    """``gqa_flash`` on CUDA tensors through ``kernel`` ("wgmma",
    "mma_sync" or "fp32"; default: its route), to hold one kernel against
    another at one shape."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"q ({q.device}), k ({k.device}) and v ({v.device}) "
                         "must lie on the same CUDA device")
    pl = plan(q, k, v, causal_offset, kernel)
    build()
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if pl.route == "wgmma":
        maps = (ctypes.c_ulonglong * len(pl.maps))(*pl.maps)
        err = _lib.gqa_flash_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk, hq, hkv,
            d, int(causal_offset), maps, *pl.grid, pl.smem, stream)
    else:
        err = _lib.gqa_flash_fwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, sk, hq, hkv, d, int(causal_offset),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], stream)
    if err != 0:
        raise RuntimeError(f"the {pl.route} kernel of gqa_flash failed: "
                           + (f"cudaError_t {err}" if err > 0
                              else f"CUresult {-err} encoding a tensor map"))
    launches["gqa_flash"] += 1
    launches[pl.route] += 1
    return out


def launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
               do: torch.Tensor, causal_offset: int = 0):
    """``gqa_flash_bwd`` on CUDA tensors: the stats kernel (LSE and D_i into
    fp32 scratch), then dK/dV and dQ.  The inputs are made contiguous."""
    ts = [t.contiguous() for t in (q, k, v, o, do)]
    if any(t.device.type != "cuda" or t.device != q.device for t in ts):
        raise ValueError("q, k, v, o and do must lie on the same CUDA device")
    pl = plan_bwd(*ts, causal_offset)
    bufs = bwd_buffers(ts[0], ts[1])
    for which in range(len(BWD_KERNELS)):
        launch_bwd_kernel(which, *ts, bufs, causal_offset, pl)
    launches["gqa_flash_bwd"] += 1
    return bufs[2:]


def bwd_buffers(q: torch.Tensor, k: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The backward's scratch and outputs: LSE and D_i (B, Hq, Sq) fp32, then
    dq, dk, dv shaped and typed as q, k, k."""
    b, sq, hq, _ = q.shape
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    return lse, torch.empty_like(lse), torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(k)


def launch_bwd_kernel(which: int, q, k, v, o, do, bufs, causal_offset: int,
                      pl: BwdPlan) -> None:
    """One launch of the backward's kernel ``BWD_KERNELS[which]`` on
    contiguous CUDA inputs, into ``bufs`` (``bwd_buffers``), as ``pl``
    plans it; adds one to that kernel's count."""
    build_bwd()
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = [t.data_ptr() for t in (q, k, v, o, do, *bufs)]
    err = _bwd_lib.gqa_flash_bwd(which, _DTYPES[q.dtype], *ptrs, b, sq, sk, hq, hkv, d,
                                 int(causal_offset), *pl.grids[which], pl.smem[which], stream)
    if err != 0:
        raise RuntimeError(f"the {BWD_KERNELS[which]} kernel of gqa_flash's backward "
                           f"failed: cudaError_t {err}")
    launches[BWD_KERNELS[which]] += 1
