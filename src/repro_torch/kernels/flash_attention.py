"""Causal GQA flash attention: the hand-written CUDA kernels and their plain
PyTorch version (the counterpart of ``src/repro/kernels/flash_attention.py``
``gqa_flash``).

``gqa_flash(q, k, v, causal_offset=0)`` takes q (B, Sq, Hq, D) and k/v
(B, Sk, Hkv, D), Hq a multiple of Hkv, query head h reading KV head
h // (Hq // Hkv), and returns (B, Sq, Hq, D) in q's dtype: softmax of
q.k / sqrt(D), masked to ``causal_offset + q_row >= k_row``, times v, in
fp32.  On CPU tensors it runs ``gqa_flash_plain``; on CUDA tensors it
launches a kernel of ``csrc/flash_attention.cu`` (float16, bfloat16, float32
or float64 at any head dim 1 <= D <= 256, as the reference's Pallas kernel
takes any) or raises.  ``route`` picks the kernel from the dtype and D alone:
bf16 and fp16 at every D go to the Hopper kernel (wgmma fed by TMA over
tiles ``wgmma_tile_dim(D)`` wide: 16 up to D 16, 32 up to D 32, else the
least multiple of 64 that holds D, 64, 128, 192 or 256, whose columns past
D TMA fills with zeros, storing D columns; key tiles of 128 up to width
128, of 64 past it; the narrow tiles 16 and 32 wide under the 32- and
64-byte swizzle, two blocks an SM without a producer warpgroup; bf16 at D
64, 112 and 128, ``WGMMA_TILE_DIM``, on instantiations of their own:
llama3-8b and the MoE configs take 64 or 128, zamba2-7b's shared attention
112, whose kernel runs S = Q K^T in 7 k-steps and O += P V at N 112 on the
128-wide tiles, its blocks in the L2 order (``plan``'s ``group_kv``: a
group of KV heads at a time, heaviest query tiles first, so that their K
and V stay in L2); every other multiple of 8 in (32, 128], in fp16 and
bf16, on the head-dim kernels, which do the same at the head's own width W
= ``product_dim(D)`` (48, 64, 80, 96, 112 or 128: S in W / 16 k-steps, O
at N = W, the L2 order; ``width_kernel``); every 16-bit D past 128 on the
wide kernels (``wide_kernel``: the tiles 192 or 256 wide in the L2 order, K/V
tiles of ``wide_keys(D)`` keys, 96 at width 192, and at width 256 a producer
warpgroup whose consumers take 240 registers; Gemma-2-9B's heads are 256
wide); the example trainers' heads are narrow:
``repro_torch.examples.train_carbon_aware``'s tiny preset has D 16, its
10m preset D 32), fp32 to the tiled fp32 kernel (route "fp32",
``flash_tiled_kernel``: register micro-tiles on the FMA pipe, over the
least multiple of 8 that holds D, ``tiled_width``; tiles and grids by
``tiled_fwd_tiling``), and fp64 to it on fp32 copies, the output cast back,
as the reference's kernel body computes in fp32.  Three first designs run
only when named, the yardsticks: the ``mma.sync`` kernel for 16-bit inputs
(``kernel="mma_sync"``, ``flash_mma_kernel``) and the first fp32 kernel
(``kernel="fp32_simple"``, ``flash_f32_kernel``), both on the least padded
width of 16, 32, 64, 128, 256 that holds D (``padded_dim``), their loads
zero past D; at bf16 D 112 the Hopper kernel that runs the 128-wide
tiles' whole width in the grid's order (``kernel="wgmma_pad128"``); and at
the head-dim and wide kernels' (dtype, D) the whole-tile instantiations
they replaced, in the grid's order (``kernel="wgmma_tile"``).  An
input whose layout the route cannot read is copied first, and each copy
adds one to ``launches["layout_copy"]``: for the Hopper kernel (TMA: byte
strides multiples of 16, a 16-byte aligned start) into a buffer of rows
``tma_width(D)`` wide, handed in as its [..., :D] view (``stage``; every
contiguous 16-bit input off a multiple of 8 is such a case), for the
others (a stride along D other than 1) into a contiguous tensor.
``plan`` does the shape and stride arithmetic of a launch (the route, the
grid, and the Hopper kernel's tensor maps and shared memory) and runs on
any tensors.  Each launch adds one to ``launches["gqa_flash"]`` and one to
the count of its route.

The gradient: when grad mode is on and q, k or v requires grad,
``gqa_flash`` runs through ``FlashAttention`` (a ``torch.autograd.Function``)
and saves q, k, v (on the Hopper route as staged), the output and, on CUDA
tensors, each row's log-sum-exp that the forward kernel wrote beside it
(every default route's forward writes it).  Its backward is
``gqa_flash_bwd``: on CPU tensors
``gqa_flash_bwd_plain``, the explicit fp32 gradient of ``gqa_flash_plain``;
on CUDA tensors the kernels of ``csrc/flash_attention_bwd.cu`` on the route
``bwd_route`` picks from the dtype and D alone: "wgmma" where the
forward's route is, every 16-bit D (two Hopper kernels, dQ then dK/dV, on
the forward's tiles, reading the forward's LSE; past width 128 dQ's key
tiles are 32 and every TMA box 32 rows; at every multiple of 8 in (32,
128] but bf16 64 and 128 the head-dim kernels, every product at
``product_dim(D)``, in the L2 order: ``plan_bwd``'s groups; past 128 the
wide pair, in the L2 order, dQ's K/V tiles of ``wide_dq_keys(D)`` keys, at
width 256 a producer warpgroup), "tiled" for fp32 and fp64 (two
register-tiled fp32 FMA kernels, dQ then dK/dV, reading the tiled forward's
LSE; fp64 on fp32 copies, the gradients cast back), each with the plain
version ``gqa_flash_bwd_lse_plain`` (unrounded for "tiled"); and, only on
request, the yardsticks "wgmma_tile" at the head-dim and wide kernels'
(dtype, D) (the whole-tile pair they replaced, in the grid's order), "mma" for bf16
and fp16 at D <= 32 (two
``mma.sync`` kernels, dQ then dK/dV, reading an LSE such as the
``mma.sync`` forward writes) and "fma" (the first design's three fp32 FMA
kernels: row statistics, dK/dV, dQ, on the padded widths, with tiles of 32
rows at width 256), planned by ``plan_bwd``.  Each backward
adds one to ``launches["gqa_flash_bwd"]`` and one to each of its kernels'
counts.  Under ``no_grad``, or on tensors that need no grad, ``gqa_flash``
is the serving path above, unchanged: it asks for no LSE, and the output's
bits do not depend on it.

On ``meta`` tensors (the dry-run's op counting, ``launch/dryrun.py``) the
forward and the backward return their outputs' shapes and dtypes, launch
nothing, and report the work of the kernels their route would launch to
``launch/op_analysis.py::record_kernel`` (``kernel_work``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from ._build import build_library

#: Kernel launches since the last ``reset_launches()``: all of them under
#: "gqa_flash", and each under its route.
launches = {"gqa_flash": 0, "wgmma": 0, "wgmma_pad128": 0, "wgmma_tile": 0, "mma_sync": 0,
            "fp32": 0, "fp32_simple": 0, "gqa_flash_bwd": 0, "bwd_stats": 0, "bwd_dkdv": 0,
            "bwd_dq": 0, "bwd_wgmma_dq": 0, "bwd_wgmma_dkdv": 0, "bwd_wgmma_tile_dq": 0,
            "bwd_wgmma_tile_dkdv": 0, "bwd_mma_dq": 0, "bwd_mma_dkdv": 0, "bwd_tiled_dq": 0,
            "bwd_tiled_dkdv": 0, "layout_copy": 0}
#: The same launches by kernel instantiation (``instance``, ``bwd_instance``):
#: which template instance of ``csrc/flash_attention.cu`` or
#: ``csrc/flash_attention_bwd.cu`` each launch ran.
instances: dict[str, int] = {}

#: The head dims of the pinned routes (``ROUTES``).
HEAD_DIMS = (16, 32, 64, 112, 128)
#: The largest head dim a kernel takes.
MAX_HEAD_DIM = 256
#: The C entry points' dtype codes; float64 runs the float32 kernels on copies.
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HALF = (torch.bfloat16, torch.float16)
#: The routes of the Hopper kernels, whose inputs TMA reads.
_TMA_ROUTES = ("wgmma", "wgmma_pad128", "wgmma_tile")
_FLOATS = (torch.float16, torch.bfloat16, torch.float32, torch.float64)
#: The routes of the model configs' (dtype, D) pairs, pinned.
ROUTES = {(torch.bfloat16, 64): "wgmma", (torch.bfloat16, 112): "wgmma",
          (torch.bfloat16, 128): "wgmma", (torch.bfloat16, 16): "wgmma",
          (torch.bfloat16, 32): "wgmma", (torch.float32, 16): "fp32",
          (torch.float32, 32): "fp32", (torch.float32, 64): "fp32",
          (torch.float32, 112): "fp32", (torch.float32, 128): "fp32"}
#: The bf16 head dims with a Hopper instantiation of their own, and the
#: width of the tiles each runs on; every other D of the Hopper route runs
#: on ``wgmma_tile_dim(D)`` with the head dim taken at run time.
WGMMA_TILE_DIM = {64: 64, 112: 128, 128: 128}
#: The padded widths of the mma.sync, first-design fp32 ("fp32_simple") and
#: fma kernels (the tiled kernels run on ``tiled_width(D)``).
PADDED_DIMS = (16, 32, 64, 128, 256)

# The Hopper kernel's tiling (csrc/flash_attention.cu, namespace hopper).
WGMMA_ROWS = 128        # query rows per block
WGMMA_KEYS = 128        # keys per tile and the boxes' rows, up to width 128
WGMMA_WIDE_KEYS = 64    # the same past width 128 (``wgmma_keys``)
TMA_BOX_COLS = 64       # 16-bit elements per 128-byte swizzled row: a box's inner extent
#: The bf16 head dim whose kernel runs its products at that width on the
#: 128-wide tiles (7 k-steps of S, O at N 112) and its blocks in the L2 order
#: (``l2_order``): zamba2-7b's shared attention.  ``kernel="wgmma_pad128"``
#: runs the same head dim on the 128-wide tiles' whole width in the grid's
#: order, the kernel it replaced (the yardstick).
WGMMA_D112 = 112
#: The widths of the head-dim kernels' products (``hopper::by_width`` in both
#: flash sources): a 16-bit head dim D, a multiple of 8 in (32, 128], runs S
#: = Q K^T (and dP, and the backward's transposes) in W / 16 k-steps and O +=
#: P V (dQ, dK, dV) at N = W, W = ``product_dim(D)``, on the 64- and 128-wide
#: tiles, in the L2 order; all but bf16 at 64, 112 and 128 in the forward
#: (their own instantiations) and 64 and 128 in the backward
#: (``width_kernel``).  The whole-tile instantiations they replaced run by
#: name: ``kernel="wgmma_tile"`` and ``route="wgmma_tile"``, the yardsticks.
PRODUCT_WIDTHS = (48, 64, 80, 96, 112, 128)
#: The K and V that a group of the L2 order may hold, in bytes: a quarter of
#: the H100's 50 MB L2 (Q, O and the next group's first tiles pass through it
#: too).  At zamba2-7b's forward, groups of 8 of its 128 KV heads (7.3 MB)
#: ran the D-112 kernel in 0.2845-0.2877 ms of device time in two calls,
#: groups of 28 and 56 (25.7 and 51 MB) in 0.2957-0.2969 and 0.3082-0.3137,
#: all 128 at once (the grid's order) in 0.3901-0.3970 (H100 80GB HBM3,
#: 700 W; scripts/kernel_splits.py d112).
L2_KV_BUDGET = 50 * 2**20 // 4
#: The wide kernels (``wide_kernel``: every 16-bit head dim past 128, on the
#: tiles 192 and 256 wide, forward and backward, the L2 order): the
#: forward's keys a K/V tile and dQ's, by tile width (``hopper::wide_keys``,
#: ``hopper::wide_dq_keys``), and the registers a consumer thread takes from
#: the producer warpgroup at width 256 (``hopper::Wide``; the yardsticks,
#: ``kernel="wgmma_tile"`` and ``route="wgmma_tile"``, run the tiles' own
#: keys in the grid's order, at 256 without a producer).
WIDE_KEYS = {192: 96, 256: 64}
WIDE_DQ_KEYS = {192: 64, 256: 32}
WIDE_REGS = 240
#: The narrow tiles (widths 16 and 32, up to ``WGMMA_NARROW``): a box as
#: wide as the tile under the 32- or 64-byte swizzle, two blocks an SM of
#: 256 threads (no producer warpgroup: ``hopper.cuh::RolesOf``), a ring of
#: ``WGMMA_NARROW_STAGES`` in the forward.
WGMMA_NARROW = 32
WGMMA_NARROW_STAGES = 4
#: ``CUtensorMapSwizzle`` of a box's row bytes: 32, 64 or 128 (``tma_swizzle``).
TMA_SWIZZLE = {32: 1, 64: 2, 128: 3}
# The mma.sync and fp32 kernels' tiling: query rows per block (grid
# (ceil(Sq / 64), Hq, B)).
FWD_ROWS = 64

# The fma route's tiling (csrc/flash_attention_bwd.cu): tiles of 64 rows and
# keys, of 32 at padded width 256 (``bwd_tile_rows``).
BWD_ROWS = 64           # query rows per tile
BWD_KEYS = 64           # keys per tile
BWD_WIDE_ROWS = 32      # rows and keys per tile at padded width 256
BWD_THREADS = 256
#: The fma route's kernels in launch order, by their ``which`` in the C entry.
BWD_KERNELS = ("bwd_stats", "bwd_dkdv", "bwd_dq")

# The wgmma route's tiling (csrc/flash_attention_bwd.cu, namespace wg).
BWD_WGMMA_BOX_ROWS = 64     # rows of a TMA box, and of each consumer's share
BWD_WGMMA_DQ_ROWS = 128     # dQ: query rows per block
BWD_WGMMA_DQ_KEYS = 64      # dQ: keys per tile
BWD_WGMMA_KV_KEYS = 64      # dK/dV: keys per block
BWD_WGMMA_KV_ROWS = 64      # dK/dV: query rows per tile
BWD_WGMMA_STAGES = 4        # ring depth of either kernel up to width 128
BWD_WGMMA_WIDE_DQ_KEYS = 32     # dQ's keys per tile past width 128
BWD_WGMMA_WIDE_BOX_ROWS = 32    # every box's rows past width 128
#: The wgmma route's kernels in launch order, by their ``which`` in the C entry.
BWD_WGMMA_KERNELS = ("bwd_wgmma_dq", "bwd_wgmma_dkdv")
#: The same whole-tile kernels, by name (``route="wgmma_tile"``), at the head
#: dims of the head-dim kernels (``width_kernel(..., backward=True)``): the
#: yardstick they replaced.
BWD_WGMMA_TILE_KERNELS = ("bwd_wgmma_tile_dq", "bwd_wgmma_tile_dkdv")

# The mma route's tiling (csrc/flash_attention_bwd.cu, namespace mm): dQ
# blocks of 64 query rows over key tiles of 64, dK/dV blocks of 64 keys over
# query tiles of 64, 4 warps, tile rows of DP + 8 16-bit elements.
BWD_MMA_ROWS = 64
BWD_MMA_KEYS = 64
BWD_MMA_THREADS = 128
#: The largest head dim of the mma route (padded widths 16 and 32).
BWD_MMA_MAX_DIM = 32
#: The mma route's kernels in launch order, by their ``which`` in the C entry.
BWD_MMA_KERNELS = ("bwd_mma_dq", "bwd_mma_dkdv")

# The "tiled" route's tiling (csrc/f32_tiles.cuh): 16 x 16 threads, the
# accumulators' J = ceil(D / 16) slots of 16 columns (at most 16), tile rows
# of 16 J + 4 floats; what a block's shared memory may take.
TILED_THREADS = 256
TILED_MAX_SLOTS = 16
SMEM_LIMIT = 232_448
#: The "tiled" backward's kernels in launch order, by their ``which`` in the C entry.
BWD_TILED_KERNELS = ("bwd_tiled_dq", "bwd_tiled_dkdv")
#: Each backward route's kernels in launch order.
BWD_ROUTE_KERNELS = {"fma": BWD_KERNELS, "wgmma": BWD_WGMMA_KERNELS,
                     "wgmma_tile": BWD_WGMMA_TILE_KERNELS, "mma": BWD_MMA_KERNELS,
                     "tiled": BWD_TILED_KERNELS}

_lib: ctypes.CDLL | None = None
_bwd_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    instances.clear()


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
    rounded to bf16 (to fp16 for fp16 inputs, as the wgmma kernels round
    them) before the products that read them."""
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
        half = torch.float16 if q.dtype == torch.float16 else torch.bfloat16
        p, ds = p.to(half).float(), ds.to(half).float()
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
    bf16 (fp16 for fp16 inputs) where the kernels round them (P for dv, dS
    for dq and dk)."""
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
    lib.gqa_flash_fwd.argtypes = [i] + [p] * 5 + [i] * 7 + [ll] * 9 + [i] * 3 + [p]
    lib.gqa_flash_fwd.restype = i
    lib.gqa_flash_wgmma.argtypes = [i] + [p] * 5 + [i] * 8 + [p] + [i] * 3 + [ll, p]
    lib.gqa_flash_wgmma.restype = i
    lib.gqa_flash_tiled.argtypes = [p] * 5 + [i] * 7 + [ll] * 9 + [i] * 3 + [ll, p]
    lib.gqa_flash_tiled.restype = i
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
    lib.gqa_flash_bwd_mma.argtypes = [i, i] + [p] * 10 + [i] * 10 + [ctypes.c_longlong, p]
    lib.gqa_flash_bwd_mma.restype = i
    lib.gqa_flash_bwd_tiled.argtypes = [i, i] + [p] * 10 + [i] * 10 + [ctypes.c_longlong, p]
    lib.gqa_flash_bwd_tiled.restype = i
    lib.gqa_flash_bwd_wgmma.argtypes = [i, i] + [p] * 10 + [i] * 8 + [p] + [i] * 3 + \
        [ctypes.c_longlong, p]
    lib.gqa_flash_bwd_wgmma.restype = i
    _bwd_lib = lib
    return log


def _check_dtype_and_dim(dtype: torch.dtype, d: int, what: str) -> None:
    if dtype not in _FLOATS or not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"no {what} takes {dtype} at head dim {d}: dtypes "
                         f"{list(_FLOATS)}, head dims 1..{MAX_HEAD_DIM}")


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel that ``gqa_flash`` launches for this dtype and head dim:
    "wgmma" for bf16 and fp16 at every D, "fp32" for fp32 and fp64
    (``flash_tiled_kernel``); the first designs, "mma_sync" (16-bit),
    "wgmma_pad128" (bf16 D 112), "wgmma_tile" (the head-dim and wide
    kernels' (dtype, D): ``width_kernel``, ``wide_kernel``) and
    "fp32_simple", only on request."""
    _check_dtype_and_dim(dtype, d, "kernel")
    return "wgmma" if dtype in _HALF else "fp32"


def bwd_route(dtype: torch.dtype, d: int) -> str:
    """The backward's route for this dtype and head dim: "wgmma" where the
    forward's route is (it writes the LSE the wgmma backward reads), every
    16-bit D; "tiled" for fp32 and fp64 (on the LSE of the tiled forward);
    the first designs, "wgmma_tile" (the head-dim and wide kernels' (dtype,
    D)), "mma" (16-bit D <= 32) and "fma", only on request."""
    _check_dtype_and_dim(dtype, d, "backward kernel")
    return "wgmma" if route(dtype, d) == "wgmma" else "tiled"


def padded_dim(d: int) -> int:
    """The width of the tiles the mma.sync, fp32, mma and fma kernels run
    head dim d on: the least of ``PADDED_DIMS`` that holds it."""
    return next(p for p in PADDED_DIMS if d <= p)


def tma_width(d: int) -> int:
    """The row width of a staged copy at head dim d: the least multiple of 8
    that holds it, so that the 16-bit rows' byte strides are multiples of 16,
    as TMA needs (``stage``)."""
    return -(-d // 8) * 8


def wgmma_tile_dim(d: int) -> int:
    """The width of the Hopper kernels' tiles at head dim d (in [1, 256]):
    16 up to 16, 32 up to 32 (the narrow tiles), else the least multiple of
    64 that holds it, 64, 128, 192 or 256; TMA fills columns d.. with zeros
    (``hopper.cuh::tile_of``)."""
    if d <= WGMMA_NARROW:
        return 16 if d <= 16 else 32
    return -(-d // TMA_BOX_COLS) * TMA_BOX_COLS


def product_dim(d: int) -> int:
    """The width W of the head-dim kernels' products at head dim d (a
    multiple of 8 in (32, 128]): the least multiple of 16 that holds it, 48,
    64, 80, 96, 112 or 128 (``PRODUCT_WIDTHS``; ``hopper::by_width``)."""
    return -(-d // 16) * 16


def width_kernel(dtype: torch.dtype, d: int, backward: bool = False) -> bool:
    """Whether the Hopper route runs this dtype and head dim on a head-dim
    kernel (products ``product_dim(d)`` wide, the L2 order): 16-bit at a
    multiple of 8 in (32, 128], but for bf16 at 64 and 128 (and 112 in the
    forward: the D-112 kernel), which keep instantiations of their own."""
    if dtype not in _HALF or d % 8 or not 32 < d <= 128:
        return False
    return not (dtype == torch.bfloat16 and d in ((64, 128) if backward else WGMMA_TILE_DIM))


def wide_kernel(dtype: torch.dtype, d: int) -> bool:
    """Whether the Hopper route runs this dtype and head dim on a wide
    kernel (``hopper::Wide``): 16-bit at every D in (128, 256], the tiles 192
    or 256 wide, forward and backward, their blocks in the L2 order, the
    forward's K/V tiles of ``wide_keys(D)`` keys and dQ's of
    ``wide_dq_keys(D)``, at width 256 a producer warpgroup."""
    return dtype in _HALF and 128 < d <= MAX_HEAD_DIM


def wide_keys(d: int) -> int:
    """The wide kernels' forward keys a K/V tile at head dim d (past 128):
    ``WIDE_KEYS`` of its tiles' width."""
    return WIDE_KEYS[wgmma_tile_dim(d)]


def wide_dq_keys(d: int) -> int:
    """The wide dQ kernel's keys a K/V tile at head dim d (past 128)."""
    return WIDE_DQ_KEYS[wgmma_tile_dim(d)]


def wgmma_q_rows(keys: int) -> int:
    """The rows of the forward's Q boxes at K/V tiles of ``keys`` keys: the
    keys where they divide the block's 128 rows, else 64
    (``hopper::q_rows_of``)."""
    return keys if WGMMA_ROWS % keys == 0 else 64


def l2_order(dtype: torch.dtype, d: int) -> bool:
    """Whether the Hopper forward at this dtype and head dim runs its blocks
    in the L2 order (``plan``'s ``group_kv``): the D-112 kernel (bf16 at
    ``WGMMA_D112``), the head-dim kernels (``width_kernel``) and the wide
    kernels (``wide_kernel``).  The shape sets the groups (``kv_group``):
    where the K and V of every (batch, KV head) pair fit ``L2_KV_BUDGET``
    there is one group, which is the grid's order."""
    return (dtype == torch.bfloat16 and d == WGMMA_D112) or width_kernel(dtype, d) \
        or wide_kernel(dtype, d)


def _group(n: int, pair_bytes: int, budget: int) -> int:
    """The largest divisor of n whose pairs, ``pair_bytes`` each, fit
    ``budget`` bytes; at least 1."""
    most = max(1, budget // pair_bytes)
    return max(g for g in range(1, min(n, most) + 1) if n % g == 0)


def kv_group(b: int, sk: int, hkv: int, d: int, elt: int = 2,
             budget: int = L2_KV_BUDGET) -> int:
    """The KV heads a group of the L2 order holds: the largest divisor of
    the B x Hkv (batch, KV head) pairs whose K and V fit ``budget`` bytes
    (Sk x D x 2 elements of ``elt`` bytes a pair), at least 1.  Every group
    then holds as many, so the grid ends on a whole group's light tiles: a
    last group of a few heads would start its heaviest tiles among the last
    blocks (groups of 9 over zamba2-7b's 128 leave 2 and ran 4-6 % slower
    than groups of 8; scripts/kernel_splits.py d112)."""
    return _group(b * hkv, 2 * sk * d * elt, budget)


def rows_group(b: int, sq: int, hq: int, hkv: int, d: int, elt: int = 2,
               budget: int = L2_KV_BUDGET) -> int:
    """The KV heads a group of the dK/dV kernel's L2 order holds: the
    largest divisor of the B x Hkv pairs whose query heads' Q and dO (Sq x D
    x 2 elements of ``elt`` bytes a query head, Hq / Hkv query heads a pair)
    fit ``budget`` bytes, at least 1: what that kernel's blocks read again
    and again, as the forward's and dQ's read K and V."""
    return _group(b * hkv, 2 * sq * (hq // hkv) * d * elt, budget)


_T_NAMES = {torch.bfloat16: "__nv_bfloat16", torch.float16: "__half"}


def _wide_products(d: int, keys: int) -> str:
    """``hopper::Wide``'s Products at head dim d, with the kernel's keys."""
    tile = wgmma_tile_dim(d)
    return f"Products<{tile}, {tile}, true, {keys}, {WIDE_REGS if tile > 192 else 0}>"


@functools.lru_cache(maxsize=None)
def instance(dtype: torch.dtype, d: int, kernel: str | None = None) -> str:
    """The forward kernel instantiation that ``launch`` runs for this dtype
    and head dim through ``kernel`` (default: the route), as
    ``csrc/flash_attention.cu``'s C entry picks it; float64 names the fp32
    kernel its copies run on."""
    name = route(dtype, d) if kernel is None else kernel
    t = _T_NAMES.get(dtype)
    if name == "wgmma_pad128":
        return "flash_wgmma_kernel<128, 112, __nv_bfloat16>"
    if name in ("wgmma", "wgmma_tile"):
        tile = wgmma_tile_dim(d)
        if name == "wgmma" and dtype == torch.bfloat16 and d == WGMMA_D112:
            return "flash_wgmma_kernel<128, 112, __nv_bfloat16, Products<112, 112, true>>"
        if name == "wgmma" and width_kernel(dtype, d):
            w = product_dim(d)
            return f"flash_wgmma_kernel<{tile}, 0, {t}, Products<{w}, {w}, true>>"
        if name == "wgmma" and wide_kernel(dtype, d):
            return (f"flash_wgmma_kernel<{tile}, {0 if d % 8 == 0 else -1}, {t}, "
                    f"{_wide_products(d, wide_keys(d))}>")
        pinned = dtype == torch.bfloat16 and d in WGMMA_TILE_DIM
        return f"flash_wgmma_kernel<{tile}, {d if pinned else 0 if d % 8 == 0 else -1}, {t}>"
    if name == "mma_sync":
        return f"flash_mma_kernel<{t}, {padded_dim(d)}>"
    if name == "fp32_simple":
        return f"flash_f32_kernel<{padded_dim(d)}>"
    return f"flash_tiled_kernel<{tiled_slots(d)}>"


@functools.lru_cache(maxsize=None)
def bwd_instance(dtype: torch.dtype, d: int, route: str | None = None,
                 which: int | None = None) -> str:
    """The backward kernel instantiation of kernel ``which`` (its index in
    ``BWD_ROUTE_KERNELS[route]``; None: the route's kernels in one name) that
    ``launch_bwd`` runs for this dtype and head dim on ``route`` (default:
    ``bwd_route``), as ``csrc/flash_attention_bwd.cu``'s C entries pick it."""
    name = bwd_route(dtype, d) if route is None else route
    kinds = {"fma": ("stats", "dkdv", "dq")}.get(name, ("dq", "dkdv"))
    kind = "{" + ",".join(kinds) + "}" if which is None else kinds[which]
    t = _T_NAMES.get(dtype)
    if name in ("wgmma", "wgmma_tile"):
        tile = wgmma_tile_dim(d)
        if name == "wgmma" and width_kernel(dtype, d, backward=True):
            w = product_dim(d)
            return f"flash_bwd_{kind}_wgmma_kernel<{tile}, 0, {t}, Products<{w}, {w}, true>>"
        if name == "wgmma" and wide_kernel(dtype, d):
            return (f"flash_bwd_{kind}_wgmma_kernel<{tile}, {0 if d % 8 == 0 else -1}, {t}, "
                    f"{_wide_products(d, wide_dq_keys(d))}>")
        pinned = dtype == torch.bfloat16 and d in WGMMA_TILE_DIM
        return (f"flash_bwd_{kind}_wgmma_kernel<{tile}, "
                f"{d if pinned else 0 if d % 8 == 0 else -1}, {t}>")
    if name == "mma":
        return f"flash_bwd_{kind}_mma_kernel<{t}, {padded_dim(d)}>"
    if name == "tiled":
        return f"flash_bwd_{kind}_tiled_kernel<{tiled_slots(d)}>"
    elt = t or "float"
    return f"flash_bwd_{kind}_kernel<{elt}, {padded_dim(d)}>"


def tma_box_cols(d: int) -> int:
    """The inner extent of the tensor maps' boxes at head dim d, in
    elements: the tiles' width up to 64 (16 or 32 for the narrow tiles), else
    64, one 128-byte swizzled row (``hopper.cuh::Swz<D>::COLS``)."""
    return min(wgmma_tile_dim(d), TMA_BOX_COLS)


def tma_swizzle(d: int) -> int:
    """The ``CUtensorMapSwizzle`` the maps of head dim d are encoded with:
    the swizzle that spans a box's row, 32, 64 or 128 bytes (1, 2, 3), as
    ``hopper.cuh::encode_maps`` derives it from the box's inner extent."""
    return TMA_SWIZZLE[2 * tma_box_cols(d)]


def wgmma_keys(d: int) -> int:
    """Keys per K/V tile of the Hopper forward at head dim d, and the rows
    of its tensor maps' boxes (Q comes in 128 / that boxes a column box):
    128 up to width 128, 64 past it, where the output's D/2 floats a thread
    leave room for only 64 keys of S and P."""
    return WGMMA_KEYS if wgmma_tile_dim(d) <= 128 else WGMMA_WIDE_KEYS


def wgmma_stages(d: int, keys: int | None = None, ordered: bool = False) -> int:
    """Depth of the Hopper kernel's K/V ring at head dim d: at the tiles'
    own keys (``wgmma_keys``, the default) what fits 227 KB
    (``WGMMA_NARROW_STAGES`` at the narrow widths, 16 KB a stage at 32); at
    other keys (the wide kernels' 96 at width 192) 2.  ``ordered``: a kernel
    in the L2 order (``l2_order``), which on the tiles 64 and 128 wide
    overlaps its softmax with its products and holds a stage a turn longer
    (``hopper::overlapped``): 3 stages at width 128 too."""
    tile = wgmma_tile_dim(d)
    if ordered and tile == 128:
        return 3
    if keys is not None and keys != wgmma_keys(d):
        return 2
    return WGMMA_NARROW_STAGES if tile <= WGMMA_NARROW else 3 if tile in (64, 192) else 2


def wgmma_smem_bytes(d: int, keys: int | None = None, ordered: bool = False) -> int:
    """The Hopper kernel's dynamic shared memory at head dim d: 1024 bytes
    of alignment slack, the Q tile (128 rows), a ring of K and V tiles
    (``keys`` rows, by default ``wgmma_keys(d)``; ``wgmma_stages`` deep),
    each ``wgmma_tile_dim(d)`` columns wide, 8 bytes per mbarrier."""
    row = wgmma_tile_dim(d) * 2
    keys = wgmma_keys(d) if keys is None else keys
    stages = wgmma_stages(d, keys, ordered)
    return 1024 + WGMMA_ROWS * row + 2 * stages * keys * row + 8 * (1 + 3 * stages)


def mma_smem_bytes(d: int) -> int:
    """The mma.sync kernel's dynamic shared memory at head dim d: two
    buffers each of K and V tiles of 64 keys with rows of DP + 8 16-bit
    elements (DP = ``padded_dim(d)``), and at DP 256 the Q tile, which there
    stays in shared memory."""
    dp = padded_dim(d)
    return 2 * (4 + (dp > 128)) * 64 * (dp + 8)


def f32_smem_bytes(d: int) -> int:
    """The fp32 kernel's: fp32 Q, K and V tiles of 64 rows with row stride
    DP + 1, and a 64 x 65 tile of P."""
    dp = padded_dim(d)
    return 4 * ((FWD_ROWS + 2 * 64) * (dp + 1) + FWD_ROWS * 65)


def tiled_slots(d: int) -> int:
    """The "tiled" kernels' accumulator slots of 16 columns at head dim d
    (the instantiation's J): thread column tx holds columns tx + 16 j, j <
    ceil(D / 16), past 8 rounded up to an even count (the widths past 128
    build 4 instantiations of each kernel, not 8)."""
    j = -(-d // 16)
    return j if j <= 8 else -(-j // 2) * 2


def tiled_width(d: int) -> int:
    """The columns the "tiled" kernels' S-like products run over at head dim
    d: the least multiple of 8 that holds it (104 at D 100); every tile's
    columns past D are zeros."""
    return -(-d // 8) * 8


def tiled_row_stride(d: int) -> int:
    """The row stride, in floats, of the "tiled" kernels' Q, K, V and dO
    tiles: 16 J + 4 (J = ``tiled_slots(d)``), 4 times an odd number, so that
    eight lanes reading 16 bytes of eight consecutive rows hit distinct
    banks."""
    return 16 * tiled_slots(d) + 4


@dataclass(frozen=True)
class Tiling:
    """A "tiled" kernel's tile at one head dim: ``rt`` of its ``rows`` A-rows
    and ``ct`` of its ``cols`` B-rows a thread (the score tile's rows and
    columns: query rows and keys in the forward and dQ, keys and query rows
    in dK/dV), and its dynamic shared memory in bytes."""
    rows: int
    cols: int
    rt: int
    ct: int
    smem: int


def tiled_fwd_tiling(d: int) -> Tiling:
    """``flash_tiled_kernel``'s (``FwdTiles``): 16 RT query rows a block (RT
    8 up to width 128, 4 past it), tiles of 128 keys (8 x 8 scores a thread)
    where Q, K, V and the P^T buffer (64 keys: ``xty_chunks``) fit at RT 8,
    else 64, else 32."""
    rt, rs = (8 if tiled_slots(d) <= 8 else 4), tiled_row_stride(d)
    rows = 16 * rt

    def smem(keys):
        return 4 * ((rows + 2 * keys) * rs + min(keys, 64) * (rows + 4))

    keys = next(n for n in ((128, 64, 32) if rt == 8 else (64, 32)) if smem(n) <= SMEM_LIMIT)
    return Tiling(rows, keys, rt, keys // 16, smem(keys))


def tiled_dq_tiling(d: int) -> Tiling:
    """``flash_bwd_dq_tiled_kernel``'s (``DqTiles``): 16 RT query rows a
    block (RT 8 up to width 128, 4 past it), tiles of 64 keys where Q, dO,
    K, V and dS^T fit, else 32."""
    rt, rs = (8 if tiled_slots(d) <= 8 else 4), tiled_row_stride(d)
    rows = 16 * rt

    def smem(keys):
        return 4 * ((2 * rows + 2 * keys) * rs + keys * (rows + 4))

    keys = next(n for n in (64, 32) if smem(n) <= SMEM_LIMIT)
    return Tiling(rows, keys, rt, keys // 16, smem(keys))


def tiled_dkdv_tiling(d: int) -> Tiling:
    """``flash_bwd_dkdv_tiled_kernel``'s (``DkdvTiles``): 16 RT keys a block
    (RT 8 up to width 112, 4 at 128, 2 past it), query tiles of 64 rows
    where K, V, two Q buffers, dO, the P^T / dS^T buffer (all the tile's
    rows, half of them at RT 8: ``xty_chunks``) and two buffers of the rows'
    LSE and D_i fit, else 32."""
    j, rs = tiled_slots(d), tiled_row_stride(d)
    rt = 8 if j < 8 else 4 if j == 8 else 2
    keys, chunks = 16 * rt, 2 if rt == 8 else 1

    def smem(rows):
        return 4 * ((2 * keys + 3 * rows) * rs + rows // chunks * (keys + 4) + 4 * rows)

    rows = next(n for n in (64, 32) if smem(n) <= SMEM_LIMIT)
    return Tiling(keys, rows, rt, rows // 16, smem(rows))


def tensor_map(t: torch.Tensor, rows: int = WGMMA_ROWS) -> tuple[int, ...]:
    """The 4-D TMA map over t (B, S, H, D), innermost first: dims
    (D, H, S, B), byte strides along H, S and B, box (``tma_box_cols(D)``,
    1, rows, 1): 16 or 32 columns at D <= 32, else 64, encoded under the
    swizzle of that row (``tma_swizzle``).  Where D is not a multiple of the
    tiles' width (112, 40, 24, 5 ...) the last box of a row reaches past D:
    TMA fills its columns D.. with zeros."""
    b, s, h, d = t.shape
    e = t.element_size()
    return (d, h, s, b, t.stride(2) * e, t.stride(1) * e, t.stride(0) * e,
            tma_box_cols(d), 1, rows, 1)


@dataclass(frozen=True)
class Plan:
    """A launch: its route, its grid ((Hq, B, query tiles of 128) for the
    Hopper kernels, (B x Hq x query tiles of 128, 1, 1) for those in the
    L2 order (``l2_order``), (Hq, B, query tiles of
    ``tiled_fwd_tiling(D).rows``) for the tiled kernel ("fp32"), (query
    tiles of 64, Hq, B) for the others) and, for the Hopper kernels, the
    tensor maps of q, k and v (eleven numbers each, ``tensor_map``), for
    them and the tiled kernel the dynamic shared memory (the others' is
    fixed by the padded width: ``mma_smem_bytes``, ``f32_smem_bytes``);
    ``group_kv``, the L2 order's KV heads a group (``kv_group``; 0 in the
    grid's order).  float64 inputs are planned as the float32 copies the
    launch runs on."""
    route: str
    maps: tuple[int, ...] | None = None
    grid: tuple[int, int, int] | None = None
    smem: int | None = None
    group_kv: int = 0


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal_offset: int) -> None:
    if q.dtype not in _FLOATS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the CUDA kernels take float16, bfloat16, float32 or float64 "
                        f"q/k/v of one dtype, got {q.dtype} / {k.dtype} / {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)} are not (B, Sq, Hq, D), (B, Sk, Hkv, D) x2")
    b, sq, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[2] != 0 or 0 in q.shape \
            or 0 in k.shape:
        raise ValueError(f"shapes {tuple(q.shape)} and {tuple(k.shape)} do not "
                         "match: same B and D, Hq a multiple of Hkv, no empty dim")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} above {MAX_HEAD_DIM}, the largest a kernel takes")
    if b > 65535 or hq > 65535:
        raise ValueError(f"B={b} and Hq={hq} must be at most 65535")
    if causal_offset < 0 or causal_offset >= 2**31 - sq:
        raise ValueError(f"causal_offset {causal_offset} outside [0, 2^31 - Sq)")


def _tma_ready(t: torch.Tensor) -> bool:
    """Whether TMA can read t: unit stride along D, the other strides and
    the start 16-byte aligned."""
    align = 16 // t.element_size()
    return t.stride(3) == 1 and not any(s % align for s in t.stride()[:3]) \
        and t.data_ptr() % 16 == 0


def _readable(t: torch.Tensor, name: str) -> bool:
    """Whether the kernels of route ``name`` read t as it lies."""
    return _tma_ready(t) if name in _TMA_ROUTES else t.stride(3) == 1


def _check_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal_offset: int,
                  name: str) -> None:
    """The shapes, and a layout the kernels of route ``name`` read: unit
    stride along D; for "wgmma" (TMA) also the other strides multiples of
    16 bytes and a 16-byte aligned start."""
    _check_shapes(q, k, v, causal_offset)
    align = 16 // q.element_size()
    for nm, t in (("q", q), ("k", k), ("v", v)):
        if name in _TMA_ROUTES and not _tma_ready(t):
            raise ValueError(f"{nm} needs unit stride along D, the other strides "
                             f"multiples of {align} elements and a 16-byte aligned "
                             f"start; got strides {t.stride()}")
        if t.stride(3) != 1:
            raise ValueError(f"{nm} needs unit stride along D; got strides {t.stride()}")


def plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal_offset: int = 0,
         kernel: str | None = None) -> Plan:
    """Check q/k/v's layout and plan the launch of ``kernel`` (default: the
    route of q's dtype and D).  The Hopper kernel's inputs must be as TMA
    reads them (``launch`` stages those that are not: ``stage``).  The
    D-112 kernel, the head-dim kernels and the wide kernels (``l2_order``)
    take the L2 order: a 1-D grid and ``kv_group``'s KV heads a group, the
    wide kernels' K/V boxes ``wide_keys(D)`` rows high (Q's
    ``wgmma_q_rows`` of them); "wgmma_tile" (the head-dim and wide kernels'
    yardstick, the whole-tile instantiations) and "wgmma_pad128" (the D-112
    kernel's) keep the grid's order."""
    _check_shapes(q, k, v, causal_offset)
    d = q.shape[3]
    name = route(q.dtype, d) if kernel is None else kernel
    ok = {"wgmma": q.dtype in _HALF,
          "wgmma_pad128": q.dtype == torch.bfloat16 and d == WGMMA_D112,
          "wgmma_tile": width_kernel(q.dtype, d) or wide_kernel(q.dtype, d),
          "mma_sync": q.dtype in _HALF,
          "fp32": q.dtype in (torch.float32, torch.float64),
          "fp32_simple": q.dtype in (torch.float32, torch.float64)}
    if not ok.get(name, False):
        raise ValueError(f"kernel {name!r} does not take {q.dtype} at head dim {d}")
    _check_layout(q, k, v, causal_offset, name)
    b, sq, hq, _ = q.shape
    if name == "fp32":
        t = tiled_fwd_tiling(d)
        return Plan(name, grid=(hq, b, -(-sq // t.rows)), smem=t.smem)
    if name not in _TMA_ROUTES:
        return Plan(name, grid=(-(-sq // FWD_ROWS), hq, b))
    keys, tiles = wgmma_keys(d), -(-sq // WGMMA_ROWS)
    if name == "wgmma" and wide_kernel(q.dtype, d):
        keys = wide_keys(d)
    maps = tensor_map(q, wgmma_q_rows(keys)) + tensor_map(k, keys) + tensor_map(v, keys)
    if name == "wgmma" and l2_order(q.dtype, d):
        _, sk, hkv, _ = k.shape
        return Plan(name, maps=maps, grid=(b * hq * tiles, 1, 1),
                    smem=wgmma_smem_bytes(d, keys, ordered=True),
                    group_kv=kv_group(b, sk, hkv, d, q.element_size()))
    return Plan(name, maps=maps, grid=(hq, b, tiles), smem=wgmma_smem_bytes(d))


@dataclass(frozen=True)
class BwdPlan:
    """The backward's launches on its route: grid (x, y, z) and dynamic
    shared memory of each kernel of ``BWD_ROUTE_KERNELS[route]``, in that
    order, for "wgmma" and "wgmma_tile" the tensor maps of q, k, v and do
    (eleven numbers each), and each kernel's KV heads a group of the L2
    order (0 in the grid's order: every kernel but the head-dim ones)."""
    route: str
    grids: tuple[tuple[int, int, int], ...]
    smem: tuple[int, ...]
    maps: tuple[int, ...] | None = None
    groups: tuple[int, ...] = (0, 0)


def bwd_tile_rows(d: int) -> int:
    """Rows and keys of the fma kernels' tiles at head dim d: 64, or 32 at
    padded width 256 (fp32 tiles of 64 x 257 would not fit the dK/dV
    kernel's shared memory)."""
    return BWD_WIDE_ROWS if padded_dim(d) > 128 else BWD_ROWS


def bwd_smem_bytes(d: int) -> tuple[int, int, int]:
    """Dynamic shared memory of the stats, dK/dV and dQ kernels at head dim
    d: fp32 tiles of R = ``bwd_tile_rows(d)`` rows with row stride DP + 1
    (DP = ``padded_dim(d)``), score tiles R x (R + 1)."""
    r, dp = bwd_tile_rows(d), padded_dim(d)
    tile = r * (dp + 1)
    ps = r + 1
    return (4 * 2 * tile, 4 * (4 * tile + 2 * r * ps + 2 * r), 4 * (4 * tile + r * ps))


def bwd_mma_smem_bytes(d: int) -> tuple[int, int]:
    """Dynamic shared memory of the mma route's dQ and dK/dV kernels at head
    dim d <= 32: six tiles of 64 rows of DP + 8 16-bit elements (dQ: Q, dO
    and two buffers each of K and V; dK/dV: K, V and two buffers each of Q
    and dO), and for dK/dV each buffer's 64 LSEs and 64 D_i in fp32."""
    tiles = 2 * 6 * BWD_MMA_ROWS * (padded_dim(d) + 8)
    return tiles, tiles + 4 * 2 * 2 * BWD_MMA_ROWS


def bwd_wgmma_box_rows(d: int) -> int:
    """Rows of the wgmma backward's TMA boxes at head dim d: 64, or 32 past
    width 128."""
    return BWD_WGMMA_BOX_ROWS if wgmma_tile_dim(d) <= 128 else BWD_WGMMA_WIDE_BOX_ROWS


def bwd_wgmma_dq_keys(d: int) -> int:
    """Keys per K/V tile of the wgmma route's dQ kernel at head dim d: 64,
    or 32 past width 128, where Q and dO of 128 rows (128 KiB at 256) leave
    room for three stages of 32 keys and one of 64."""
    return BWD_WGMMA_DQ_KEYS if wgmma_tile_dim(d) <= 128 else BWD_WGMMA_WIDE_DQ_KEYS


def bwd_wgmma_stages(d: int, dq_keys: int | None = None) -> tuple[int, int]:
    """Ring depths of the wgmma route's dQ and dK/dV kernels at head dim d:
    what fits 227 KB, at most ``BWD_WGMMA_STAGES``; dQ's at its K/V tiles of
    ``dq_keys`` keys (by default ``bwd_wgmma_dq_keys(d)``; the wide dQ
    kernel's ``wide_dq_keys``)."""
    tile = wgmma_tile_dim(d)
    s_kv = {256: 2, 192: 3}.get(tile, BWD_WGMMA_STAGES)
    if dq_keys is not None and dq_keys != bwd_wgmma_dq_keys(d):
        cols = tile * 2
        fit = (SMEM_LIMIT - 1024 - 2 * BWD_WGMMA_DQ_ROWS * cols - 8) // (2 * dq_keys * cols + 16)
        return min(fit, BWD_WGMMA_STAGES), s_kv
    return (3 if tile == 256 else BWD_WGMMA_STAGES, s_kv)


def bwd_wgmma_smem_bytes(d: int, dq_keys: int | None = None) -> tuple[int, int]:
    """Dynamic shared memory of the wgmma route's dQ and dK/dV kernels at
    head dim d: 1024 bytes of alignment slack; dQ: Q and dO (128 rows) and a
    ring of K and V tiles (``dq_keys`` keys, by default
    ``bwd_wgmma_dq_keys(d)``); dK/dV: K and V (64 keys), a ring of Q and dO
    tiles (64 rows) with each stage's 64 LSEs and D_i in fp32, and two 64 x
    64 fp32 buffers of P^T; tiles ``wgmma_tile_dim(d)`` columns wide, 8
    bytes per mbarrier of each ring."""
    cols = wgmma_tile_dim(d) * 2
    dq_keys = bwd_wgmma_dq_keys(d) if dq_keys is None else dq_keys
    s_dq, s_kv = bwd_wgmma_stages(d, dq_keys)
    dq = 2 * BWD_WGMMA_DQ_ROWS * cols + 2 * s_dq * dq_keys * cols
    dkdv = 2 * BWD_WGMMA_KV_KEYS * cols + s_kv * (2 * BWD_WGMMA_KV_ROWS * cols
                                                  + 2 * BWD_WGMMA_KV_ROWS * 4) \
        + 2 * BWD_WGMMA_KV_KEYS * BWD_WGMMA_KV_ROWS * 4
    return 1024 + dq + 8 * (1 + 2 * s_dq), 1024 + dkdv + 8 * (1 + 2 * s_kv)


def plan_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
             do: torch.Tensor, causal_offset: int = 0, route: str | None = None) -> BwdPlan:
    """Check the backward's inputs (the forward's dtypes and head dims, unit
    stride along D; o and do shaped as q, in its dtype) and plan the
    launches of ``route`` (default: ``bwd_route`` of q's dtype and D).
    "tiled" (fp32 and fp64): dQ over (Hq, B, query tiles of
    ``tiled_dq_tiling(D).rows``), dK/dV over (Hkv, B, key blocks of
    ``tiled_dkdv_tiling(D).rows``); "fma": stats and dQ over (query tiles,
    Hq, B), dK/dV over (key tiles, Hkv, B), tiles of ``bwd_tile_rows(D)``;
    "mma" (bf16 and fp16 at D <=
    32): dQ over (query tiles of 64, Hq, B), dK/dV over (key tiles of 64,
    Hkv, B); "wgmma" (bf16 and fp16 at every D, q, k, v as TMA reads
    them, do in rows ``tma_width(D)`` wide): dQ over (Hq, B, query tiles of 128), dK/dV over (Hkv, B,
    key tiles of 64), boxes of ``bwd_wgmma_box_rows(D)`` rows; the head-dim
    and wide kernels on 1-D grids in the L2 order (``groups``).  float64
    inputs are planned as the float32 copies the launch runs on."""
    _check_shapes(q, k, v, causal_offset)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} must be shaped as q "
                             f"{tuple(q.shape)} in {q.dtype}")
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    name = bwd_route(q.dtype, d) if route is None else route
    if name == "fma":
        _check_layout(q, k, v, causal_offset, name)
        r = bwd_tile_rows(d)
        q_tiles = -(-sq // r)
        k_tiles = -(-sk // r)
        return BwdPlan("fma", grids=((q_tiles, hq, b), (k_tiles, hkv, b), (q_tiles, hq, b)),
                       smem=bwd_smem_bytes(d))
    if name == "tiled":
        if q.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"backward route 'tiled' does not take {q.dtype}")
        _check_layout(q, k, v, causal_offset, name)
        dq_t, kv_t = tiled_dq_tiling(d), tiled_dkdv_tiling(d)
        return BwdPlan("tiled", grids=((hq, b, -(-sq // dq_t.rows)), (hkv, b, -(-sk // kv_t.rows))),
                       smem=(dq_t.smem, kv_t.smem))
    ok = {"mma": d <= BWD_MMA_MAX_DIM, "wgmma": True,
          "wgmma_tile": width_kernel(q.dtype, d, backward=True) or wide_kernel(q.dtype, d)}
    if not ok.get(name, False) or q.dtype not in _HALF:
        raise ValueError(f"backward route {name!r} does not take {q.dtype} at head dim {d}")
    if name == "mma":
        _check_layout(q, k, v, causal_offset, name)
        return BwdPlan("mma", grids=((-(-sq // BWD_MMA_ROWS), hq, b),
                                     (-(-sk // BWD_MMA_KEYS), hkv, b)),
                       smem=bwd_mma_smem_bytes(d))
    _check_layout(q, k, v, causal_offset, name)
    w = tma_width(d)
    if do.stride() != (sq * hq * w, hq * w, w, 1) or do.data_ptr() % 16:
        raise ValueError(f"do must lie in rows {w} wide (``stage``'s layout), 16-byte "
                         f"aligned, for its tensor map and the D_i pass; got strides "
                         f"{do.stride()}")
    rows = bwd_wgmma_box_rows(d)
    maps = tensor_map(q, rows) + tensor_map(k, rows) + tensor_map(v, rows) + tensor_map(do, rows)
    q_tiles, k_tiles = -(-sq // BWD_WGMMA_DQ_ROWS), -(-sk // BWD_WGMMA_KV_KEYS)
    wide = wide_kernel(q.dtype, d)
    if name == "wgmma" and (width_kernel(q.dtype, d, backward=True) or wide):
        elt = q.element_size()
        groups = (kv_group(b, sk, hkv, d, elt), rows_group(b, sq, hq, hkv, d, elt))
        return BwdPlan(name, grids=((b * hq * q_tiles, 1, 1), (b * hkv * k_tiles, 1, 1)),
                       smem=bwd_wgmma_smem_bytes(d, wide_dq_keys(d) if wide else None),
                       maps=maps, groups=groups)
    return BwdPlan(name, grids=((hq, b, q_tiles), (hkv, b, k_tiles)),
                   smem=bwd_wgmma_smem_bytes(d), maps=maps)


class FlashAttention(torch.autograd.Function):
    """``gqa_flash`` with its gradient: the forward saves q, k, v, the output
    and, on CUDA tensors, its rows' LSE (every default route's forward
    writes it); the backward is
    ``gqa_flash_bwd``.  On CUDA tensors of the Hopper route the forward
    stages the q, k and v that TMA cannot read (``stage``) and saves the
    staged views, so the backward stages only dO."""

    @staticmethod
    def forward(ctx, q, k, v, causal_offset: int):
        if q.device.type == "cuda" and route(q.dtype, q.shape[-1]) == "wgmma":
            q, k, v = (_readable_copy(t, "wgmma") for t in (q, k, v))
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
    "wgmma", "mma" and "tiled" routes, S and dP twice beside dV, dK and dQ,
    and 8 on "fma", whose stats pass adds one S); each input read once and each
    output written once: q, k, v in and o (and the LSE, with ``lse``) out;
    q, k, v, o, dO and the LSE in, dq, dk, dv and D_i out.  A staged call
    (the Hopper route at a D off a multiple of 8) adds its copies, each
    tensor read and written once: q, k and v in the forward, dO in the
    backward (``FlashAttention`` hands it the forward's staged q, k, v)."""
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    pairs = sum(min(max(i + causal_offset + 1, 0), sk) for i in range(sq))
    products = 2 if not backward else (8 if bwd_route(q.dtype, d) == "fma" else 7)
    flops = products * 2 * d * hq * b * pairs
    qb, kb = q.numel() * q.element_size(), k.numel() * k.element_size()
    qkv = 2 * qb + 2 * kb
    rows = 4 * b * hq * sq                          # one fp32 per query row and head
    nbytes = qkv + (rows if lse else 0) if not backward else \
        2 * qkv + 2 * kb + 2 * rows
    if route(q.dtype, d) == "wgmma" and tma_width(d) != d:
        nbytes += 2 * qb if backward else 2 * (qb + 2 * kb)
    return flops, nbytes


def _meta_forward(q, k, v, causal_offset: int, with_lse: bool):
    from repro_torch.launch.op_analysis import record_kernel

    b, sq, hq, d = q.shape
    lse = with_lse
    record_kernel("gqa_flash", *kernel_work(q, k, causal_offset, False, lse))
    return (torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device),
            torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if lse else None)


def _forward(q, k, v, causal_offset: int, with_lse: bool = False):
    """(output, LSE): on CUDA tensors the LSE (B, Hq, Sq) fp32 when
    ``with_lse`` asks for it (the backward routes read the forward's), else
    None; None on the CPU."""
    if _on_cpu(q, k, v):
        return gqa_flash_plain(q, k, v, causal_offset), None
    if _on_meta(q, k, v):
        return _meta_forward(q, k, v, causal_offset, with_lse)
    if with_lse:
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
    kernels of ``csrc/flash_attention_bwd.cu`` on CUDA tensors (every route
    but "fma" reads ``lse``, the forward's)."""
    if _on_cpu(q, k, v, o, do):
        return gqa_flash_bwd_plain(q, k, v, o, do, causal_offset)
    if _on_meta(q, k, v, o, do):
        from repro_torch.launch.op_analysis import record_kernel

        record_kernel("gqa_flash_bwd", *kernel_work(q, k, causal_offset, True))
        return (torch.empty(q.shape, dtype=q.dtype, device=q.device),
                torch.empty(k.shape, dtype=k.dtype, device=k.device),
                torch.empty(v.shape, dtype=v.dtype, device=v.device))
    return launch_bwd(q, k, v, o, do, causal_offset, lse=lse)


def stage(t: torch.Tensor) -> torch.Tensor:
    """t copied into a buffer (B, S, H, ``tma_width(D)``), returned as its
    [..., :D] view: a layout TMA reads (byte strides multiples of 16, a
    16-byte aligned start) whose extent stays D, so the tensor maps
    zero-fill columns D..; the pad columns are never read.  One copy, added
    to ``launches["layout_copy"]``."""
    b, s, h, d = t.shape
    buf = torch.empty((b, s, h, tma_width(d)), dtype=t.dtype, device=t.device)
    view = buf[..., :d]
    view.copy_(t)
    launches["layout_copy"] += 1
    return view


def _readable_copy(t: torch.Tensor, name: str) -> torch.Tensor:
    """t, or a copy of it where route ``name`` cannot read its layout: for
    the Hopper route the staged view (``stage``), for the others a
    contiguous copy (each copy counted under "layout_copy")."""
    if _readable(t, name):
        return t
    if name in _TMA_ROUTES:
        return stage(t)
    launches["layout_copy"] += 1
    return t.contiguous()


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal_offset: int = 0,
           kernel: str | None = None, with_lse: bool = False):
    """``gqa_flash`` on CUDA tensors through ``kernel`` ("wgmma",
    "wgmma_pad128", "wgmma_tile", "mma_sync", "fp32" or "fp32_simple";
    default: its route), to hold one kernel against another at one shape:
    "wgmma" runs the head-dim and wide kernels where ``width_kernel`` and
    ``wide_kernel`` say so, "wgmma_tile" the whole-tile instantiations they
    replaced.  With
    ``with_lse`` (every kernel but "fp32_simple") returns (output, LSE (B,
    Hq, Sq) fp32); the output is the same either way.  float64 runs the fp32 kernels on fp32 copies, the output
    cast back; an input whose layout the kernel cannot read is copied first
    (``_readable_copy``)."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"q ({q.device}), k ({k.device}) and v ({v.device}) "
                         "must lie on the same CUDA device")
    _check_shapes(q, k, v, causal_offset)
    if q.dtype == torch.float64:
        got = launch(q.float(), k.float(), v.float(), causal_offset, kernel, with_lse)
        return (got[0].double(), got[1]) if with_lse else got.double()
    name = route(q.dtype, q.shape[3]) if kernel is None else kernel
    q, k, v = (_readable_copy(t, name) for t in (q, k, v))
    pl = plan(q, k, v, causal_offset, kernel)
    if with_lse and pl.route == "fp32_simple":
        raise ValueError("the first-design fp32 kernel writes no LSE (the tiled one does)")
    build()
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if with_lse else None
    lse_ptr = None if lse is None else lse.data_ptr()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if pl.route in _TMA_ROUTES:
        maps = (ctypes.c_ulonglong * len(pl.maps))(*pl.maps)
        err = _lib.gqa_flash_wgmma(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse_ptr, b, sq, sk, hq, hkv, d, int(causal_offset), pl.group_kv, maps, *pl.grid,
            pl.smem, stream)
    elif pl.route == "fp32":
        err = _lib.gqa_flash_tiled(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse_ptr, b, sq, sk, hq,
            hkv, d, int(causal_offset), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *pl.grid, pl.smem, stream)
    else:
        err = _lib.gqa_flash_fwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse_ptr, b, sq, sk, hq, hkv, d, int(causal_offset),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *pl.grid, stream)
    if err != 0:
        raise RuntimeError(f"the {pl.route} kernel of gqa_flash failed: "
                           + (f"cudaError_t {err}" if err > 0
                              else f"CUresult {-err} encoding a tensor map"))
    launches["gqa_flash"] += 1
    launches[pl.route] += 1
    key = instance(q.dtype, d, pl.route)
    instances[key] = instances.get(key, 0) + 1
    return (out, lse) if with_lse else out


def launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
               do: torch.Tensor, causal_offset: int = 0, lse: torch.Tensor | None = None,
               route: str | None = None):
    """``gqa_flash_bwd`` on CUDA tensors on ``route`` (default: ``bwd_route``):
    "wgmma" launches dQ (which writes D_i) then dK/dV (the head-dim kernels
    where ``width_kernel(..., backward=True)`` says so, the wide pair past
    128), "wgmma_tile" the whole-tile pair they replaced (the yardstick),
    "mma" the same pair
    on mma.sync, "tiled" the same pair on fp32 FMA, each reading ``lse``,
    the forward's (B, Hq, Sq) fp32; "fma" launches the stats kernel (LSE and
    D_i into fp32 scratch), then dK/dV and dQ, and ignores ``lse``.  o and
    do are made contiguous, and so are q, k and v except on "wgmma" and
    "wgmma_tile", whose
    tensor maps read them as they lie where TMA can (q, k, v and do staged
    where it cannot: ``_readable_copy``; the staged do is also what the D_i
    pass reads); float64 runs the fp32 kernels ("tiled" or "fma") on fp32
    copies, the gradients cast back."""
    if any(t.device.type != "cuda" or t.device != q.device for t in (q, k, v, o, do)):
        raise ValueError("q, k, v, o and do must lie on the same CUDA device")
    _check_shapes(q, k, v, causal_offset)
    if q.dtype == torch.float64:
        grads = launch_bwd(*(t.float() for t in (q, k, v, o, do)), causal_offset, lse=lse,
                           route=route)
        return tuple(g.double() for g in grads)
    name = bwd_route(q.dtype, q.shape[-1]) if route is None else route
    o, do = o.contiguous(), do.contiguous()
    if name in _TMA_ROUTES:
        q, k, v, do = (_readable_copy(t, name) for t in (q, k, v, do))
    else:
        q, k, v = (t.contiguous() for t in (q, k, v))
    pl = plan_bwd(q, k, v, o, do, causal_offset, name)
    if pl.route != "fma":
        b, sq, hq, _ = q.shape
        if lse is None or lse.shape != (b, hq, sq) or lse.dtype != torch.float32 \
                or lse.device != q.device:
            raise ValueError(f"the {pl.route} backward reads the forward's LSE, a ({b}, {hq}, "
                             f"{sq}) float32 tensor on {q.device}; got "
                             + ("None" if lse is None else
                                f"{tuple(lse.shape)} {lse.dtype} on {lse.device}"))
        lse = lse.contiguous()
    bufs = bwd_buffers(q, k, lse if pl.route != "fma" else None)
    for which in range(len(pl.grids)):
        launch_bwd_kernel(which, q, k, v, o, do, bufs, causal_offset, pl)
    launches["gqa_flash_bwd"] += 1
    return bufs[2:]


def bwd_buffers(q: torch.Tensor, k: torch.Tensor,
                lse: torch.Tensor | None = None) -> tuple[torch.Tensor, ...]:
    """The backward's scratch and outputs: LSE (``lse``, else new) and D_i
    (B, Hq, Sq) fp32, then dq, dk, dv contiguous, shaped and typed as q, k,
    k."""
    b, sq, hq, _ = q.shape
    if lse is None:
        lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    return lse, torch.empty((b, hq, sq), dtype=torch.float32, device=q.device), \
        torch.empty(q.shape, dtype=q.dtype, device=q.device), \
        torch.empty(k.shape, dtype=k.dtype, device=k.device), \
        torch.empty(k.shape, dtype=k.dtype, device=k.device)


def launch_bwd_kernel(which: int, q, k, v, o, do, bufs, causal_offset: int,
                      pl: BwdPlan) -> None:
    """One launch of the kernel ``which`` of ``pl``'s route
    (``BWD_ROUTE_KERNELS``) on CUDA inputs as ``launch_bwd`` lays them out
    (o contiguous; on "wgmma" q, k, v and do as the tensor maps read them,
    do in rows ``tma_width(D)`` wide; else q, k, v and do contiguous), into
    ``bufs`` (``bwd_buffers``), as ``pl`` plans it; adds one to that
    kernel's count."""
    build_bwd()
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = [t.data_ptr() for t in (q, k, v, o, do)]
    outs = [t.data_ptr() for t in bufs]
    name = BWD_ROUTE_KERNELS[pl.route][which]
    if pl.route in _TMA_ROUTES:
        maps = (ctypes.c_ulonglong * len(pl.maps))(*pl.maps)
        err = _bwd_lib.gqa_flash_bwd_wgmma(which, _DTYPES[q.dtype], *ptrs, *outs, b, sq, sk,
                                           hq, hkv, d, int(causal_offset), pl.groups[which],
                                           maps, *pl.grids[which], pl.smem[which], stream)
    else:
        entry = {"mma": _bwd_lib.gqa_flash_bwd_mma, "tiled": _bwd_lib.gqa_flash_bwd_tiled,
                 "fma": _bwd_lib.gqa_flash_bwd}[pl.route]
        err = entry(which, _DTYPES[q.dtype], *ptrs, *outs, b, sq, sk, hq, hkv, d,
                    int(causal_offset), *pl.grids[which], pl.smem[which], stream)
    if err != 0:
        raise RuntimeError(f"the {name} kernel of gqa_flash's backward failed: "
                           + (f"cudaError_t {err}" if err > 0
                              else f"CUresult {-err} encoding a tensor map"))
    launches[name] += 1
    key = bwd_instance(q.dtype, d, pl.route, which)
    instances[key] = instances.get(key, 0) + 1
