"""The variable-k capacity fill of the device slot loop: the hand-written
CUDA kernel and its plain PyTorch version.

Each slot the slot loop (``core/scan_engine.py``) fills every cell's
capacity with its candidate rows: the forced candidates in row order, then
the unforced candidates in row order; a row is taken iff its request still
fits (``used + kreq <= m_cap``), and a row that does not fit is skipped
while the walk goes on.  Where every request of a cell is one ``k`` the
engine computes that fill as a cumsum prefix; this module serves rows whose
requests differ (job lists whose ``k_min`` is not uniform, and
``carbonflex-scale``'s clean-slot scale-up).  It is the counterpart of the
JAX scan engine's sequential ``fill`` over a stable argsort key
(``src/repro/core/scan_engine.py:469-488``), which no Pallas kernel
computes.

``capacity_fill(cand, forced, kreq, m_cap, route=None)`` takes (B, n) bool
``cand`` and ``forced``, (B, n) int64 ``kreq`` (requests >= 0) and (B,)
int64 ``m_cap``, and returns the (B, n) bool ``take``.  On CPU tensors it
runs ``capacity_fill_plain``; on CUDA tensors it launches a kernel of
``csrc/fill.cu`` (one block per cell, ``plan``) or raises:

- ``"compact"`` (the default): ``capacity_fill_compact_kernel``.  All
  threads zero ``take``, keep each candidate's request in shared memory by
  row, and a scan of the chunk ballots lists the candidates in walk order;
  warp 0 then walks that list in dense groups of 32, in rounds of a warp
  prefix as below;
- ``"chunked"``: ``capacity_fill_kernel``, the first design (warp 0
  visits every 32-row chunk of both passes), kept as the yardstick of the
  same call.

Both stop a cell's walk once the capacity left is below the smallest
request among its candidates, which they reduce themselves.  Each launch
adds one to ``launches["capacity_fill"]`` and to its route's count.
Integer arithmetic only, so the kernels and the plain version agree
exactly.  No input is narrowed: requests keep their int64 values in shared
memory, and only row indices (16 bits) are, which ``plan`` bounds by ``n``.

The kernels are compiled at first use with ``nvcc`` for ``sm_90a`` into
``build/`` at the root of the checkout and loaded through ``ctypes``; a
failed build raises.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import build_library

# The kernels' constants (csrc/fill.cu): threads a block (chunked,
# compact), the rows of a chunk (one warp's ballot), the shared memory a
# block may use without opting in, and the most dynamic shared memory it
# takes (an H100's 227 KB a block less 1 KB for the static tables).
THREADS = 256
COMPACT_THREADS = 1024
CHUNK = 32
SMEM_LIMIT = 48 * 1024
SMEM_MAX = 231_424
ROUTES = ("compact", "chunked")
# The compact kernel's shared memory a row: its request (8 bytes) and its
# place in the walk list (a 16-bit row index: SMEM_MAX keeps n far below
# 65,536); and a chunk: two ballots and their two offsets (4 bytes each).
ROW_BYTES = 8 + 2
CHUNK_BYTES = 4 * 4

#: Kernel launches since the last ``reset_launches()``: in all and by route.
launches = {"capacity_fill": 0, "compact": 0, "chunked": 0}

_lib: ctypes.CDLL | None = None
_stream = None                  # device index -> the current stream's handle
_FLAGS = (torch.bool, torch.uint8)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def plan(rows: int, n: int, route: str = "compact") -> dict:
    """The launch of ``route`` for ``rows`` cells of ``n`` rows: one block of
    ``threads`` (THREADS chunked, COMPACT_THREADS compact) per cell;
    ``chunks`` chunks of CHUNK rows, warp ``w`` recording chunks ``w, w +
    threads / 32, ...``; warp 0 walks.  ``smem_bytes`` of
    dynamic shared memory: the chunked kernel's two ballot masks a chunk;
    the compact kernel's requests and walk list (ROW_BYTES a row) and the
    masks and their offsets (CHUNK_BYTES a chunk), with ``opt_in`` above
    SMEM_LIMIT."""
    if route not in ROUTES:
        raise ValueError(f"unknown fill route {route!r}; use one of {ROUTES}")
    if rows < 0 or n < 0:
        raise ValueError(f"no launch for {rows} cells of {n} rows")
    chunks = -(-n // CHUNK)
    if route == "chunked":
        smem = 2 * 4 * chunks
        if smem > SMEM_LIMIT:
            raise ValueError(f"{n} rows need {smem} bytes of chunk masks, more than "
                             f"{SMEM_LIMIT}")
    else:
        smem = ROW_BYTES * n + CHUNK_BYTES * chunks
        if smem > SMEM_MAX:
            raise ValueError(f"{n} rows need {smem} bytes of requests and walk list, more "
                             f"than the {SMEM_MAX} a block holds")
    if rows >= 2 ** 31:
        raise ValueError(f"{rows} cells exceed the grid")
    return dict(route=route, blocks=rows,
                threads=THREADS if route == "chunked" else COMPACT_THREADS, chunks=chunks,
                smem_bytes=smem, opt_in=smem > SMEM_LIMIT)


def capacity_fill_plain(cand: torch.Tensor, forced: torch.Tensor,
                        kreq: torch.Tensor, m_cap: torch.Tensor) -> torch.Tensor:
    """The fill in whole-row tensor ops, one pass for the forced candidates
    and one for the rest, each in rounds as the kernel's warp does them: the
    rows whose request exceeds the capacity left drop out, every row before
    the first one whose running sum overflows is taken at once, that row is
    skipped, and the round repeats on the rows after it."""
    b, n = cand.shape
    idx = torch.arange(n, device=cand.device)
    cand = cand != 0
    forced = forced != 0
    cap = m_cap.reshape(b, 1)
    used = torch.zeros((b, 1), dtype=torch.int64, device=cand.device)
    take = torch.zeros((b, n), dtype=torch.bool, device=cand.device)
    for live in (cand & forced, cand & ~forced):
        while True:
            live = live & (kreq <= cap - used)
            if not live.any():
                break
            pre = torch.cumsum(torch.where(live, kreq, 0), 1)
            over = live & (used + pre > cap)
            first = torch.where(over.any(1, keepdim=True),
                                over.to(torch.int8).argmax(1, keepdim=True), n)
            commit = live & (idx < first)
            take |= commit
            used = used + torch.where(commit, kreq, 0).sum(1, keepdim=True)
            live = live & (idx > first)
    return take


def build() -> str:
    """Compile ``csrc/fill.cu`` (once per source version) and load it.
    Returns the compiler's report when this call compiled."""
    global _lib, _stream
    if _lib is not None:
        return ""
    lib, log = build_library("fill")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.capacity_fill.argtypes = [i, p, p, p, p, ll, i, ctypes.c_size_t, p, p]
    lib.capacity_fill_floor.argtypes = [i, ll, ctypes.c_size_t, p]
    lib.capacity_fill_smem.argtypes = [i, i]
    lib.capacity_fill_smem.restype = ll
    for fn in (lib.capacity_fill, lib.capacity_fill_floor):
        fn.restype = ctypes.c_int
    _stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
        lambda dev: torch.cuda.current_stream(dev).cuda_stream)
    _lib = lib
    return log


def capacity_fill(cand: torch.Tensor, forced: torch.Tensor, kreq: torch.Tensor,
                  m_cap: torch.Tensor, route: str | None = None) -> torch.Tensor:
    """(B, n), (B, n), (B, n), (B,) -> (B, n) bool ``take`` (see the module
    docstring); on CUDA tensors one launch of ``route``'s kernel
    (``"compact"`` by default)."""
    route = route or "compact"
    if route not in ROUTES:
        raise ValueError(f"unknown fill route {route!r}; use one of {ROUTES}")
    args = (cand, forced, kreq, m_cap)
    if all(x.get_device() < 0 for x in args):
        return capacity_fill_plain(*args)
    dev = cand.get_device()
    if dev < 0 or any(x.get_device() != dev for x in args):
        raise ValueError("cand, forced, kreq and m_cap must lie on the same CUDA "
                         f"device, got {[str(x.device) for x in args]}")
    if cand.dtype not in _FLAGS or forced.dtype not in _FLAGS:
        raise TypeError(f"cand and forced must be bool or uint8, got {cand.dtype} "
                        f"/ {forced.dtype}")
    if kreq.dtype != torch.int64 or m_cap.dtype != torch.int64:
        raise TypeError(f"kreq and m_cap must be int64, got {kreq.dtype} / {m_cap.dtype}")
    if cand.dim() != 2 or forced.shape != cand.shape or kreq.shape != cand.shape \
            or m_cap.shape != cand.shape[:1]:
        raise ValueError(f"cand {tuple(cand.shape)}, forced {tuple(forced.shape)} and "
                         f"kreq {tuple(kreq.shape)} must be (B, n), m_cap "
                         f"{tuple(m_cap.shape)} (B,)")
    if not all(x.is_contiguous() for x in args):
        raise ValueError("cand, forced, kreq and m_cap must be contiguous")
    rows, n = cand.shape
    p = plan(rows, n, route)
    take = torch.empty((rows, n), dtype=torch.bool, device=cand.device)
    if take.numel() == 0:
        return take
    build()
    err = _lib.capacity_fill(ROUTES.index(route), cand.data_ptr(), forced.data_ptr(),
                             kreq.data_ptr(), m_cap.data_ptr(), rows, n, p["smem_bytes"],
                             take.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"capacity_fill ({route}) failed with cudaError_t {err}")
    launches["capacity_fill"] += 1
    launches[route] += 1
    return take
