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

``capacity_fill(cand, forced, kreq, m_cap)`` takes (B, n) bool ``cand``
and ``forced``, (B, n) int64 ``kreq`` (requests >= 0) and (B,) int64
``m_cap``, and returns the (B, n) bool ``take``.  The kernel stops a cell's
walk once the capacity left is below the smallest request among its
candidates, which it reduces itself.  On CPU tensors it runs
``capacity_fill_plain``; on CUDA tensors it launches the kernel of
``csrc/fill.cu`` (one block per cell, ``plan``) or raises.  Each launch adds
one to ``launches["capacity_fill"]``.  Integer arithmetic only, so the two
agree exactly.

The kernel is compiled at first use with ``nvcc`` for ``sm_90a`` into
``build/`` at the root of the checkout and loaded through ``ctypes``; a
failed build raises.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import build_library

# The kernel's constants (csrc/fill.cu): threads a block, the rows of a
# chunk (one warp's ballot), and the shared memory a block may use without
# opting in (two 4-byte masks per chunk).
THREADS = 256
CHUNK = 32
SMEM_LIMIT = 48 * 1024

#: Kernel launches since the last ``reset_launches()``.
launches = {"capacity_fill": 0}

_lib: ctypes.CDLL | None = None
_stream = None                  # device index -> the current stream's handle
_FLAGS = (torch.bool, torch.uint8)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def plan(rows: int, n: int) -> dict:
    """The launch for ``rows`` cells of ``n`` rows: one block of THREADS per
    cell; ``chunks`` chunks of CHUNK rows, whose two ballot masks (forced
    candidates, unforced candidates) take ``smem_bytes`` of shared memory.
    Thread ``t`` zeroes rows ``t, t + THREADS, ...`` of its cell, warp ``w``
    records chunks ``w, w + THREADS / 32, ...``, and warp 0 walks them."""
    if rows < 0 or n < 0:
        raise ValueError(f"no launch for {rows} cells of {n} rows")
    chunks = -(-n // CHUNK)
    smem = 2 * 4 * chunks
    if smem > SMEM_LIMIT:
        raise ValueError(f"{n} rows need {smem} bytes of chunk masks, more than "
                         f"{SMEM_LIMIT}")
    if rows >= 2 ** 31:
        raise ValueError(f"{rows} cells exceed the grid")
    return dict(blocks=rows, threads=THREADS, chunks=chunks, smem_bytes=smem)


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
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.capacity_fill.argtypes = [p, p, p, p, ll, ctypes.c_int, p, p]
    lib.capacity_fill_floor.argtypes = [ll, ctypes.c_int, p]
    for fn in (lib.capacity_fill, lib.capacity_fill_floor):
        fn.restype = ctypes.c_int
    _stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
        lambda dev: torch.cuda.current_stream(dev).cuda_stream)
    _lib = lib
    return log


def capacity_fill(cand: torch.Tensor, forced: torch.Tensor, kreq: torch.Tensor,
                  m_cap: torch.Tensor) -> torch.Tensor:
    """(B, n), (B, n), (B, n), (B,) -> (B, n) bool ``take`` (see the module
    docstring); on CUDA tensors one launch of the kernel."""
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
    plan(rows, n)
    take = torch.empty((rows, n), dtype=torch.bool, device=cand.device)
    if take.numel() == 0:
        return take
    build()
    err = _lib.capacity_fill(cand.data_ptr(), forced.data_ptr(), kreq.data_ptr(),
                             m_cap.data_ptr(), rows, n, take.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"capacity_fill failed with cudaError_t {err}")
    launches["capacity_fill"] += 1
    return take
