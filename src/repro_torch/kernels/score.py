"""The oracle's masked score matrix (Algorithm 1, lines 2–5): the
hand-written CUDA kernel and its plain PyTorch version, the counterpart of
``src/repro/kernels/score.py`` ``score_matrix``.

``score_matrix(marginals, ci, t_start, t_end)`` takes (J,) marginal
throughputs ``p_j(k)`` of (job, scale) entries, a (T,) carbon intensity and
(J,) window bounds, and returns the (J, T) matrix
``marginals[j] / max(ci[t], 1e-9)`` inside ``t_start[j] <= t < t_end[j]``
and 0 outside.  On CPU tensors it runs ``score_matrix_plain`` in the
tensors' dtype; on CUDA tensors it launches a kernel of ``csrc/score.cu``
(float32 values, int32 bounds) or raises.  ``plan`` picks the kernel by
shape: ``"rows"`` (T a multiple of 4, at most ROW_FLOATS, ``ci`` 16-byte
aligned) gives a block whole rows and stores four scores at a time;
``"columns"`` takes every other shape, four columns a thread.
``route="flat"`` launches the previous kernel (one thread per element), kept
as the yardstick of the same call.  Each launch adds one to
``launches["score_matrix"]`` and to its route's count.  One IEEE division per
element in every version, so each kernel equals the plain version exactly.

As in the JAX package, the oracle does not call it: ``oracle.solve``
scores its ragged entry list in float64 on the host, since a float32 score
would reorder the float64 lexsort of the entries.  The kernel is reached
through the port's kernel API, ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import build_library

# The kernels' constants (csrc/score.cu): the rows kernel's threads and
# longest row, the columns and flat kernels' threads.
ROW_THREADS = 128
ROW_FLOATS = 4096
COLUMN_THREADS = 256
FLAT_THREADS = 256
#: Blocks the rows route aims for at least: two per SM of an H100.
TARGET_BLOCKS = 2 * 132
ROUTES = ("rows", "columns", "flat")

#: Kernel launches since the last ``reset_launches()``: in all and by route.
launches = {"score_matrix": 0, "rows": 0, "columns": 0, "flat": 0}

_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def score_matrix_plain(marginals: torch.Tensor, ci: torch.Tensor,
                       t_start: torch.Tensor, t_end: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``score_matrix_ref``: window mask, quotient, where."""
    t = torch.arange(ci.shape[0], device=ci.device)
    mask = (t[None, :] >= t_start[:, None]) & (t[None, :] < t_end[:, None])
    return torch.where(mask, marginals[:, None] / torch.clamp_min(ci, 1e-9)[None, :],
                       0.0)


def build() -> str:
    """Compile ``csrc/score.cu`` (once per source version) and load it.
    Returns the compiler's report when this call compiled."""
    global _lib
    if _lib is not None:
        return ""
    lib, log = build_library("score")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.score_rows.argtypes = [p, p, p, p, i, i, i, i, p, p]
    lib.score_columns.argtypes = [p, p, p, p, i, i, i, p, p]
    lib.score_flat.argtypes = [p, p, p, p, i, i, ctypes.c_longlong, p, p]
    lib.score_floor.argtypes = [i, i, i, p]
    for fn in (lib.score_rows, lib.score_columns, lib.score_flat, lib.score_floor):
        fn.restype = i
    _lib = lib
    return log


def plan(j: int, t: int, route: str | None = None, aligned: bool = True) -> dict:
    """The launch for a (j, t) matrix (``aligned``: ``ci`` starts on a
    16-byte boundary).  Default route: ``"rows"`` where t is a multiple of
    4, at most ROW_FLOATS, and ``ci`` aligned, else ``"columns"``.
    ``"rows"``: ``bj`` rows a block (8, or the largest of 4, 2, 1 that still
    gives TARGET_BLOCKS blocks; 1 if none does), ``blocks`` blocks of
    ROW_THREADS.  ``"columns"``: a (j, ``tiles``) grid of COLUMN_THREADS,
    4 columns a thread.  ``"flat"``: ``blocks`` of FLAT_THREADS over the
    j t elements."""
    if j < 1 or t < 1:
        raise ValueError(f"no launch for an empty {j} x {t} matrix")
    rows_fit = t % 4 == 0 and t <= ROW_FLOATS and aligned
    route = route or ("rows" if rows_fit else "columns")
    if route == "rows":
        if not rows_fit:
            raise ValueError(f"the rows route takes T a multiple of 4 up to {ROW_FLOATS} "
                             f"and an aligned ci, got T={t}, aligned={aligned}")
        bj = next((b for b in (8, 4, 2) if -(-j // b) >= TARGET_BLOCKS), 1)
        return dict(route=route, bj=bj, blocks=-(-j // bj), threads=ROW_THREADS)
    if route == "columns":
        return dict(route=route, blocks=j, tiles=max(1, -(-(t // 4) // COLUMN_THREADS)),
                    threads=COLUMN_THREADS)
    if route == "flat":
        return dict(route=route, blocks=-(-j * t // FLAT_THREADS), threads=FLAT_THREADS)
    raise ValueError(f"unknown score route {route!r}; use one of {ROUTES}")


def score_matrix(marginals: torch.Tensor, ci: torch.Tensor,
                 t_start: torch.Tensor, t_end: torch.Tensor,
                 route: str | None = None) -> torch.Tensor:
    """(J,), (T,), (J,), (J,) -> (J, T) masked scores; on CUDA tensors
    through ``route`` (default: ``plan``'s)."""
    if route is not None and route not in ROUTES:
        raise ValueError(f"unknown score route {route!r}; use one of {ROUTES}")
    args = (marginals, ci, t_start, t_end)
    if all(x.device.type == "cpu" for x in args):
        return score_matrix_plain(*args)
    dev = marginals.device
    if dev.type != "cuda" or any(x.device != dev for x in args):
        raise ValueError("marginals, ci, t_start and t_end must lie on the same "
                         f"CUDA device, got {[str(x.device) for x in args]}")
    for name, x, dt in (("marginals", marginals, torch.float32),
                        ("ci", ci, torch.float32), ("t_start", t_start, torch.int32),
                        ("t_end", t_end, torch.int32)):
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{name} must be 1-D and contiguous, got shape "
                             f"{tuple(x.shape)}, strides {x.stride()}")
    j, t = marginals.shape[0], ci.shape[0]
    if t_start.shape[0] != j or t_end.shape[0] != j:
        raise ValueError(f"t_start {tuple(t_start.shape)} and t_end "
                         f"{tuple(t_end.shape)} must match marginals ({j},)")
    if max(j, t) >= 2 ** 31:
        raise ValueError(f"J={j} or T={t} exceeds int32")
    out = torch.empty((j, t), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    build()
    pl = plan(j, t, route, aligned=ci.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [x.data_ptr() for x in args]
    if pl["route"] == "rows":
        err = _lib.score_rows(*ptrs, j, t, pl["bj"], pl["blocks"], out.data_ptr(), stream)
    elif pl["route"] == "columns":
        err = _lib.score_columns(*ptrs, j, t, pl["tiles"], out.data_ptr(), stream)
    else:
        err = _lib.score_flat(*ptrs, j, t, pl["blocks"], out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"score_matrix ({pl['route']}) failed with cudaError_t {err}")
    launches["score_matrix"] += 1
    launches[pl["route"]] += 1
    return out
